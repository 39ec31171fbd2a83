#!/usr/bin/env python3
"""Device-time profile of one training step of the PyTorch port: the
step's busy time and a breakdown by kernel class and by kernel.

The counterpart of ``tools/profile_train_step.py``, with its flags
``--batch`` (default 128), ``--t_enc``, ``--t_dec``, ``--split`` and
``--top``, plus ``--device``.  One staged ``train_step`` (``Config()``:
bf16 compute over fp32 masters, seeded weights, the batch of
``tools/bench_train_scaling_torch.py`` on the device before the step) runs
under ``torch.profiler`` after one step outside it.  From the profiler's
kernel events it prints the device's busy time (the union of the kernels'
intervals), their span and the sum of kernel time, a table by class
(:func:`op_class`: each of the five hand-written kernels a class of its
own; GEMM, cuDNN convolution, elementwise and reduction, copy and memset,
other) and the top single kernels.  The profiler leaves some short launches
out of its trace, so it also prints, for each hand-written kernel, the
launches it saw against the wrapper's own launch counter.  There is no HLO,
so ``--hlo`` has no counterpart; ``--trace PATH`` writes the profiler's
Chrome trace instead.

    python tools/profile_train_step_torch.py [--batch 128] [--split 1|0] \\
        [--top 25] [--trace step.json]

With ``--device cpu`` the table is of the host ops' self time: there is no
device time to read.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np

_TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_TOOLS))   # runnable from any cwd
sys.path.append(_TOOLS)                       # bench_train_scaling_torch

import torch  # noqa: E402

# the five hand-written kernels: class (the wrapper's name), the prefix of
# the CUDA symbol(s) it launches, the module that holds the wrapper
KERNELS = (
    ("attention_tail", "attention_tail_", "attention_kernel"),
    ("decoder_infer_mega", "decoder_infer_kernel", "decoder_megakernel"),
    ("decoder_fwd_train_mega", "decoder_train_fwd_kernel",
     "decoder_train_kernel"),
    ("decoder_bwd_chain_mega", "decoder_train_bwd_kernel",
     "decoder_bwd_kernel"),
    ("conv_bn_act", "conv_bn_act_", "convbn_kernel"),
)
_COPY = ("memcpy", "memset", "copy_kernel", "aten::copy_", "aten::fill_",
         "aten::zero_", "aten::to", "aten::_to_copy")
_CONV = ("cudnn", "fprop", "dgrad", "wgrad", "conv", "winograd")
_GEMM = ("gemm", "gemv", "xmma", "nvjet", "cutlass", "cublas", "splitkreduce",
         "aten::mm", "aten::addmm", "aten::bmm", "aten::matmul",
         "aten::linear")
_ELEMENTWISE = ("elementwise", "reduce", "softmax", "norm", "index",
                "catarray", "scatter", "gather", "where", "sum", "mean",
                "aten::")


def op_class(name: str) -> str:
    """The class of a CUDA kernel (or, on the CPU, a host op) by its name:
    each hand-written kernel of ``KERNELS`` its own, then ``copy/memset``,
    ``cudnn_conv``, ``gemm``, ``elementwise/reduction``, ``other``."""
    for cls, symbol, _ in KERNELS:
        if symbol in name:
            return cls
    n = name.lower()
    for cls, marks in (("copy/memset", _COPY), ("cudnn_conv", _CONV),
                       ("gemm", _GEMM), ("elementwise/reduction",
                                         _ELEMENTWISE)):
        if any(m in n for m in marks):
            return cls
    return "other"


def launch_counters() -> Dict[str, int]:
    import importlib
    return {cls: getattr(importlib.import_module(
        f"tacotron2_torch.ops.{mod}"), cls).launches
        for cls, _, mod in KERNELS}


def device_events(prof):
    """(name, start us, end us) of every kernel, copy and memset the
    profiler traced on the device, from its raw events (its event tree
    takes about a millisecond an event to build)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns() / 1e3,
             (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def busy_us(events) -> float:
    """The union of the events' intervals."""
    total, end = 0.0, -np.inf
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_train_step(batch: int, device: torch.device, t_enc: int = 128,
                       t_dec: int = 512, split: bool = True, cfg=None,
                       trace: Optional[str] = None) -> Dict:
    """One staged ``train_step`` under ``torch.profiler`` after one outside
    it.  Returns the report: milliseconds by class and by kernel, the busy
    time, span and kernel sum (device runs), the wall time, and per
    hand-written kernel the launches its counter gave and the profiler
    saw."""
    import time

    from tacotron2_torch.config import Config
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state
    from tacotron2_torch.train.step import train_step
    from torch.profiler import ProfilerActivity, profile

    from bench_train_scaling_torch import make_batch, split_config, stage

    on_card = device.type == "cuda"
    cfg = split_config(cfg or Config(), split)
    tx = make_optimizer(cfg.train)
    state = create_train_state(cfg, seed=0, tx=tx, device=device)
    rng = np.random.default_rng(0)
    sigma = cfg.guided_attention.sigma_warmup_steps
    n_mels = cfg.model.n_mels

    def step(tb):
        return train_step(state, tb, cfg=cfg, tx=tx, use_postnet=True,
                          sigma_warmup_steps=sigma)[1]

    float(step(make_batch(rng, batch, t_enc, t_dec, n_mels)).total)  # warm
    tb = stage(make_batch(rng, batch, t_enc, t_dec, n_mels), device)
    before = launch_counters()
    activity = ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        loss = float(step(tb).total)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v - before[k] for k, v in launch_counters().items()}
    if trace:
        prof.export_chrome_trace(trace)

    per_class, per_op = collections.Counter(), collections.Counter()
    report = dict(batch=batch, t_enc=t_enc, t_dec=t_dec, split=split,
                  loss=loss, wall_ms=wall_ms, launches=launches,
                  device=(torch.cuda.get_device_name(device) if on_card
                          else "cpu"))
    if on_card:
        events = device_events(prof)
        if not events:
            raise RuntimeError("torch.profiler traced no device events")
        seen = collections.Counter()
        for name, s, e in events:
            cls = op_class(name)
            per_class[cls] += (e - s) / 1e3
            per_op[name] += (e - s) / 1e3
            seen[cls] += 1
        report.update(
            busy_ms=busy_us(events) / 1e3,
            span_ms=(max(e for _, _, e in events)
                     - min(s for _, s, _ in events)) / 1e3,
            kernel_sum_ms=sum(per_class.values()),
            seen={cls: seen[cls] for cls, _, _ in KERNELS})
    else:
        for e in prof.key_averages():
            per_class[op_class(e.key)] += e.self_cpu_time_total / 1e3
            per_op[e.key] += e.self_cpu_time_total / 1e3
        report.update(host_self_sum_ms=sum(per_class.values()))
    report.update(per_class=dict(per_class), per_op=dict(per_op))
    return report


def print_report(r: Dict, top: int,
                 log: Callable[[str], None] = print) -> None:
    head = (f"train_step B={r['batch']} T_enc={r['t_enc']} T_dec={r['t_dec']}"
            f" split={r['split']} on {r['device']}: wall {r['wall_ms']:.1f} "
            f"ms, loss {r['loss']:.4f}")
    if "busy_ms" in r:
        log(f"\n{head}, device busy {r['busy_ms']:.1f} ms (span "
            f"{r['span_ms']:.1f} ms, idle share "
            f"{1 - r['busy_ms'] / r['wall_ms']:.3f}), kernel-time sum "
            f"{r['kernel_sum_ms']:.1f} ms")
        total = r["kernel_sum_ms"]
    else:
        log(f"\n{head}; host ops' self time {r['host_self_sum_ms']:.1f} ms "
            f"(a CPU run: no device time)")
        total = r["host_self_sum_ms"]
    log(f"{'class':30s} {'ms':>9s} {'%':>6s}")
    for cls, ms in sorted(r["per_class"].items(), key=lambda kv: -kv[1]):
        log(f"{cls:30s} {ms:9.2f} {100 * ms / total:6.1f}")
    log("\ntop individual kernels:" if "busy_ms" in r
        else "\ntop individual ops:")
    for op, ms in sorted(r["per_op"].items(), key=lambda kv: -kv[1])[:top]:
        log(f"  {ms:8.2f} ms  {op[:100]}")
    log("\nhand-written kernels, launches by the wrapper's counter / seen "
        "by the profiler:")
    for cls, _, _ in KERNELS:
        seen = r.get("seen", {}).get(cls)
        log(f"  {cls:26s} {r['launches'][cls]:6d} / "
            + ("not traced (CPU run)" if seen is None else
               f"{seen} ({r['launches'][cls] - seen} dropped)"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--t_enc", type=int, default=128)
    ap.add_argument("--t_dec", type=int, default=512)
    ap.add_argument("--split", type=int, default=1,
                    help="1 = split-BPTT decoder backward (the kernel pair), "
                         "0 = autograd through the step loop")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--trace", default=None,
                    help="also write the profiler's Chrome trace here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tacotron2_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    report = profile_train_step(args.batch, device, args.t_enc, args.t_dec,
                                bool(args.split), trace=args.trace)
    print_report(report, args.top)
    if args.trace:
        print(f"Chrome trace -> {args.trace}")
    return report


if __name__ == "__main__":
    main()
