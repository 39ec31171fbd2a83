#!/usr/bin/env python3
"""Time the attention tail (``ops/attention_kernel.py::attention_tail``) on
one CUDA card: device time, call time and where a call's host time goes,
against another checkout's tail.

    python3 tools/attention_tail_probe.py [--compare LABEL=DIR ...]
                                          [--variants FILE] [--min-rows N,...]
                                          [--phases] [--out FILE]

``--compare LABEL=DIR`` names a directory that holds another checkout's
``tacotron2_torch`` (``git archive <commit> tacotron2_torch | tar -x -C
DIR``); it is loaded beside this tree's package under another name (with
``tools/bwd_chain_probe.py::load_package``), and the tails are timed in
turns (other, this, this, other) on the same inputs.

Shapes (A=128, D=512, ``memory`` fp32 as the decoder hands it over, a
ragged mask as ``chip_smoke.py``'s ``tail_inputs`` makes it): bf16 B=1
T_enc=32 (one sentence on the step loop), bf16 B=4 T_enc=112 (the smoke's
``kernels`` line), fp32 B=16 T_enc=128 (``eval_step``), bf16 B=64
T_enc=200 (the largest of the smoke's phase-4 sweep) and fp32 B=4
T_enc=600 (a long input).

For each shape and package:

- ``graph_us``: device time a call, from a CUDA graph of 20 calls
  (``chip_smoke.py``'s ``graph_ms``: no host time, the graph's gaps
  between launches included);
- ``profiler_us``: the kernel's own time in ``torch.profiler`` (which may
  leave short launches out of its trace);
- ``call_us``: CUDA events over 200 calls through the wrapper;
- ``host_us``: the host's time a call (host clock, no synchronisation
  inside the window), split into the wrapper (under ``torch.no_grad``, as
  serving calls it), ``_forward`` without the autograd function, and
  ``_forward``'s parts: the Triton tail's allocations, its
  ``.contiguous()`` and view calls, its launch; or the CUDA tail's plan
  lookup, allocation and ``ctypes`` launch; "checks" is what ``_forward``
  takes beyond those parts.  ``call, autograd`` is the wrapper with a
  ``qsum`` that requires a gradient (the training step loop).  Beside
  them, the choices the CUDA tail's host path made: the stream as
  ``torch.cuda.current_stream(dev).cuda_stream`` against PyTorch's raw
  handle, and one buffer cut into two views against two allocations;
- the largest error against ``attention_tail_reference`` and whether the
  packages agree bit for bit.

The bound is the smoke's: the bytes read and written once over 3.35 TB/s
against the operations at 67 TFLOP/s (fp32).

``--variants FILE`` names a JSON object {label: [[old, new], ...]}: text
edits of this tree's ``csrc/attention_tail.cu``, each variant built apart
under ``tacotron2_torch/_build/probe/`` and timed in the same turns (device
and call time, error).  ``--min-rows N,...`` times this tree's kernel in
the same turns with plans made at other ``MIN_ROWS`` (rows a block takes
before an item is split further), as "min_rows=N".

``--phases`` builds a copy of this tree's kernel in which thread 0 of
block (0, 0) reads ``clock64`` at each ``// phase: NAME`` comment of the
source (the last tile's reading where a phase repeats), under
``tacotron2_torch/_build/probe/``, and prints the cycles from one comment
to the next, the mean over 50 launches, beside their time at the card's
largest SM clock (``nvidia-smi clocks.max.sm``).

Prints the card's name and power limit first and one line per
measurement, and with ``--out FILE`` writes them all there as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from bwd_chain_probe import ROOT, load_package
from decode_probe import variant_library, with_library

MODULES = ("ops.attention_kernel", "ops._build")
A, D = 128, 512
SHAPES = ((torch.bfloat16, 1, 32), (torch.bfloat16, 4, 112),
          (torch.float32, 16, 128), (torch.bfloat16, 64, 200),
          (torch.float32, 4, 600))
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def tail_inputs(b: int, t: int, dtype, dev, seed: int):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(t // 2, t + 1, (b,), generator=g)
    lens[0] = t
    mask = torch.arange(t)[None, :] >= lens[:, None]
    return (torch.randn(b, t, A, generator=g).to(dev, dtype),
            (torch.randn(A, generator=g) * 0.3).to(dev),
            torch.tensor(0.1, device=dev), torch.tensor(1.2, device=dev),
            mask.to(dev), torch.randn(b, t, D, generator=g).to(dev))


def bound_us(ins) -> tuple:
    q, _, _, _, _, mem = ins
    b, t, a = q.shape
    d = mem.shape[-1]
    n_bytes = (q.numel() * q.element_size() + mem.numel() * 4
               + b * t * (1 + 4) + a * 4 + b * d * 4)
    n_ops = b * t * (3 * a + 5 + 2 * d)
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (max(by_bytes, by_ops) * 1e6,
            "bytes" if by_bytes >= by_ops else "operations")


def graph_us(fn, n: int = 20, replays: int = 5) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / replays / n


def call_us(fn, n: int = 200) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def profiler_us(fn, n: int = 50):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [(e.count, e.self_device_time_total) for e in prof.key_averages()
            if "attention_tail" in e.key and e.self_device_time_total > 0]
    count = sum(c for c, _ in hits)
    return None if count == 0 else sum(us for _, us in hits) / count


def host_us(fn, n: int = 400) -> float:
    """The host's microseconds a call: no synchronisation in the window
    (fewer calls than the launch queue holds)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def host_split(ak, ins) -> dict:
    q, vw, vb, sc, mask, mem = ins
    b, t, a = q.shape
    d = mem.shape[-1]
    dev = q.device
    parts = {}
    with torch.no_grad():
        parts["call"] = host_us(lambda: ak.attention_tail(*ins))
        parts["_forward"] = host_us(lambda: ak._forward(*ins))
        if hasattr(ak, "tail_plan"):          # the CUDA kernel
            plan = ak.tail_plan(b, t, a, d, mem.dtype)
            parts["plan"] = host_us(
                lambda: ak.tail_plan(b, t, a, d, mem.dtype))
            parts["alloc"] = host_us(lambda: ak._outputs(b, t, d, dev))
            parts["alloc + launch"] = host_us(lambda: ak._launch(*ins, plan))
            inner = parts["plan"] + parts["alloc + launch"]
            parts["stream object"] = host_us(
                lambda: torch.cuda.current_stream(dev).cuda_stream)
            parts["stream handle"] = host_us(
                lambda: torch._C._cuda_getCurrentRawStream(dev.index))
            parts["one buffer, two views"] = host_us(lambda: (
                lambda buf: (buf.as_strided((b, t), (t, 1)),
                             buf.as_strided((b, d), (d, 1), b * t)))(
                    torch.empty(b * (t + d), device=dev)))
        else:                                 # the Triton kernel
            tl = importlib.import_module(
                ak.__name__.rsplit(".", 2)[0] + ".csrc.attention_tail")
            prep = lambda: (q.contiguous(), vw.contiguous(), vb.reshape(1),
                            sc.reshape(1),
                            mask.contiguous().view(torch.uint8),
                            mem.contiguous())
            alloc = lambda: (torch.empty(b, t, device=dev),
                             torch.empty(b, d, device=dev))
            args, outs = prep(), alloc()
            rb = q.dtype == torch.bfloat16 and mem.dtype != torch.bfloat16
            parts["alloc"] = host_us(alloc)
            parts["contiguous + views"] = host_us(prep)
            parts["launch"] = host_us(
                lambda: tl.launch(*args, *outs, round_bf16=rb))
            inner = (parts["alloc"] + parts["contiguous + views"]
                     + parts["launch"])
    parts["checks"] = parts["_forward"] - inner
    parts["Function.apply and the rest"] = parts["call"] - parts["_forward"]
    q_grad = q.detach().requires_grad_(True)
    parts["call, autograd"] = host_us(
        lambda: ak.attention_tail(q_grad, *ins[1:]))
    return parts


def with_min_rows(ak, n: int):
    """This tree's tail with plans made at ``MIN_ROWS = n``."""
    def run(*args):
        old = ak.MIN_ROWS
        ak.MIN_ROWS = n
        ak.tail_plan.cache_clear()
        try:
            return ak.attention_tail(*args)
        finally:
            ak.MIN_ROWS = old
            ak.tail_plan.cache_clear()
    return run


def stamped(src: str) -> str:
    """The kernel source with a clock64 reading at each phase comment."""
    names = re.findall(r"^\s*// phase: (.+)$", src, flags=re.M)
    count = iter(range(len(names)))
    src = re.sub(r"^(\s*)// phase: (.+)$",
                 lambda m: f"{m.group(1)}T2_STAMP({next(count)});", src,
                 flags=re.M)
    head = (f"__device__ long long g_stamp[{len(names)}];\n"
            "#define T2_STAMP(i) if (blockIdx.x == 0 && blockIdx.y == 0 "
            "&& threadIdx.x == 0) g_stamp[i] = clock64()\n")
    tail = (f"\nextern \"C\" int t2_probe_read(long long* host) {{\n"
            f"  return (int)cudaMemcpyFromSymbol(host, g_stamp, "
            f"{len(names)} * sizeof(long long));\n}}\n")
    return src.replace("namespace cg = cooperative_groups;",
                       head + "namespace cg = cooperative_groups;", 1) + tail


def phase_split(ak, lib, ins, n: int = 50) -> dict:
    """Mean cycles between consecutive phase comments over ``n``
    launches."""
    names = re.findall(r"^\s*// phase: (.+)$", (
        ROOT / "tacotron2_torch" / "csrc" / "attention_tail.cu").read_text(),
        flags=re.M)
    lib.t2_probe_read.argtypes = [ctypes.c_void_p]
    run = with_library(ak, lib, "attention_tail")
    host = (ctypes.c_longlong * len(names))()
    sums = [0.0] * (len(names) - 1)
    with torch.no_grad():
        run(*ins)
        for _ in range(n):
            run(*ins)
            torch.cuda.synchronize()
            if lib.t2_probe_read(ctypes.addressof(host)) != 0:
                raise RuntimeError("reading the phase stamps failed")
            for i in range(len(sums)):
                sums[i] += host[i + 1] - host[i]
    return {f"{names[i]} -> {names[i + 1]}": v / n
            for i, v in enumerate(sums)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--variants", type=Path)
    ap.add_argument("--min-rows", default="")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--out", type=Path)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_tail_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pkgs = {"this": load_package(ROOT / "tacotron2_torch", "t2_this",
                                 MODULES)}
    for spec in opts.compare:
        label, path = spec.split("=", 1)
        pkgs[label] = load_package(Path(path) / "tacotron2_torch",
                                   f"t2_{label}", MODULES)
    tails = {k: p["ops.attention_kernel"] for k, p in pkgs.items()}
    for k, p in pkgs.items():
        if "attention_tail" in getattr(p["ops._build"], "CUDA_SOURCES", ()):
            log = p["ops._build"].build(["attention_tail"]).get(
                "attention_tail", "")
            for ln in log.splitlines():
                if "registers" in ln or "smem" in ln:
                    print(f"[build {k}] {ln.strip()}", flush=True)
    runs = {k: m.attention_tail for k, m in tails.items()}
    variants = (json.loads(opts.variants.read_text()) if opts.variants
                else {})
    for label, edits in variants.items():
        runs[label] = with_library(tails["this"], variant_library(
            pkgs["this"], label, edits, "attention_tail"), "attention_tail")
    for n in filter(None, opts.min_rows.split(",")):
        runs[f"min_rows={n}"] = with_min_rows(tails["this"], int(n))
    phase_lib = None
    if opts.phases:
        phase_lib = variant_library(pkgs["this"], "phases", [],
                                    "attention_tail", transform=stamped)
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True).stdout.split()[0])
    for label in list(variants) + (["phases"] if opts.phases else []):
        log = (ROOT / "tacotron2_torch" / "_build" / "probe"
               / f"variant_{label}" / "nvcc.log").read_text()
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        print(f"[build {label}] registers a thread: {', '.join(regs)}",
              flush=True)
    others = [k for k in runs if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    ref_fn = tails["this"].attention_tail_reference
    record = dict(card=card, shapes=[])
    for dtype, b, t in SHAPES:
        ins = tail_inputs(b, t, dtype, dev, seed=b * 1000 + t)
        tag = f"{str(dtype)[6:]} B={b} T_enc={t}"
        bound, bound_by = bound_us(ins)
        row = dict(shape=tag, bound_us=bound, bound_by=bound_by, turns=[],
                   profiler_us={}, host_us={}, max_abs_err={})
        if hasattr(tails["this"], "tail_plan"):
            row["plan"] = tails["this"].tail_plan(
                b, t, A, D, ins[5].dtype)._asdict()
        print(f"[{tag}] bound {bound:.3f} us ({bound_by})"
              + (f"; plan {row['plan']}" if "plan" in row else ""),
              flush=True)
        with torch.no_grad():
            ref = ref_fn(*ins)
            outs = {k: run(*ins) for k, run in runs.items()}
        torch.cuda.synchronize()
        for k, out in outs.items():
            row["max_abs_err"][k] = max(
                float((x - y).abs().max()) for x, y in zip(out, ref))
        row["bit_for_bit"] = {
            k: all(torch.equal(x, y) for x, y in zip(outs[k], outs["this"]))
            for k in outs if k != "this"}
        print(f"[{tag}] max err vs plain: " + ", ".join(
            f"{k} {v:.3e}" for k, v in row["max_abs_err"].items())
            + "; bit for bit with this: " + ", ".join(
            f"{k} {v}" for k, v in row["bit_for_bit"].items()), flush=True)
        for k in order:
            with torch.no_grad():
                fn = lambda: runs[k](*ins)
                turn = dict(package=k, graph_us=graph_us(fn),
                            call_us=call_us(fn))
            row["turns"].append(turn)
            print(f"[{tag}] {k}: device {turn['graph_us']:.2f} us (graph), "
                  f"call {turn['call_us']:.2f} us (events)", flush=True)
        for k, ak in tails.items():
            with torch.no_grad():
                row["profiler_us"][k] = profiler_us(
                    lambda: ak.attention_tail(*ins))
            row["host_us"][k] = host_split(ak, ins)
            prof = row["profiler_us"][k]
            print(f"[{tag}] {k}: profiler "
                  + ("saw no launch" if prof is None else f"{prof:.2f} us")
                  + "; host us: " + ", ".join(
                      f"{p} {v:.2f}" for p, v in row["host_us"][k].items()),
                  flush=True)
        if phase_lib is not None:
            row["phase_cycles"] = phase_split(tails["this"], phase_lib, ins)
            print(f"[{tag}] phases of block (0, 0), cycles (us at "
                  f"{mhz:.0f} MHz): " + "; ".join(
                      f"{k} {v:.0f} ({v / mhz:.3f})"
                      for k, v in row["phase_cycles"].items()), flush=True)
        record["shapes"].append(row)
        del ins, outs, ref
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(record, indent=1))
        print(f"wrote {opts.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
