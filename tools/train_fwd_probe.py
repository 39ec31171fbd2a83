#!/usr/bin/env python3
"""Time the teacher-forced forward kernel (``csrc/decoder_train_fwd.cu``) on
one CUDA card: by phase, against another checkout's kernel, bit for bit.

    python3 tools/train_fwd_probe.py [--compare LABEL=DIR ...] [--phases]
                                     [--variants FILE] [--out FILE]

``--compare LABEL=DIR`` names a directory that holds another checkout's
``tacotron2_torch`` (``git archive <commit> tacotron2_torch | tar -x -C
DIR``); it is loaded beside this tree's package under another name, and
the kernels are timed in turns (other, this, this, other) on the same
inputs with CUDA events over the launch.  Shapes, all at T_enc=128 on a
seeded full-width decoder with dropout 0.1 / 0.1 and a ragged mask, in
bf16 and fp32 weights: B=16, T_dec=512 (a train step), B=8, T_dec=512
(``train_step_accum``'s micro-batch) and B in {16, 5, 2} at T_dec=64
(``chip_smoke.py`` phase 8).  Each shape says whether the packages' nine
returns agree bit for bit.  Then, because the decoder kernels share
``csrc/decoder_common.cuh``: the decode kernel (#2) at its main shape
(bf16, B=4, T_enc=112, 400 frames) timed in the same turns with its five
returns held bit for bit, and the reverse chain's (#4) nine outputs at
bf16, B=16, T_enc=128, T_dec=64.

With the wrapper's weight re-layout (``train_weights``, where a package has
it) timed alone, in CUDA events and in launches.

``--phases`` builds, for each package, a copy of its forward kernel with a
``clock64`` counter read by block 0 after every grid barrier of the time
loop, one barrier after the last phase and one empty barrier a step
(``tools/bwd_chain_probe.py::instrument``), into
``tacotron2_torch/_build/probe/``.  A kernel of the design before the
redesign (heads of step t-1 and the attention LSTM in one phase) gets one
more barrier between the two, so that its split has six phases; a kernel
with ``// phase: NAME`` comments is split by them.  The split is each
interval's share of the counted cycles times the instrumented launch's own
time, per step.

``--variants FILE`` names a JSON object {label: [[old, new], ...]}: text
edits of this tree's forward kernel or its shared header, each variant
built apart, timed in the same turns and held bit for bit (and, with
``--phases``, split by phase too).

Prints the card's name and power limit first and one line per
measurement, and with ``--out FILE`` writes them all there as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from bwd_chain_probe import (BWD_OUT, ROOT, chain_inputs,
                             event_ms, instrument, load_package,
                             probe_library)
from decode_probe import (DEC_OUT, FWD_OUT, decode_inputs, phase_names,
                          variant_library, with_library)

MODULES = ("config", "models.tacotron2", "ops._build",
           "ops.decoder_megakernel", "ops.decoder_train_kernel",
           "ops.decoder_bwd_kernel", "ops.decoder_bptt")
SHAPES = ((16, 512), (8, 512), (16, 64), (5, 64), (2, 64))
T_ENC = 128
LOOP = r"for \(int t = 0; t < S; \+\+t\)"
SIX_PHASES = ("heads", "attention LSTM", "pq", "energies",
              "softmax/context", "decoder LSTM", "empty barrier")
HEADS = "    if (t > 0) heads(t - 1, h_dec_old);\n"
FWD = "decoder_fwd_train_mega"


def split_heads(src: str) -> str:
    """The design before the redesign (five barriers a step, the last at
    the loop body's end): one more barrier between the heads of step t-1
    and the attention LSTM, and the body's last barrier left to
    ``instrument``, which puts one after the last phase."""
    if HEADS not in src:
        return src
    tail = "    grid.sync();\n  }\n  heads(S - 1"
    if tail not in src:
        raise RuntimeError("the loop's last barrier not found")
    return (src.replace(HEADS, HEADS + "    grid.sync();\n")
            .replace(tail, "  }\n  heads(S - 1"))


def instrumented(src: str) -> str:
    return instrument(split_heads(src), LOOP, None)


def fwd_probe_library(pkg: dict, tag: str, edits=None):
    """The instrumented forward kernel of a package (with a variant's
    ``edits``, where given), and its phase names."""
    src = (pkg["ops._build"].CSRC / "decoder_train_fwd.cu").read_text()
    names = (list(SIX_PHASES) if HEADS in src
             else phase_names(src, LOOP))
    if edits is None:
        lib = probe_library(pkg, tag, "decoder_train_fwd", instrumented)
    else:
        lib = variant_library(pkg, f"{tag} instrumented", edits,
                              "decoder_train_fwd", instrumented)
    return lib, names


def fwd_inputs(pkg: dict, model, b: int, t_dec: int, dev, seed: int):
    """``decoder_fwd_train_mega``'s arguments: seeded prenetted frames and
    memory, a ragged mask, keep-masks at 0.9."""
    t2 = pkg["models.tacotron2"]
    cfg = model.cfg
    dec = model.decoder
    ops = pkg["ops.decoder_train_kernel"].kernel_operands(
        pkg["ops.decoder_bptt"].core_params(dec))
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    pre = torch.relu(r(t_dec, b, cfg.prenet_dim) * 0.5).to(dev)
    memory = (r(b, T_ENC, cfg.encoder_embedding_dim) * 0.5).to(dev)
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    lens = torch.tensor([T_ENC - 37 * (i % 3) for i in range(b)])
    mask = t2.make_pad_mask(lens, T_ENC).to(dev)
    keep = lambda: (torch.rand(t_dec, b, cfg.decoder_rnn_dim, generator=g)
                    < 0.9).to(dev)
    return (cfg, ops, pre, memory, pm, mask, keep(), keep())


def phase_split(mod, lib, names: list, args, steps: int) -> dict:
    """us per step by phase from the instrumented kernel."""
    run = with_library(mod, lib, FWD)
    n = len(names) + 1
    counts = (ctypes.c_ulonglong * n)()
    lib.t2_probe_read.argtypes = [ctypes.c_void_p]
    run(*args)
    torch.cuda.synchronize()
    lib.t2_probe_read(counts)
    ms = event_ms(lambda: run(*args), n=1)
    lib.t2_probe_read(counts)
    total = counts[n - 1]
    split = {p: counts[i] / total * ms * 1e3 / steps
             for i, p in enumerate(names)}
    return dict(ms=ms, us_per_step=ms * 1e3 / steps, split_us=split)


def relayout_cost(mod, ops) -> dict:
    """The wrapper's weight re-layout alone: ms by CUDA events, device ms
    and launches by the profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn = lambda: mod.train_weights(ops)
    ms = event_ms(fn, n=10)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return dict(ms=ms, device_ms=sum(e.self_device_time_total for e in ev)
                / 1e3, launches=sum(e.count for e in ev))


def report_bits(record, kind, tag, names, outs) -> None:
    for k in outs:
        if k == "this":
            continue
        same = [n for n, x, y in zip(names, outs["this"], outs[k])
                if torch.equal(x, y)]
        record["bit_for_bit"].append(dict(kernel=kind, shape=tag,
                                          package=k, equal_outputs=same))
        print(f"[{kind} {tag}] this and {k}: {len(same)} of {len(names)} "
              "outputs bit for bit"
              + ("" if len(same) == len(names) else
                 f" (differ: {sorted(set(names) - set(same))})"),
              flush=True)


def print_ptxas(label: str, log: str) -> None:
    """The registers and spills that ``-Xptxas -v`` reported in a build."""
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[ptxas {label}] {line.strip()}", flush=True)


def timed_turns(record, kind, tag, runs, args, steps) -> None:
    others = [k for k in runs if k != "this"]
    for k in others + ["this", "this"] + others[::-1]:
        with torch.no_grad():
            ms = event_ms(lambda: runs[k](*args))
        row = dict(kernel=kind, shape=tag, package=k, ms=ms,
                   us_per_step=ms * 1e3 / steps)
        record["times"].append(row)
        print(f"[{kind} {tag}] {k}: {ms:.3f} ms = {row['us_per_step']:.2f} "
              "us/step", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--variants", type=Path)
    ap.add_argument("--out", type=Path)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_fwd_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    pkgs = {"this": load_package(ROOT / "tacotron2_torch", "t2_this",
                                 MODULES)}
    for spec in opts.compare:
        label, path = spec.split("=", 1)
        pkgs[label] = load_package(Path(path) / "tacotron2_torch",
                                   f"t2_{label}", MODULES)
    for k, pkg in pkgs.items():
        print_ptxas(k, pkg["ops._build"].build().get("decoder_train_fwd", ""))
    this = pkgs["this"]
    fwd = {k: p["ops.decoder_train_kernel"] for k, p in pkgs.items()}
    runs = {k: getattr(m, FWD) for k, m in fwd.items()}
    variants = (json.loads(opts.variants.read_text()) if opts.variants
                else {})
    for label, edits in variants.items():
        runs[label] = with_library(fwd["this"], variant_library(
            this, label, edits, "decoder_train_fwd"), FWD)
        print_ptxas(label, (ROOT / "tacotron2_torch" / "_build" / "probe"
                            / f"variant_{label}" / "nvcc.log").read_text())
    libs = {}
    if opts.phases:
        libs = {k: (fwd[k], *fwd_probe_library(p, k))
                for k, p in pkgs.items()}
        libs.update({label: (fwd["this"], *fwd_probe_library(
            this, label, edits)) for label, edits in variants.items()})
    record = dict(card=card, times=[], bit_for_bit=[], phases=[],
                  relayout=[])
    t2 = this["models.tacotron2"]
    base = t2.init_weights(t2.Tacotron2(this["config"].ModelConfig()), seed=0)
    for dtype in (torch.bfloat16, torch.float32):
        model = (t2.cast_params_bf16(base) if dtype == torch.bfloat16
                 else base).to(dev)
        for b, t_dec in SHAPES:
            args = fwd_inputs(this, model, b, t_dec, dev, seed=100 + b)
            tag = f"{str(dtype)[6:]} B={b} T_enc={T_ENC} T_dec={t_dec}"
            with torch.no_grad():
                outs = {k: run(*args) for k, run in runs.items()}
            timed_turns(record, FWD, tag, runs, args, t_dec)
            report_bits(record, FWD, tag, FWD_OUT, outs)
            del outs
            for k, (mod, lib, names) in libs.items():
                row = phase_split(mod, lib, names, args, t_dec)
                row.update(shape=tag, package=k)
                record["phases"].append(row)
                print(f"[phases {tag}] {k} instrumented: "
                      f"{row['us_per_step']:.2f} us/step; us/step "
                      + ", ".join(f"{p} {v:.2f}"
                                  for p, v in row["split_us"].items()),
                      flush=True)
            if t_dec == 512:
                for k, m in fwd.items():
                    if hasattr(m, "train_weights"):
                        row = relayout_cost(m, args[1])
                        row.update(shape=tag, package=k)
                        record["relayout"].append(row)
                        print(f"[relayout {tag}] {k}: {row['ms']:.4f} ms, "
                              f"{row['device_ms']:.4f} ms device in "
                              f"{row['launches']} launches", flush=True)
            del args
            torch.cuda.empty_cache()
        if dtype == torch.bfloat16:
            # the decode kernel at its main shape
            args = decode_inputs(this, model, 4, 112, 400, dev, seed=512)
            tag = "bf16 B=4 T_enc=112 400 frames"
            dec_runs = {k: p["ops.decoder_megakernel"].decoder_infer_mega
                        for k, p in pkgs.items()}
            with torch.no_grad():
                outs = {k: run(*args) for k, run in dec_runs.items()}
            timed_turns(record, "decoder_infer_mega", tag, dec_runs, args,
                        int(outs["this"][3]) + 1)
            report_bits(record, "decoder_infer_mega", tag, DEC_OUT, outs)
            del outs, args
        del model
    # the reverse chain on this tree's forward series
    args = chain_inputs(this, 16, 64, torch.bfloat16, dev, seed=116)
    outs = {k: p["ops.decoder_bwd_kernel"].decoder_bwd_chain_mega(*args)
            for k, p in pkgs.items()}
    report_bits(record, "decoder_bwd_chain_mega",
                "bf16 B=16 T_enc=128 T_dec=64", BWD_OUT, outs)
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
