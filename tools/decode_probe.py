#!/usr/bin/env python3
"""Time the decode kernel (``csrc/decoder_infer.cu``) on one CUDA card: by
phase, and against another checkout's kernel.

    python3 tools/decode_probe.py [--compare LABEL=DIR ...] [--phases]
                                  [--variants FILE] [--steps N] [--out FILE]

``--compare LABEL=DIR`` names a directory that holds another checkout's
``tacotron2_torch`` (``git archive <commit> tacotron2_torch | tar -x -C
DIR``); it is loaded beside this tree's package under another name, and
the kernels are timed in turns (other, this, this, other) on the same
inputs with CUDA events over the launch.  Shapes: B=1 T_enc=32 (one
sentence), B=4 T_enc=112 (the batched tokens -> mels request), B=8 and
B=1 at T_enc=128 (``chip_smoke.py`` phase 5), bf16 and fp32 weights,
seeded full-width decoder, ragged mask, ``--steps`` frames (400; seeded
weights fire no gate), first frame dropped.  Each shape says whether the
packages' five returns agree bit for bit; then, because the kernels share
``csrc/decoder_common.cuh``, the teacher-forced forward's nine outputs and
the reverse chain's nine at one shape each (bf16, B=16, T_enc=128,
T_dec=64, dropout 0.1).

``--variants FILE`` names a JSON object {label: [[old, new], ...]}: text
edits of this tree's ``csrc/decoder_infer.cu`` or the shared header
``csrc/decoder_common.cuh``, each variant built under
``tacotron2_torch/_build/probe/`` and timed (and held bit for bit) beside
the packages, launched through this tree's wrapper.
``tools/decode_variants.json`` holds the design's alternatives.

``--phases`` builds, for each package, a copy of its decode kernel with a
``clock64`` counter read by block 0 after every grid barrier of the time
loop, one barrier after the last phase and one empty barrier (its cost) a
step (``tools/bwd_chain_probe.py::instrument``), into
``tacotron2_torch/_build/probe/``.  Phases are named by the kernel's
``// phase: NAME`` comments, or, for a kernel without them (the design
before them), by its eight barriers.  The split is each interval's share
of the counted cycles times the instrumented launch's own time, per step;
every interval holds one barrier.

Prints the card's name and power limit first and one line per
measurement, and with ``--out FILE`` writes them all there as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from bwd_chain_probe import (BWD_OUT, ROOT, _with_args, event_ms, instrument,
                             load_package)

MODULES = ("config", "models.tacotron2", "ops._build",
           "ops.decoder_megakernel", "ops.decoder_train_kernel",
           "ops.decoder_bwd_kernel", "ops.decoder_bptt")
SHAPES = ((1, 32), (4, 112), (8, 128), (1, 128))
LOOP = r"for \(int t = 0; t < n_iter; \+\+t\)"
# the phases of a design with eight barriers a step and no phase comments
EIGHT_BARRIERS = ("loop head", "prenet 1", "prenet 2", "attention LSTM",
                  "pq", "energies", "softmax/context", "decoder LSTM",
                  "heads + stop")
DEC_OUT = ("mels", "gates", "aligns", "n_frames", "frame_ends")
FWD_OUT = ("frames", "attn", "ha_s", "ca_s", "hd_s", "cd_s", "qsum_s",
           "aa_s", "ad_s")


def phase_names(src: str, loop: str = LOOP) -> list:
    """The intervals' names, from the code between the barriers of the
    time loop whose head matches ``loop``."""
    head = re.search(r"\n  " + loop + r" \{\n", src)
    parts = src[head.end():].split("\n  }\n", 1)[0].split(
        "    grid.sync();\n")
    marks = [re.search(r"// phase: (.+)", p) for p in parts]
    if all(marks):
        names = [m.group(1).strip() for m in marks]
    elif len(parts) == len(EIGHT_BARRIERS):
        names = list(EIGHT_BARRIERS)
    else:
        names = [f"interval {j}" for j in range(len(parts))]
    return names + ["empty barrier"]


def probe_library(pkg: dict, tag: str):
    """Build the instrumented copy of a package's decode kernel; the library
    and its phase names."""
    build = pkg["ops._build"]
    out = ROOT / "tacotron2_torch" / "_build" / "probe" / f"decode_{tag}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in build.CSRC.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    src = (build.CSRC / "decoder_infer.cu").read_text()
    (out / "decoder_infer.cu").write_text(instrument(src, LOOP, None))
    lib = out / "libprobe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "decoder_infer.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib)), phase_names(src)


def variant_library(pkg: dict, label: str, edits,
                    source: str = "decoder_infer",
                    transform=lambda src: src) -> ctypes.CDLL:
    """This package's kernel ``csrc/<source>.cu`` (by default the decode
    kernel) with ``edits`` (pairs of old and new text, each old text
    present in the source or in a shared header), then ``transform`` of
    the source's text, built apart."""
    build = pkg["ops._build"]
    out = ROOT / "tacotron2_torch" / "_build" / "probe" / f"variant_{label}"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    files = {f.name: f.read_text() for f in build.CSRC.glob("*.cuh")}
    files[f"{source}.cu"] = (build.CSRC / f"{source}.cu").read_text()
    for old, new in edits:
        hits = [n for n, text in files.items() if old in text]
        if not hits:
            raise ValueError(f"variant {label}: {old!r} not in the sources")
        for n in hits:
            files[n] = files[n].replace(old, new)
    files[f"{source}.cu"] = transform(files[f"{source}.cu"])
    for name, text in files.items():
        (out / name).write_text(text)
    lib = out / "libvariant.so"
    done = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                           str(out / f"{source}.cu")], check=True,
                          capture_output=True, text=True)
    (out / "nvcc.log").write_text(done.stdout + done.stderr)
    return ctypes.CDLL(str(lib))


def with_library(mod, lib, fn: str = "decoder_infer_mega"):
    """``mod.<fn>`` (by default the decode kernel's wrapper) launching
    ``lib`` in place of its own."""
    def run(*args):
        real = mod._lib
        mod._lib = lambda: _with_args(lib, real())
        try:
            return getattr(mod, fn)(*args)
        finally:
            mod._lib = real
    return run


def decode_inputs(pkg: dict, model, b: int, t_enc: int, steps: int, dev,
                  seed: int) -> tuple:
    """``decoder_infer_mega``'s arguments: seeded memory, ragged mask."""
    cfg = model.cfg
    g = torch.Generator().manual_seed(seed)
    memory = (torch.randn(b, t_enc, cfg.encoder_embedding_dim, generator=g)
              * 0.5).to(dev)
    lens = torch.tensor([t_enc - (t_enc // 4) * (i % 3) for i in range(b)])
    mask = pkg["models.tacotron2"].make_pad_mask(lens, t_enc).to(dev)
    return (model.decoder, memory, steps, cfg.gate_threshold, True, mask,
            "all" if b > 1 else "any", None)


def phase_split(pkg: dict, lib, names: list, args) -> dict:
    """us per step by phase from the instrumented kernel."""
    mod = pkg["ops.decoder_megakernel"]
    run = lambda: mod.decoder_infer_mega(*args)
    with torch.no_grad():
        steps = int(run()[3]) + int(args[4])
    real = mod._lib
    mod._lib = lambda: _with_args(lib, real())
    n = len(names) + 1
    counts = (ctypes.c_ulonglong * n)()
    try:
        lib.t2_probe_read.argtypes = [ctypes.c_void_p]
        with torch.no_grad():
            run()
            torch.cuda.synchronize()
            lib.t2_probe_read(counts)
            ms = event_ms(run, n=1)
        lib.t2_probe_read(counts)
    finally:
        mod._lib = real
    total = counts[n - 1]
    split = {p: counts[i] / total * ms * 1e3 / steps
             for i, p in enumerate(names)}
    return dict(ms=ms, us_per_step=ms * 1e3 / steps, split_us=split)


def train_pair_bits(pkgs: dict, dev) -> list:
    """The teacher-forced forward and the reverse chain of every package on
    the same seeded inputs (bf16, B=16, T_enc=128, T_dec=64): which of
    each other package's outputs equal this tree's bit for bit."""
    pkg = pkgs["this"]
    cfg = pkg["config"].ModelConfig()
    t2 = pkg["models.tacotron2"]
    model = t2.cast_params_bf16(t2.init_weights(t2.Tacotron2(cfg), seed=0))
    dec = model.decoder.to(dev)
    ops = pkg["ops.decoder_train_kernel"].kernel_operands(
        pkg["ops.decoder_bptt"].core_params(dec))
    b, t_enc, t_dec = 16, 128, 64
    g = torch.Generator().manual_seed(316)
    r = lambda *shape: torch.randn(*shape, generator=g)
    pre = torch.relu(r(t_dec, b, cfg.prenet_dim) * 0.5).to(dev)
    memory = (r(b, t_enc, cfg.encoder_embedding_dim) * 0.5).to(dev)
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    lens = torch.tensor([t_enc - 37 * (i % 3) for i in range(b)])
    mask = t2.make_pad_mask(lens, t_enc).to(dev)
    keep = lambda: (torch.rand(t_dec, b, cfg.decoder_rnn_dim, generator=g)
                    < 0.9).to(dev)
    mka, mkd = keep(), keep()
    cots = ((r(t_dec, b, cfg.n_mels + 1) * 0.1).to(dev),
            (r(t_dec, b, t_enc) * 0.1).to(dev))
    fwd = {k: p["ops.decoder_train_kernel"].decoder_fwd_train_mega(
        cfg, ops, pre, memory, pm, mask, mka, mkd) for k, p in pkgs.items()}
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = fwd["this"]
    args = (cfg, ops, memory, mka, mkd, aa_s, ad_s, ca_s, cd_s, attns,
            qsum_s, *cots)
    bwd = {k: p["ops.decoder_bwd_kernel"].decoder_bwd_chain_mega(*args)
           for k, p in pkgs.items()}
    rows = []
    for kernel, outs, names in (("decoder_fwd_train_mega", fwd, FWD_OUT),
                                ("decoder_bwd_chain_mega", bwd, BWD_OUT)):
        for k in pkgs:
            if k != "this":
                same = [n for n, x, y in zip(names, outs["this"], outs[k])
                        if torch.equal(x, y)]
                rows.append(dict(kernel=kernel, package=k, outputs=len(names),
                                 equal_outputs=same))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--variants", type=Path)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--out", type=Path)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: needs a CUDA card", file=sys.stderr)
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
    for pkg in pkgs.values():
        pkg["ops._build"].build()
    libs = ({k: probe_library(p, k) for k, p in pkgs.items()}
            if opts.phases else {})
    record = dict(card=card, decode=[], bit_for_bit=[], phases=[],
                  train_pair=[])
    this = pkgs["this"]
    runs = {k: p["ops.decoder_megakernel"] for k, p in pkgs.items()}
    runs = {k: (m.decoder_infer_mega, m) for k, m in runs.items()}
    if opts.variants:
        for label, edits in json.loads(opts.variants.read_text()).items():
            mod = this["ops.decoder_megakernel"]
            runs[label] = (with_library(mod, variant_library(this, label,
                                                             edits)), mod)
    others = [k for k in runs if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    t2 = this["models.tacotron2"]
    base = t2.init_weights(t2.Tacotron2(this["config"].ModelConfig()), seed=0)
    for dtype in (torch.bfloat16, torch.float32):
        model = (t2.cast_params_bf16(base) if dtype == torch.bfloat16
                 else base).to(dev)
        ratio = {}
        for b, t_enc in SHAPES:
            args = decode_inputs(this, model, b, t_enc, opts.steps, dev,
                                 seed=100 * b + t_enc)
            tag = f"{str(dtype)[6:]} B={b} T_enc={t_enc}"
            with torch.no_grad():
                outs = {k: run(*args) for k, (run, _) in runs.items()}
            steps = int(outs["this"][3]) + 1
            for k in order:
                run, mod = runs[k]
                with torch.no_grad():
                    ms = event_ms(lambda: run(*args))
                row = dict(shape=tag, package=k, ms=ms, steps=steps,
                           us_per_step=ms * 1e3 / steps,
                           grid=mod.decoder_infer_mega.last_grid_blocks)
                record["decode"].append(row)
                ratio.setdefault(k, {})[(b, t_enc)] = row["us_per_step"]
                print(f"[decode {tag}] {k}: {ms:.3f} ms = "
                      f"{row['us_per_step']:.2f} us/step over {steps} steps,"
                      f" grid {row['grid']}", flush=True)
            for k in others:
                same = [n for n, x, y in zip(DEC_OUT, outs["this"], outs[k])
                        if torch.equal(x, y)]
                record["bit_for_bit"].append(dict(shape=tag, package=k,
                                                  equal_outputs=same))
                print(f"[decode {tag}] this and {k}: {len(same)} of "
                      f"{len(DEC_OUT)} returns bit for bit"
                      + ("" if len(same) == len(DEC_OUT) else
                         f" (differ: {sorted(set(DEC_OUT) - set(same))})"),
                      flush=True)
            del outs
            for k, (lib, names) in libs.items():
                row = phase_split(pkgs[k], lib, names, args)
                row.update(shape=tag, package=k)
                record["phases"].append(row)
                print(f"[phases {tag}] {k} instrumented: "
                      f"{row['us_per_step']:.2f} us/step; us/step "
                      + ", ".join(f"{p} {v:.2f}"
                                  for p, v in row["split_us"].items()),
                      flush=True)
        for k, by in ratio.items():
            print(f"[decode {str(dtype)[6:]}] {k}: B=8 / B=1 at T_enc=128 "
                  f"{by[(8, 128)] / by[(1, 128)]:.3f}", flush=True)
        del model
    for row in train_pair_bits(pkgs, dev):
        record["train_pair"].append(row)
        print(f"[train pair bf16 B=16 T_enc=128 T_dec=64] {row['kernel']}: "
              f"this and {row['package']}: {len(row['equal_outputs'])} of "
              f"{row['outputs']} outputs bit for bit", flush=True)
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
