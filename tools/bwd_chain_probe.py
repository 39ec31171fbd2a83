#!/usr/bin/env python3
"""Time the reverse-chain kernel (``csrc/decoder_train_bwd.cu``) on one
CUDA card: by phase, against another checkout's kernel, and in a train step.

    python3 tools/bwd_chain_probe.py [--compare LABEL=DIR ...] [--phases]
                                     [--train-step] [--errors] [--out FILE]

``--compare LABEL=DIR`` names a directory that holds another checkout's
``tacotron2_torch`` (for example ``git archive <commit> tacotron2_torch |
tar -x -C DIR``); it is loaded beside this tree's package under another
name, and the kernels are timed in turns (other, this, this, other) on
the same inputs with CUDA events over the launch.  Shapes: the training
main path's (B=16, T_enc=128, T_dec=512) and B in {2, 5, 8, 16} at
T_dec=64, bf16 and fp32 weights, seeded full-width decoder.

Each shape also says whether the packages' outputs agree bit for bit.

``--errors`` holds each package's kernel against the plain version on the
card, on the inputs of ``chip_smoke.py``'s phases 8-9 (same seeds), with
the smoke's rule (largest error past two bf16 roundings, as a share of the
plain output's mean size); and the plain version run on the CPU against
the same on the card, which is the noise of the comparison itself.

``--phases`` builds, for each package, a copy of its kernel source with a
``clock64`` counter read by block 0 after every grid barrier, one barrier
added after phase E and one empty barrier (its cost) per step, into
``tacotron2_torch/_build/probe/``.  The copy is made at run time only;
nothing in the package builds it.  The split is each interval's share of
the counted cycles times the instrumented launch's own time, per step.

``--train-step`` runs ``train_step`` (bf16, B=16, T_enc=128, T_dec=512,
seeded weights and batch) with each package, in turns, under
``torch.profiler``: wall time, device busy time and the reverse chain's
device time.

Prints the card's name and power limit first, one line per measurement,
and writes them all as JSON to ``--out`` (default
``chiprun_out/bwd_chain_probe.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
PHASES = ("A", "B", "C1", "C2", "C3", "D", "E", "empty barrier")
MODULES = ("config", "models.tacotron2", "ops.decoder_bptt",
           "ops.decoder_bwd_kernel", "ops.decoder_train_kernel", "ops._build",
           "data.dataset", "train.step", "train.optim", "train.state")
_PROBE_HEAD = """
__device__ unsigned long long g_probe[9];
#define PROBE(i) if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  const long long now_ = clock64(); g_probe[i] += now_ - last_; last_ = now_; }
"""
_PROBE_READ = """
extern "C" int t2_probe_read(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, sizeof(g_probe));
  if (e != cudaSuccess) return e;
  unsigned long long z[9] = {};
  return cudaMemcpyToSymbol(g_probe, z, sizeof(z));
}
"""


def load_package(pkg_dir: Path, name: str) -> dict:
    """Import the package at ``pkg_dir`` as ``name``; its modules."""
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return {m: importlib.import_module(f"{name}.{m}") for m in MODULES}


def instrument(src: str) -> str:
    """The kernel source with a clock64 counter after every grid barrier
    (phases A, B, C1, C2, C3, D), a barrier and a counter after phase E,
    and an empty barrier with its counter, per step."""
    src = src.replace('#include "decoder_common.cuh"\n',
                      '#include "decoder_common.cuh"\n' + _PROBE_HEAD, 1)
    loop = re.search(r"\n  for \(int t = S - 1; t >= 0; --t\) \{\n", src)
    src = (src[:loop.start()] + "\n  long long last_ = clock64();"
           "\n  const long long start_ = last_;" + src[loop.start():])
    parts = src.split("    grid.sync();\n")
    if len(parts) != 7:
        raise RuntimeError(f"expected six barriers a step, found "
                           f"{len(parts) - 1}")
    src = parts[0] + "".join(f"    grid.sync();\n    PROBE({i})\n" + p
                             for i, p in enumerate(parts[1:]))
    end = src.index("smem_bytes(const TrainBwdArgs")
    close = src.rindex("\n  }\n}\n", 0, end)
    src = (src[:close] + "\n    grid.sync();\n    PROBE(6)\n    grid.sync();"
           "\n    PROBE(7)\n  }\n  if (blockIdx.x == 0 && threadIdx.x == 0) "
           "g_probe[8] += clock64() - start_;\n}\n"
           + src[close + len("\n  }\n}\n"):])
    return src + _PROBE_READ


def probe_library(pkg: dict, tag: str) -> ctypes.CDLL:
    """Build the instrumented copy of a package's reverse-chain kernel."""
    build = pkg["ops._build"]
    out = ROOT / "tacotron2_torch" / "_build" / "probe" / tag
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for f in build.CSRC.glob("*.cuh"):
        shutil.copy(f, out / f.name)
    (out / "decoder_train_bwd.cu").write_text(
        instrument((build.CSRC / "decoder_train_bwd.cu").read_text()))
    lib = out / "libprobe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "decoder_train_bwd.cu")], check=True,
                   capture_output=True)
    return ctypes.CDLL(str(lib))


def chain_inputs(pkg: dict, b: int, t_dec: int, dtype, dev, seed: int):
    """Seeded full-width inputs of the reverse chain: the series the forward
    kernel stores, dropout masks at 0.1 and small cotangents."""
    cfg = pkg["config"].ModelConfig()
    t2 = pkg["models.tacotron2"]
    model = t2.init_weights(t2.Tacotron2(cfg), seed=0)
    if dtype == torch.bfloat16:
        model = t2.cast_params_bf16(model)
    dec = model.decoder.to(dev)
    ops = pkg["ops.decoder_train_kernel"].kernel_operands(
        pkg["ops.decoder_bptt"].core_params(dec))
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=g)
    t_enc = 128
    pre = torch.relu(r(t_dec, b, cfg.prenet_dim) * 0.5).to(dev)
    memory = (r(b, t_enc, cfg.encoder_embedding_dim) * 0.5).to(dev)
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    lens = torch.tensor([t_enc - 37 * (i % 3) for i in range(b)])
    mask = t2.make_pad_mask(lens, t_enc).to(dev)
    keep = lambda: (torch.rand(t_dec, b, cfg.decoder_rnn_dim, generator=g)
                    < 0.9).to(dev)
    mka, mkd = keep(), keep()
    fwd = pkg["ops.decoder_train_kernel"].decoder_fwd_train_mega(
        cfg, ops, pre, memory, pm, mask, mka, mkd)
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = fwd
    cots = ((r(t_dec, b, cfg.n_mels + 1) * 0.1).to(dev),
            (r(t_dec, b, t_enc) * 0.1).to(dev))
    return (cfg, ops, memory, mka, mkd, aa_s, ad_s, ca_s, cd_s, attns,
            qsum_s, *cots)


def event_ms(fn, n: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def phase_split(pkg: dict, lib: ctypes.CDLL, args, t_dec: int) -> dict:
    """us per step by phase from the instrumented kernel."""
    mod = pkg["ops.decoder_bwd_kernel"]
    real = mod._lib
    mod._lib = lambda: _with_args(lib, real())
    try:
        lib.t2_probe_read.argtypes = [ctypes.c_void_p]
        counts = (ctypes.c_ulonglong * 9)()
        mod.decoder_bwd_chain_mega(*args)
        torch.cuda.synchronize()
        lib.t2_probe_read(counts)
        ms = event_ms(lambda: mod.decoder_bwd_chain_mega(*args), n=1)
        lib.t2_probe_read(counts)
    finally:
        mod._lib = real
    total = counts[8]
    split = {p: counts[i] / total * ms * 1e3 / t_dec
             for i, p in enumerate(PHASES)}
    return dict(ms=ms, us_per_step=ms * 1e3 / t_dec, split_us=split,
                cycles_per_us=total / (ms * 1e3))


def _with_args(lib, real):
    """The instrumented library with the real one's ctypes signatures."""
    for fn in ("t2_decoder_train_bwd", "t2_decoder_train_bwd_args_size"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


BWD_OUT = ("g_att_s", "g_dec_s", "d_ctx_s", "d_pre_s", "d_qsum_s", "d_pq_s",
           "dv", "dpm", "scal")


def share_past_roundings(got, ref) -> float:
    """chip_smoke.py's rule: the largest error past two bf16 roundings of
    the plain value (bf16-stored outputs), over the plain mean size."""
    stored_bf16 = ref.dtype == torch.bfloat16
    g, r = got.detach().float().cpu(), ref.detach().float().cpu()
    err = (g - r).abs()
    if stored_bf16:
        err = (err - 2 * 2.0 ** -7 * r.abs()).clamp(min=0)
    return float(err.max()) / float(r.abs().mean())


def smoke_chain_inputs(pkg: dict, dtype, b: int, dev):
    """The reverse chain's inputs of chip_smoke.py's phases 8-9 at batch b
    (T_enc=128, T_dec=64, dropout 0.1/0.1, seed 200 + b)."""
    import copy
    cfg = pkg["config"].ModelConfig()
    t2 = pkg["models.tacotron2"]
    base = t2.init_weights(t2.Tacotron2(cfg), seed=0)
    m = base if dtype == torch.float32 else t2.cast_params_bf16(base)
    dec = copy.deepcopy(m.decoder).to(dev)
    ops = pkg["ops.decoder_train_kernel"].kernel_operands(
        pkg["ops.decoder_bptt"].core_params(dec))
    h, t_enc, t_dec = cfg.decoder_rnn_dim, 128, 64
    g = torch.Generator().manual_seed(200 + b)
    r = lambda *shape: torch.randn(*shape, generator=g)
    pre = torch.relu(r(t_dec, b, cfg.prenet_dim) * 0.5).to(dev)
    memory = (r(b, t_enc, cfg.encoder_embedding_dim) * 0.5).to(dev)
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    lens = torch.tensor([t_enc - 37 * (i % 3) for i in range(b)])
    mask = t2.make_pad_mask(lens, t_enc).to(dev)
    keep = lambda: (torch.rand(t_dec, b, h, generator=g) < 0.9).to(dev)
    cots = ((r(t_dec, b, cfg.n_mels + 1) * 0.1).to(dev),
            (r(t_dec, b, t_enc) * 0.1).to(dev))
    mka, mkd = keep(), keep()    # drawn after the cotangents, as there
    got = pkg["ops.decoder_train_kernel"].decoder_fwd_train_mega(
        cfg, ops, pre, memory, pm, mask, mka, mkd)
    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = got
    return (cfg, ops, memory, mka, mkd, aa_s, ad_s, ca_s, cd_s, attns,
            qsum_s, *cots)


def error_shares(pkgs: dict, dev) -> list:
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for b in (2, 5, 8, 16):
            args = smoke_chain_inputs(pkgs["this"], dtype, b, dev)
            mod = pkgs["this"]["ops.decoder_bwd_kernel"]
            ref = mod.decoder_bwd_chain_reference(*args)
            tag = f"{str(dtype)[6:]} B={b} T_enc=128 T_dec=64"
            for k, pkg in pkgs.items():
                got = pkg["ops.decoder_bwd_kernel"].decoder_bwd_chain_mega(
                    *args)
                rows.append(dict(shape=tag, what=f"{k} kernel vs plain",
                                 share={n: share_past_roundings(x, y)
                                        for n, x, y in zip(BWD_OUT, got,
                                                           ref)}))
            cpu = tuple(
                {n: v.cpu() for n, v in x.items()} if isinstance(x, dict)
                else x.cpu() if torch.is_tensor(x) else x for x in args)
            got = mod.decoder_bwd_chain_reference(*cpu)
            rows.append(dict(shape=tag, what="plain on the CPU vs plain",
                             share={n: share_past_roundings(x, y)
                                    for n, x, y in zip(BWD_OUT, got, ref)}))
    return rows


def train_step_times(pkg: dict, dev, n: int = 2) -> list:
    """Wall, device busy and reverse-chain device ms of ``n`` train steps
    (after one untimed step), bf16, B=16, T_enc=128, T_dec=512."""
    from torch.profiler import ProfilerActivity, profile
    cfg = pkg["config"].Config()
    mc = cfg.model
    tx = pkg["train.optim"].make_optimizer(cfg.train)
    state = pkg["train.state"].create_train_state(cfg, seed=0, tx=tx)
    rng = np.random.default_rng(0)
    text_lens = rng.integers(60, 129, 16)
    mel_lens = rng.integers(300, 513, 16)
    text_lens[3], mel_lens[5] = 128, 512
    ds = pkg["data.dataset"]
    batch = ds.collate([
        ds.Example(text=rng.integers(0, mc.n_symbols, k).astype(np.int32),
                   mel=(rng.standard_normal((mc.n_mels, m)) * 1.5 - 5.0
                        ).astype(np.float32))
        for k, m in zip(text_lens, mel_lens)])
    pkg["models.tacotron2"].init_projection_bias(state.model, batch["mel"])
    step = lambda: pkg["train.step"].train_step(
        state, batch, cfg=cfg, tx=tx, use_postnet=True,
        sigma_warmup_steps=cfg.guided_attention.sigma_warmup_steps)
    step()
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) * 1e3
        by = {e.key: e.self_device_time_total / 1e3
              for e in prof.key_averages() if e.self_device_time_total > 0}
        busy = sum(by.values())
        chain = sum(v for k, v in by.items() if "decoder_train_bwd" in k)
        out.append(dict(wall_ms=wall, busy_ms=busy,
                        idle_share=1 - busy / wall, chain_ms=chain))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", action="append", default=[],
                    metavar="LABEL=DIR")
    ap.add_argument("--errors", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--train-step", action="store_true")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "bwd_chain_probe.json")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("bwd_chain_probe: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    pkgs = {"this": load_package(ROOT / "tacotron2_torch", "t2_this")}
    for spec in opts.compare:
        label, path = spec.split("=", 1)
        pkgs[label] = load_package(Path(path) / "tacotron2_torch",
                                   f"t2_{label}")
    for pkg in pkgs.values():
        pkg["ops._build"].build(["decoder_train_fwd", "decoder_train_bwd"])
    libs = ({k: probe_library(p, k) for k, p in pkgs.items()}
            if opts.phases else {})
    record = dict(card=card, chain=[], train_step=[], errors=[])
    others = [k for k in pkgs if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    if opts.errors:
        for row in error_shares(pkgs, dev):
            record["errors"].append(row)
            print(f"[errors {row['shape']}] {row['what']}: "
                  + ", ".join(f"{k} {v:.2e}" for k, v in row["share"].items()),
                  flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for b, t_dec in ((16, 512), (16, 64), (8, 64), (5, 64), (2, 64)):
            args = chain_inputs(pkgs["this"], b, t_dec, dtype, dev,
                                seed=100 + b)
            tag = f"{str(dtype)[6:]} B={b} T_enc=128 T_dec={t_dec}"
            for k in order:
                mod = pkgs[k]["ops.decoder_bwd_kernel"]
                ms = event_ms(lambda: mod.decoder_bwd_chain_mega(*args))
                row = dict(shape=tag, package=k, ms=ms,
                           us_per_step=ms * 1e3 / t_dec,
                           grid=mod.decoder_bwd_chain_mega.last_grid_blocks)
                record["chain"].append(row)
                print(f"[chain {tag}] {k}: {ms:.3f} ms = "
                      f"{row['us_per_step']:.1f} us/step, grid {row['grid']}",
                      flush=True)
            outs = {k: p["ops.decoder_bwd_kernel"].decoder_bwd_chain_mega(
                *args) for k, p in pkgs.items()}
            for k in others:
                same = [n for n, x, y in zip(BWD_OUT, outs["this"], outs[k])
                        if torch.equal(x, y)]
                record.setdefault("bit_for_bit", []).append(
                    dict(shape=tag, package=k, equal_outputs=same))
                print(f"[chain {tag}] this and {k}: {len(same)} of "
                      f"{len(BWD_OUT)} outputs bit for bit"
                      + ("" if len(same) == len(BWD_OUT) else
                         f" (differ: {sorted(set(BWD_OUT) - set(same))})"),
                      flush=True)
            del outs
            for k, lib in libs.items():
                row = phase_split(pkgs[k], lib, args, t_dec)
                row.update(shape=tag, package=k)
                record.setdefault("phases", []).append(row)
                print(f"[phases {tag}] {k} instrumented: "
                      f"{row['us_per_step']:.1f} us/step; us/step "
                      + ", ".join(f"{p} {v:.1f}"
                                  for p, v in row["split_us"].items()),
                      flush=True)
            del args
    if opts.train_step:
        for k in order:
            for row in train_step_times(pkgs[k], dev):
                row["package"] = k
                record["train_step"].append(row)
                print(f"[train_step bf16 B=16 T_enc=128 T_dec=512] {k}: wall "
                      f"{row['wall_ms']:.1f} ms, device busy "
                      f"{row['busy_ms']:.1f} ms (idle share "
                      f"{row['idle_share']:.3f}), reverse chain "
                      f"{row['chain_ms']:.1f} ms", flush=True)
            torch.cuda.empty_cache()
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
