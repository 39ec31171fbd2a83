#!/usr/bin/env python
"""Widths the port's kernels take: every plan and check over a grid, on the CPU.

Calls the launch plans and checks of the five CUDA kernels, host side only
(no card, no build), over the configs that ROADMAP.md's fault C6 lists:
``attention_dim`` 128, 289, 512, 1024 at ``location_kernel_size`` 31, 63,
95, 127 (the decoder kernels #2-#4), encoder and postnet kernel sizes 5,
33, 35, 64, 65, 129 (the conv #5) and ``encoder_embedding_dim`` 512,
16392 (the attention tail #1), in fp32 and bf16.  A line a config: what the
plan takes (chunks, tap groups, the wide tail, a resident location matrix
or not), or the error it raises.  ``*`` marks a path a kernel takes only
past the widths it took before the repair of C6, where it refused:

- #4 ``chain_plan`` raised where its shared memory passed 115712 bytes:
  now phase C3 stages A in chunks (``location_chunks`` > 1);
- #2, #3 failed their launch where the location matrix left the layout
  past a block's 232448 bytes: now it stays in L2 (``resident`` False);
- #5 ``conv_bn_act`` raised past 33 taps: now the taps run in groups;
- #1 ``tail_plan`` raised on a row past a 64 KB stage or a block's shared
  memory: now the wide kernel takes it.

``--launch`` (on a card) launches each kernel over the same grid instead,
at small other widths, and prints for each config whether it ran or what
it raised; ``--package DIR`` does that with another checkout's
``tacotron2_torch`` (``git archive <commit> tacotron2_torch | tar -x -C
DIR``), to see what a tree before the repair refused on the card.

    python tools/c6_sweep.py [--json FILE]
    python3 tools/c6_sweep.py --launch [--package DIR] [--json FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

from tacotron2_torch.config import ModelConfig  # noqa: E402
from tacotron2_torch.models.decoder import Decoder  # noqa: E402
from tacotron2_torch.ops.attention_kernel import tail_plan  # noqa: E402
from tacotron2_torch.ops.convbn_kernel import (  # noqa: E402
    ONE_GROUP_TAPS, tap_groups)
from tacotron2_torch.ops.decoder_bwd_kernel import chain_plan  # noqa: E402
from tacotron2_torch.ops.decoder_megakernel import (  # noqa: E402
    check_launch, decode_smem, kernel_widths)
from tacotron2_torch.ops.decoder_train_kernel import (  # noqa: E402
    check_pair_inputs, fwd_smem, kernel_operands)

ATTENTION_DIMS = (128, 289, 512, 1024)
LOCATION_TAPS = (31, 63, 95, 127)
CONV_TAPS = (5, 33, 35, 64, 65, 129)
ENCODER_DIMS = (512, 16392)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B, T_ENC, T_DEC = 16, 128, 512      # the training path's shapes


def attempt(fn):
    """What ``fn`` returns, or the error it raises, as a dict."""
    try:
        return fn()
    except (ValueError, TypeError, RuntimeError) as err:
        return {"raises": f"{type(err).__name__}: {err}"}


def decoder_rows():
    rows = []
    for a in ATTENTION_DIMS:
        for k in LOCATION_TAPS:
            cfg = ModelConfig(attention_dim=a, location_kernel_size=k)
            dec = Decoder(cfg)
            memory = torch.zeros(2, 11, cfg.encoder_embedding_dim)
            kd = kernel_widths(cfg)
            for name, dt in DTYPES.items():
                dec.to(dt)
                ops = kernel_operands(dict(dec.named_parameters()))

                def checks():
                    check_launch(dec, memory.to(dt), 8, None, "any")
                    check_pair_inputs("pair", cfg, ops, memory, T_DEC)
                    return {"checks": "pass"}

                def chain():
                    p = chain_plan(kd, B, T_ENC, k, dt)
                    return {"smem_bytes": p.smem_bytes,
                            "location_cols": p.location_cols,
                            "location_chunks": p.location_chunks,
                            "new_path": p.location_chunks > 1}

                def layout(fn, *args):
                    smem, resident = fn(*args, kd["A"], k, dt)
                    return {"smem_bytes": smem, "resident": resident,
                            "new_path": not resident}

                rows.append({
                    "attention_dim": a, "location_kernel_size": k,
                    "dtype": name, "checks": attempt(checks),
                    "decoder_bwd_chain_mega": attempt(chain),
                    "decoder_fwd_train_mega": attempt(
                        lambda: layout(fwd_smem, T_ENC)),
                    "decoder_infer_mega": attempt(
                        lambda: layout(decode_smem, 4, T_ENC))})
    return rows


def conv_rows():
    rows = []
    for k in CONV_TAPS:
        groups, taps = tap_groups(k)
        rows.append({"kernel_size": k, "tap_groups": groups,
                     "taps_a_group": taps, "fold_taps": groups * taps,
                     "new_path": k > ONE_GROUP_TAPS})
    return rows


def tail_rows():
    rows = []
    for d in ENCODER_DIMS:
        for name, dt in DTYPES.items():
            for b, t in ((1, 8), (4, 112), (16, 128)):
                def plan():
                    p = tail_plan(b, t, 128, d, dt)
                    return {"split": p.split, "tile_rows": p.tile_rows,
                            "stages": p.stages, "smem_bytes": p.smem_bytes,
                            "wide": p.wide, "new_path": p.wide}
                rows.append({"encoder_embedding_dim": d, "dtype": name,
                             "B": b, "T_enc": t, "attention_tail":
                             attempt(plan)})
    return rows


SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, location_n_filters=4,
             postnet_embedding_dim=32)


def launch_rows(root: Path):
    """Each kernel of the package under ``root`` launched on the card at
    each config of the grid: ``ran`` or the error it raised."""
    from bwd_chain_probe import load_package
    mods = ("config", "models.tacotron2", "models.layers", "ops._build",
            "ops.decoder_bptt", "ops.decoder_megakernel",
            "ops.decoder_train_kernel", "ops.decoder_bwd_kernel",
            "ops.convbn_kernel", "ops.attention_kernel")
    pkg = load_package(root / "tacotron2_torch", "t2_sweep", mods)
    pkg["ops._build"].build()
    dev = torch.device("cuda")
    tm = pkg["models.tacotron2"]
    g = torch.Generator().manual_seed(0)
    rows = []

    def attempt_launch(kernel, config, fn):
        try:
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            what = "ran"
        except (ValueError, TypeError, RuntimeError) as err:
            what = f"raises {type(err).__name__}: {err}"
        rows.append(dict(kernel=kernel, config=config, result=what))
        print(f"[{kernel}] {config}: {what}", flush=True)

    for a in ATTENTION_DIMS:
        for k in LOCATION_TAPS:
            for name, dt in DTYPES.items():
                cfg = pkg["config"].ModelConfig(
                    **SMALL, attention_dim=a, location_kernel_size=k)
                model = tm.init_weights(tm.Tacotron2(cfg), seed=0)
                if dt == torch.bfloat16:
                    model = tm.cast_params_bf16(model)
                dec = model.decoder.to(dev)
                memory = torch.randn(2, 12, 32, generator=g).to(dev) * 0.5
                config = f"A={a} K={k} {name}"
                attempt_launch(
                    "decoder_infer_mega", config,
                    lambda: pkg["ops.decoder_megakernel"].decoder_infer_mega(
                        dec, memory, 6, 0.5))
                fwd_mod = pkg["ops.decoder_train_kernel"]
                ops = fwd_mod.kernel_operands(
                    pkg["ops.decoder_bptt"].core_params(dec))
                pre = torch.rand(6, 2, 16, generator=g).to(dev)
                pm = dec.attention.memory_layer(memory)
                mask = torch.zeros(2, 12, dtype=torch.bool, device=dev)
                keep = torch.ones(6, 2, 64, dtype=torch.bool, device=dev)
                args = (cfg, ops, pre, memory, pm, mask, keep, keep)
                attempt_launch("decoder_fwd_train_mega", config,
                               lambda: fwd_mod.decoder_fwd_train_mega(*args))
                with torch.no_grad():
                    _, attns, _, ca_s, _, cd_s, qsum_s, aa_s, ad_s = (
                        fwd_mod.decoder_fwd_train_reference(*args))
                cots = (torch.randn(6, 2, 9, generator=g).to(dev),
                        torch.randn(6, 2, 12, generator=g).to(dev))
                attempt_launch(
                    "decoder_bwd_chain_mega", config,
                    lambda: pkg["ops.decoder_bwd_kernel"]
                    .decoder_bwd_chain_mega(cfg, ops, memory, keep, keep,
                                            aa_s, ad_s, ca_s, cd_s, attns,
                                            qsum_s, *cots))
    layers = pkg["models.layers"]
    for k in CONV_TAPS:
        for name, dt in DTYPES.items():
            conv = layers.Conv1d(8, 8, k).to(dev, dt)
            bn = layers.BatchNorm(8).to(dev)
            x = torch.randn(1, 8, 20, generator=g).to(dev)
            attempt_launch("conv_bn_act", f"K={k} {name}",
                           lambda: pkg["ops.convbn_kernel"].conv_bn_act(
                               x, conv, bn, 1e-5, "relu"))
    for d in ENCODER_DIMS:
        for name, dt in DTYPES.items():
            q = torch.randn(1, 8, 128, generator=g).to(dev)
            mem = torch.randn(1, 8, d, generator=g).to(dev, dt)
            attempt_launch(
                "attention_tail", f"D={d} memory {name}",
                lambda: pkg["ops.attention_kernel"].attention_tail(
                    q, q[0, 0], q[0, 0, 0], q[0, 0, 1],
                    torch.zeros(1, 8, dtype=torch.bool, device=dev), mem))
    return rows


def describe(entry) -> str:
    if "raises" in entry:
        return "RAISES " + entry["raises"]
    mark = "*" if entry.get("new_path") else " "
    return mark + " ".join(f"{k}={v}" for k, v in entry.items()
                           if k != "new_path")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write every row to this file")
    ap.add_argument("--launch", action="store_true",
                    help="launch each kernel on the card over the grid")
    ap.add_argument("--package", type=Path, default=Path(ROOT),
                    help="the checkout whose tacotron2_torch --launch runs")
    args = ap.parse_args()
    if args.launch:
        rows = launch_rows(args.package.resolve())
        print(f"configs that raise: "
              f"{sum(r['result'] != 'ran' for r in rows)} of {len(rows)}")
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rows, f, indent=1)
        return
    out = {"decoder": decoder_rows(), "conv": conv_rows(),
           "tail": tail_rows()}
    raises = 0
    for r in out["decoder"]:
        head = (f"A={r['attention_dim']:4d} K={r['location_kernel_size']:3d}"
                f" {r['dtype']:8s}")
        for kern in ("decoder_bwd_chain_mega", "decoder_fwd_train_mega",
                     "decoder_infer_mega"):
            print(f"[{kern}] {head} {describe(r[kern])}")
            raises += "raises" in r[kern]
        print(f"[checks] {head} {describe(r['checks'])}")
        raises += "raises" in r["checks"]
    for r in out["conv"]:
        print(f"[conv_bn_act] {describe(r)}")
    for r in out["tail"]:
        print(f"[attention_tail] D={r['encoder_embedding_dim']} "
              f"{r['dtype']} B={r['B']} T_enc={r['T_enc']} "
              f"{describe(r['attention_tail'])}")
        raises += "raises" in r["attention_tail"]
    print(f"configs that raise: {raises}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
