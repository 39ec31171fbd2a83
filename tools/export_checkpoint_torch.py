#!/usr/bin/env python3
"""Export a checkpoint as a compact params-only checkpoint of the port,
without JAX.

The counterpart of ``tools/export_checkpoint.py``: the optimizer state and
counters are dropped and the weights optionally cast to bfloat16; the
BatchNorm running statistics stay fp32.  The result is a directory with a
``weights.pt`` (``train/checkpoint.py::save_params_only``), which
``infer/synthesize.py::load_model`` and a training resume read, casting
the weights back to fp32.

    python tools/export_checkpoint_torch.py runs/ckpt/best_model out_dir \\
        [--dtype bfloat16|float32] [--n_speakers N]

The input is any checkpoint the port reads: its own, full or params-only,
an Orbax directory of the JAX package, or the reference's ``.pth``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def export(checkpoint: str, out: str, dtype: str = "bfloat16",
           n_speakers: int = 1):
    """Write the params-only checkpoint; returns the model written."""
    import torch

    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import Tacotron2
    from tacotron2_torch.train.checkpoint import save_params_only
    from tacotron2_torch.utils.weight_files import load_weights

    cfg = dataclasses.replace(ModelConfig(), n_speakers=n_speakers)
    model = load_weights(checkpoint, Tacotron2(cfg))
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        for p in model.parameters():      # buffers (BN statistics) stay fp32
            p.data = p.data.to(dt)
    save_params_only(out, model)
    n = sum(p.numel() for p in model.parameters())
    print(f"exported {n / 1e6:.1f} M params as {dtype} -> {out}")
    return model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("out")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--n_speakers", type=int, default=1)
    args = ap.parse_args(argv)
    export(args.checkpoint, args.out, args.dtype, args.n_speakers)


if __name__ == "__main__":
    main()
