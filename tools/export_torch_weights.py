#!/usr/bin/env python3
"""Export a checkpoint of the JAX package as a weights file of the port.

    python tools/export_torch_weights.py checkpoints/r4_synth_bf16 \\
        /path/to/r4_synth_bf16.pt [--n_speakers N]

Reads the checkpoint (Orbax directory, or any format
``tacotron2_tpu.infer.synthesize.load_model`` reads) with the JAX package's
loader, fills a ``tacotron2_torch`` model through
``utils/weights.py::load_jax_params`` and writes its ``state_dict`` with
``torch.save``: parameters and BatchNorm statistics only, no optimizer
state.  The JAX loader hands every array back as fp32 whatever the
checkpoint stores, so the stored type is recovered from the values: a
parameter whose every value is a bf16 number (a bf16 export) is written as
bf16, bit for bit the checkpoint's; anything else, and the BatchNorm
statistics, as fp32.  ``tacotron2_torch.infer.synthesize.load_model`` reads
the file with ``torch`` alone, which is what a machine without JAX needs.
Needs both packages, so it is a tool outside either.  The file it writes
(tens of megabytes for the full-width model) is an output, not a source: it is
not committed.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def export(checkpoint: str, out_path: str, **model_fields) -> dict:
    """Write the weights file; returns the state dict it wrote.
    ``model_fields`` are the ``ModelConfig`` fields (of both packages) in
    which the checkpoint's architecture differs from the default."""
    import jax

    from tacotron2_tpu.config import Config as JaxConfig
    from tacotron2_tpu.config import ModelConfig as JaxModelConfig
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import Tacotron2
    from tacotron2_torch.utils.weights import load_jax_params

    # the module, not the function of the same name its package exports
    jax_synth = importlib.import_module("tacotron2_tpu.infer.synthesize")
    params, state = jax_synth.load_model(
        checkpoint, JaxConfig(model=JaxModelConfig(**model_fields)))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    params, state = to_np(params), to_np(state)
    model = Tacotron2(ModelConfig(**model_fields))
    load_jax_params(model, params, state)
    parameters = {name for name, _ in model.named_parameters()}
    sd = {}
    for key, value in model.state_dict().items():
        half = value.to(torch.bfloat16)
        exact = key in parameters and torch.equal(half.float(), value)
        sd[key] = (half if exact else value).contiguous()
    torch.save(sd, out_path)
    return sd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint", help="checkpoint of the JAX package")
    ap.add_argument("output", help="weights file to write (.pt)")
    ap.add_argument("--n_speakers", type=int, default=1)
    args = ap.parse_args()
    sd = export(args.checkpoint, args.output, n_speakers=args.n_speakers)
    by_dtype = {}
    for v in sd.values():
        by_dtype[str(v.dtype)] = by_dtype.get(str(v.dtype), 0) + v.numel()
    print(f"wrote {args.output}: {len(sd)} tensors, "
          + ", ".join(f"{n} x {d}" for d, n in sorted(by_dtype.items()))
          + f", {os.path.getsize(args.output) / 1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
