#!/usr/bin/env python3
"""The JAX package's own bf16 gap between its decode kernel and its
``while_loop`` decode, at the shape where the port's kernel drifts most.

    JAX_PLATFORMS=cpu python tools/decode_c3_gap.py [--steps 400]
        [--sentences 4] [--out FILE]

The port's seeded full-width model (``init_weights(seed=0)``, the bf16
serving cast) encodes each of ``chip_smoke.py``'s text -> PCM sentences
alone on the CPU (B=1, T_enc=32 after padding to 16); its weights go to the
JAX package through ``utils/weights.py::export_jax_params`` and are cast to
bf16 there (the same values: every weight is already a bf16 number).  On
that encoder memory and mask, the JAX ``decoder_infer_mega`` (Pallas, in
interpret mode on the CPU) and the JAX ``decoder_infer`` (``while_loop``)
decode ``--steps`` frames, first frame dropped, stop mode "any", no forced
stop.  The gap is ``chip_smoke.py``'s: the largest alignment difference
over the frames out, as a share of the loop's mean alignment size; the
mels' and gate logits' largest differences beside it.  The port's own
kernel-vs-step-loop gap is a card number (2.6e-2 at this shape).

Needs both packages, so it is a tool outside either.  Prints one line per
sentence, and with ``--out FILE`` writes them there as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TEXTS = ("The quick brown fox.", "Speech synthesis on one card.",
         "It costs 42 dollars.", "A zorblaxian wug sings.")


def gaps(ref, got) -> dict:
    """Largest differences over the frames out; the alignments' also as a
    share of the reference alignments' mean size."""
    n = int(ref[3])
    out = {"n_frames": [n, int(got[3])]}
    for name, r, g in zip(("mels", "gates", "aligns"), ref[:3], got[:3]):
        r = np.asarray(r, np.float64)[:, :n]
        g = np.asarray(g, np.float64)[:, :n]
        out[name] = float(np.abs(r - g).max())
    out["aligns_mean"] = float(np.abs(np.asarray(ref[2])[:, :n]).mean())
    out["aligns_share"] = out["aligns"] / out["aligns_mean"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--sentences", type=int, default=len(TEXTS))
    ap.add_argument("--out")
    opts = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch
    from tacotron2_tpu.config import ModelConfig as JaxModelConfig
    from tacotron2_tpu.models.decoder import decoder_infer
    from tacotron2_tpu.models.tacotron2 import \
        cast_params_bf16 as jax_cast_bf16
    from tacotron2_tpu.ops.decoder_megakernel import decoder_infer_mega
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.encoder import encoder_apply
    from tacotron2_torch.models.tacotron2 import (
        Tacotron2, cast_params_bf16, init_weights, make_pad_mask)
    from tacotron2_torch.text import pad_sequences, text_to_sequence
    from tacotron2_torch.utils.weights import export_jax_params

    model = cast_params_bf16(init_weights(Tacotron2(ModelConfig()), seed=0))
    params, _ = export_jax_params(model)
    jdec = jax_cast_bf16(jax.tree_util.tree_map(jnp.asarray,
                                                params))["decoder"]
    jcfg = JaxModelConfig()
    static = ("cfg", "max_steps", "gate_threshold", "drop_first_frame",
              "stop_mode")
    loop = jax.jit(decoder_infer, static_argnames=static)
    mega = jax.jit(decoder_infer_mega, static_argnames=static)
    rows = []
    for text in TEXTS[:opts.sentences]:
        tokens, lengths = pad_sequences([text_to_sequence(text)],
                                        pad_multiple=16)
        with torch.no_grad():
            memory = encoder_apply(model.encoder,
                                   torch.from_numpy(tokens).long())
        mask = make_pad_mask(torch.from_numpy(lengths), tokens.shape[1])
        kw = dict(cfg=jcfg, memory=jnp.asarray(memory.float().numpy()),
                  max_steps=opts.steps, gate_threshold=jcfg.gate_threshold,
                  drop_first_frame=True, mask=jnp.asarray(mask.numpy()),
                  stop_mode="any")
        t0 = time.time()
        ref = jax.block_until_ready(loop(jdec, **kw))
        t1 = time.time()
        got = jax.block_until_ready(mega(jdec, **kw))
        t2 = time.time()
        row = dict(text=text, tokens=int(lengths[0]),
                   t_enc=int(tokens.shape[1]), steps=opts.steps,
                   **gaps(ref, got), loop_s=t1 - t0, kernel_s=t2 - t1)
        rows.append(row)
        print(f"[c3] {text!r} B=1 T_enc={row['t_enc']} bf16, "
              f"{row['n_frames'][0]} frames: JAX kernel (interpret) vs "
              f"while_loop: aligns {row['aligns']:.3e} of mean "
              f"{row['aligns_mean']:.3e} = share {row['aligns_share']:.3e}; "
              f"mels {row['mels']:.3e}, gates {row['gates']:.3e} "
              f"({row['loop_s']:.0f} s + {row['kernel_s']:.0f} s)",
              flush=True)
    worst = max(r["aligns_share"] for r in rows)
    print(f"[c3] largest alignment share over {len(rows)} sentences: "
          f"{worst:.3e} (the port's kernel vs its step loop on the card: "
          f"2.6e-2)")
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
