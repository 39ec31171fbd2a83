"""Kernel #2, the decode (``decoder_infer_mega`` in
``ops/decoder_megakernel.py``): the work one launch's inputs need.

``rows`` are the batch's rows as (text length, steps): a row needs the
steps up to its own stop (its ``frame_ends`` and the dropped first
frame), over its own tokens.  The kernel runs every row until the last
one stops, at the padded length; that surplus is left out, so it shows as
a lower share.  Operations: prenet and ``tacotron2.decoder_step`` a step.
Bytes: inputs and outputs once: the step weights with the prenet's;
memory, processed memory and mask; the frames, gate logits and alignments
of the steps.
"""

from __future__ import annotations

from . import tacotron2
from .decoder_train_fwd import Rows, step_weights


def ops(m: dict, rows: Rows) -> int:
    return sum(int(steps) * (tacotron2.prenet_frame(m)
                             + tacotron2.decoder_step(m, int(t_enc)))
               for t_enc, steps in rows)


def nbytes(m: dict, rows: Rows, dt: int) -> int:
    e, a = m["encoder_embedding_dim"], m["attention_dim"]
    weights = step_weights(m) + m["prenet_dim"] * (m["n_mels"]
                                                   + m["prenet_dim"])
    return weights * dt + sum(
        int(t) * (e * dt + a * 4 + 1) + int(s) * ((m["n_mels"] + 1) * 4
                                                 + int(t) * 4)
        for t, s in rows)
