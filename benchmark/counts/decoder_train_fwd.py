"""Kernel #3, the teacher-forced decoder's forward (``decoder_fwd_train_mega``
in ``ops/decoder_train_kernel.py``): the work one launch's inputs need.

``rows`` are the batch's rows as (text length, mel frames), their true
lengths: the kernel also runs the padded positions and steps, which the
counts leave out, so padding shows as a lower share.  Operations: every
step of every row, ``tacotron2.decoder_step`` over the row's tokens.
Bytes: inputs and outputs once, at the compute dtype ``cdt`` where the
kernel keeps it: the step weights; memory, processed memory, mask and the
prenetted frames; the two dropout masks; the frames, alignments, hidden
and cell states, pre-tanh sums and both LSTMs' pre-activations.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from . import tacotron2

Rows = Iterable[Tuple[int, int]]


def step_weights(m: dict) -> int:
    e, h, a = m["encoder_embedding_dim"], m["decoder_rnn_dim"], \
        m["attention_dim"]
    ar = m["attention_rnn_dim"]
    return (4 * ar * (m["prenet_dim"] + e + ar) + 2 * 4 * ar
            + 4 * h * (ar + e + h) + 2 * 4 * h + (m["n_mels"] + 1) * (h + e)
            + a * ar + 2 * m["location_kernel_size"] * a + a + 1)


def ops(m: dict, rows: Rows) -> int:
    return sum(int(t_dec) * tacotron2.decoder_step(m, int(t_enc))
               for t_enc, t_dec in rows)


def nbytes(m: dict, rows: Rows, cdt: int) -> int:
    e, h, a = m["encoder_embedding_dim"], m["decoder_rnn_dim"], \
        m["attention_dim"]

    def row(t_enc: int, t_dec: int) -> int:
        ins = (t_enc * (e * cdt + a * 4 + 1)
               + t_dec * (m["prenet_dim"] * cdt + 2 * h))
        outs = t_dec * ((m["n_mels"] + 1) * 4 + t_enc * 4 + 2 * h * cdt
                        + 2 * h * 4 + t_enc * a * cdt + 2 * 4 * h * cdt)
        return ins + outs
    return step_weights(m) * cdt + sum(row(int(t), int(f)) for t, f in rows)
