"""Kernel #4, the reverse chain (``decoder_bwd_chain_mega`` in
``ops/decoder_bwd_kernel.py``): the work one launch's inputs need.

``rows`` as for kernel #3: (text length, mel frames) at the rows' true
lengths, padding left out.  Operations: the data-gradient chain of every
step, whose products are the forward step's products transposed
(``tacotron2.decoder_step`` over the row's tokens); the weight gradients
are products outside it.  Bytes: inputs and outputs once: the step
weights, memory and masks, the stored series it reads (pre-activations,
cell states, alignments, pre-tanh sums) and the upstream gradients; the
gate gradients, context, prenet, pre-tanh-sum and query gradients it
writes, and the per-row sums.
"""

from __future__ import annotations

from .decoder_train_fwd import Rows, ops, step_weights

__all__ = ["ops", "nbytes"]


def nbytes(m: dict, rows: Rows, cdt: int) -> int:
    e, h, a = m["encoder_embedding_dim"], m["decoder_rnn_dim"], \
        m["attention_dim"]

    def row(t_enc: int, t_dec: int) -> int:
        ins = (t_enc * e * cdt + 2 * t_dec * h
               + t_dec * (2 * 4 * h * cdt + 2 * h * 4 + t_enc * 4
                          + t_enc * a * cdt + (m["n_mels"] + 1) * 4
                          + t_enc * 4))
        outs = (t_dec * (2 * 4 * h * cdt + e * 4 + m["prenet_dim"] * 4
                         + t_enc * a * cdt + a * 4)
                + a * 4 + t_enc * a * 4)
        return ins + outs
    return step_weights(m) * cdt + sum(row(int(t), int(f)) for t, f in rows)
