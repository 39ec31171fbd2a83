"""Floating-point operations of Tacotron 2's layers, counted from the
configuration's widths (a multiply-add is two).  Elementwise work
(activations, the LSTM cell update, softmax) is left out: it is a few per
cent and no peak rate applies to it.
"""

from __future__ import annotations

from typing import Sequence


def lstm(inputs: int, hidden: int) -> int:
    return 2 * 4 * hidden * (inputs + hidden)


def decoder_step(m: dict, t_enc: int) -> int:
    """One decoder step of one row from its prenetted frame: attention
    LSTM, location-sensitive attention over ``t_enc`` positions (query,
    location conv and dense, energies, context), decoder LSTM, projection
    and gate."""
    e, h, a = m["encoder_embedding_dim"], m["decoder_rnn_dim"], \
        m["attention_dim"]
    f, k = m["location_n_filters"], m["location_kernel_size"]
    per_pos = 2 * 2 * f * k + 2 * f * a + 2 * a + 2 * e
    return (lstm(m["prenet_dim"] + e, m["attention_rnn_dim"])
            + 2 * m["attention_rnn_dim"] * a + per_pos * t_enc
            + lstm(m["attention_rnn_dim"] + e, h)
            + 2 * (m["n_mels"] + 1) * (h + e))


def prenet_frame(m: dict) -> int:
    p = m["prenet_dim"]
    return 2 * m["n_mels"] * p + 2 * p * p


def postnet_frame(m: dict) -> int:
    n, c, k = (m["postnet_n_convolutions"], m["postnet_embedding_dim"],
               m["postnet_kernel_size"])
    dims = [m["n_mels"]] + [c] * (n - 1) + [m["n_mels"]]
    return sum(2 * dims[i] * dims[i + 1] * k for i in range(n))


def encoder_token(m: dict) -> int:
    e = m["encoder_embedding_dim"]
    return (m["encoder_n_convolutions"] * 2 * e * e * m["encoder_kernel_size"]
            + 2 * lstm(e, e // 2) + 2 * e * m["attention_dim"])


def forward(m: dict, tokens: int, frames: int) -> int:
    """One row's forward at its true lengths (no padding)."""
    return (tokens * encoder_token(m)
            + frames * (prenet_frame(m) + decoder_step(m, tokens)
                        + postnet_frame(m)))


def train_step(m: dict, text_lengths: Sequence[int],
               mel_lengths: Sequence[int]) -> int:
    """Forward and backward of a batch at its rows' true lengths: three
    forwards (the backward's two products per forward product), no
    recompute."""
    return 3 * sum(forward(m, int(t), int(f))
                   for t, f in zip(text_lengths, mel_lengths))
