"""The trained acoustic model's weights for the reference, read from the
repository's Orbax checkpoint by the frozen reader beside this file.

The checkpoint stores the JAX layouts: linear weights ``(in, out)`` and LSTM
weights ``(in, 4H)``, transposed here to ``(out, in)`` and ``(4H, in)``; the
names are the program's state-dict keys, so both sides index one dict.
Every leaf is widened to float32, as the service serves it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .orbax_reader import as_float32, map_leaves, read_checkpoint


def _linear(jp, tn, bias=True):
    yield jp + ("w",), tn + ".weight", True
    if bias:
        yield jp + ("b",), tn + ".bias", False


def _conv(jp, tn, bias=True):
    yield jp + ("w",), tn + ".weight", False
    if bias:
        yield jp + ("b",), tn + ".bias", False


def _lstm(jp, tn):
    for j, t, tr in (("wi", "weight_ih", True), ("wh", "weight_hh", True),
                     ("bi", "bias_ih", False), ("bh", "bias_hh", False)):
        yield jp + (j,), f"{tn}.{t}", tr


def _bn(jp, sp, tn):
    yield jp + ("scale",), tn + ".weight", False
    yield jp + ("bias",), tn + ".bias", False
    yield sp + ("mean",), tn + ".running_mean", False
    yield sp + ("var",), tn + ".running_var", False


def pairs(cfg: dict) -> Iterator[Tuple[Tuple[Any, ...], str, bool]]:
    """(checkpoint path, state-dict key, transpose) for every tensor of a
    single-speaker model of ``cfg``."""
    p, s = ("params",), ("model_state",)
    enc = p + ("encoder",)
    yield enc + ("embedding", "table"), "encoder.embedding.weight", False
    for i in range(cfg["encoder_n_convolutions"]):
        yield from _conv(enc + ("convs", i), f"encoder.convs.{i}")
        yield from _bn(enc + ("bn", i), s + ("encoder", "bn", i),
                       f"encoder.bns.{i}")
    yield from _lstm(enc + ("bilstm", "fwd"), "encoder.lstm.fwd")
    yield from _lstm(enc + ("bilstm", "bwd"), "encoder.lstm.bwd")
    dec = p + ("decoder",)
    for i in range(2):
        yield from _linear(dec + ("prenet", i), f"decoder.prenet.{i}", False)
    att, ta = dec + ("attention",), "decoder.attention"
    yield from _linear(att + ("query",), ta + ".query_layer", False)
    yield from _linear(att + ("memory",), ta + ".memory_layer", False)
    yield from _conv(att + ("location_conv",), ta + ".location_conv", False)
    yield from _linear(att + ("location_dense",), ta + ".location_dense",
                       False)
    yield from _linear(att + ("v",), ta + ".v")
    yield att + ("energy_scale",), ta + ".energy_scale", False
    yield from _lstm(dec + ("attn_lstm",), "decoder.attention_lstm")
    yield from _lstm(dec + ("dec_lstm",), "decoder.decoder_lstm")
    yield from _linear(dec + ("proj",), "decoder.linear_projection")
    yield from _linear(dec + ("gate",), "decoder.gate_layer")
    post = p + ("postnet",)
    for i in range(cfg["postnet_n_convolutions"]):
        yield from _conv(post + ("convs", i), f"postnet.convs.{i}")
        yield from _bn(post + ("bn", i), s + ("postnet", "bn", i),
                       f"postnet.bns.{i}")


def load(path: str, cfg: dict, device) -> Dict[str, torch.Tensor]:
    tree = map_leaves(as_float32, read_checkpoint(path))
    out = {}
    for jp, key, transpose in pairs(cfg):
        leaf = tree
        for k in jp:
            leaf = leaf[k]
        a = np.asarray(leaf, np.float32)
        out[key] = torch.from_numpy((a.T if transpose else a).copy()).to(
            device)
    return out
