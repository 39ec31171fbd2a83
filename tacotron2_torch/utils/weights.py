"""Weight bridge between the JAX package's pytrees and the port's modules.

``(params, state)`` are the JAX package's nested dicts and lists (numpy
or array leaves, as ``tacotron2_tpu.infer.synthesize.load_model`` returns
them), including ``params["speaker"]`` for multi-speaker models.  The JAX
package stores linear weights ``(in, out)`` and LSTM weights ``(in, 4H)``;
the port stores PyTorch's ``(out, in)`` and ``(4H, in)``, so those are
transposed.  Convolution, embedding and BatchNorm layouts are the same.

:func:`load_jax_hifigan_params` and :func:`export_jax_hifigan_params` do
the same for the HiFi-GAN generator's pytree
(``tacotron2_tpu/models/hifigan.py``), whose transposed convolutions are
stored flipped along the taps and as ``(out, in, k)`` for an lhs-dilated
convolution; ``ConvTranspose1d`` wants ``(in, out, k)``, unflipped.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from ..models.hifigan import HiFiGAN
from ..models.tacotron2 import Tacotron2

Path = Tuple[Any, ...]


def _linear(jp: Path, tn: str, bias: bool = True):
    yield jp + ("w",), tn + ".weight", True
    if bias:
        yield jp + ("b",), tn + ".bias", False


def _conv(jp: Path, tn: str, bias: bool = True):
    yield jp + ("w",), tn + ".weight", False
    if bias:
        yield jp + ("b",), tn + ".bias", False


def _lstm(jp: Path, tn: str):
    for j, t, tr in (("wi", "weight_ih", True), ("wh", "weight_hh", True),
                     ("bi", "bias_ih", False), ("bh", "bias_hh", False)):
        yield jp + (j,), f"{tn}.{t}", tr


def _bn(jp: Path, sp: Path, tn: str):
    yield jp + ("scale",), tn + ".weight", False
    yield jp + ("bias",), tn + ".bias", False
    yield sp + ("mean",), tn + ".running_mean", False
    yield sp + ("var",), tn + ".running_var", False


def _pairs(model: Tacotron2) -> Iterator[Tuple[Path, str, bool]]:
    """(JAX path, port state_dict key, transpose) for every tensor; paths
    start with "params" or "state"."""
    cfg = model.cfg
    p, s = ("params",), ("state",)
    enc = p + ("encoder",)
    yield enc + ("embedding", "table"), "encoder.embedding.weight", False
    for i in range(cfg.encoder_n_convolutions):
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
    for i in range(cfg.postnet_n_convolutions):
        yield from _conv(post + ("convs", i), f"postnet.convs.{i}")
        yield from _bn(post + ("bn", i), s + ("postnet", "bn", i),
                       f"postnet.bns.{i}")
    if cfg.n_speakers > 1:
        yield (p + ("speaker", "embedding", "table"),
               "speaker_embedding.weight", False)
        yield from _linear(p + ("speaker", "proj"), "speaker_proj", False)


def _get(tree: Any, path: Path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


@torch.no_grad()
def load_jax_params(model: Tacotron2, params: Dict[str, Any],
                    state: Dict[str, Any]) -> Tacotron2:
    """Fill ``model`` in place from the JAX package's ``(params, state)``.
    Each tensor keeps the model's dtype and device; shapes must match."""
    trees = {"params": params, "state": state}
    sd = model.state_dict()
    n = 0
    for path, key, transpose in _pairs(model):
        a = np.asarray(_get(trees[path[0]], path[1:])).astype(np.float32)
        if transpose:
            a = a.T
        dst = sd[key]
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{a.shape} does not fit {key} "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a.copy()))  # copy: C order, keeps 0-d
        n += 1
    if n != len(sd):
        raise ValueError(f"filled {n} of the model's {len(sd)} tensors")
    return model


def _set(tree: Dict[Any, Any], path: Path, value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _lists(tree: Any) -> Any:
    """Turn dicts keyed 0..n-1 into lists, as the JAX pytrees hold them."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _lists(v) for k, v in tree.items()}
    if all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def export_jax_grads(model: Tacotron2,
                     grads: Dict[str, torch.Tensor] = None) -> Dict[str, Any]:
    """The model's gradients laid out as the JAX package's parameter tree
    (fp32 numpy leaves), so that they compare with ``jax.grad`` leaf by
    leaf.  ``grads`` maps parameter names to gradients; where it is None
    each parameter's ``.grad`` is read.  A missing gradient is zero."""
    named = dict(model.named_parameters())
    tree: Dict[str, Any] = {}
    for path, key, transpose in _pairs(model):
        if path[0] != "params":
            continue
        g = named[key].grad if grads is None else grads.get(key)
        a = (np.zeros(tuple(named[key].shape), np.float32) if g is None
             else g.detach().float().cpu().numpy())
        _set(tree, path[1:], (a.T if transpose else a).copy())
    return _lists(tree)


def export_jax_params(model: Tacotron2
                      ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Inverse of :func:`load_jax_params`: the model's weights as the JAX
    package's ``(params, state)`` with fp32 numpy leaves."""
    trees: Dict[str, Any] = {"params": {}, "state": {}}
    sd = model.state_dict()
    for path, key, transpose in _pairs(model):
        a = sd[key].detach().float().cpu().numpy()
        _set(trees, path, (a.T if transpose else a).copy())
    return _lists(trees["params"]), _lists(trees["state"])


def _hifigan_pairs(model: HiFiGAN) -> Iterator[Tuple[Path, str, bool]]:
    """(JAX path, port state_dict key, transposed conv) for every tensor of
    the generator."""
    convs = [(("conv_pre",), "conv_pre", False)]
    convs += [(("ups", i), f"ups.{i}", True) for i in range(len(model.ups))]
    for i, block in enumerate(model.resblocks):
        for half in ("convs1", "convs2"):
            convs += [(("resblocks", i, half, j), f"resblocks.{i}.{half}.{j}",
                       False) for j in range(len(getattr(block, half)))]
    convs.append((("conv_post",), "conv_post", False))
    for path, name, transposed in convs:
        yield path + ("w",), name + ".weight", transposed
        yield path + ("b",), name + ".bias", False


@torch.no_grad()
def load_jax_hifigan_params(model: HiFiGAN, params: Dict[str, Any]
                            ) -> HiFiGAN:
    """Fill the generator in place from the JAX package's HiFi-GAN params
    pytree (numpy or array leaves).  Each tensor keeps the model's dtype
    and device; shapes must match."""
    sd = model.state_dict()
    n = 0
    for path, key, transposed in _hifigan_pairs(model):
        a = np.asarray(_get(params, path)).astype(np.float32)
        if transposed:      # (out, in, k) flipped -> (in, out, k)
            a = np.flip(a, -1).transpose(1, 0, 2)
        dst = sd[key]
        if tuple(a.shape) != tuple(dst.shape):
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{a.shape} does not fit {key} "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(a.copy()))
        n += 1
    if n != len(sd):
        raise ValueError(f"filled {n} of the generator's {len(sd)} tensors")
    return model


def export_jax_hifigan_params(model: HiFiGAN) -> Dict[str, Any]:
    """Inverse of :func:`load_jax_hifigan_params`: the generator's weights
    as the JAX package's params pytree with fp32 numpy leaves."""
    tree: Dict[str, Any] = {}
    sd = model.state_dict()
    for path, key, transposed in _hifigan_pairs(model):
        a = sd[key].detach().float().cpu().numpy()
        if transposed:      # (in, out, k) -> (out, in, k) flipped
            a = np.flip(a.transpose(1, 0, 2), -1)
        _set(tree, path, a.copy())
    return _lists(tree)
