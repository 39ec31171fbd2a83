"""The reference implementation's PyTorch checkpoints.

An own copy of ``params_from_torch_state_dict`` and of its inverse
``torch_state_dict_from_params`` from
``tacotron2_tpu/utils/torch_compat.py``: the reference's ``state_dict``
(``encoder.convolutions.N.0.weight``, ``encoder.lstm.weight_ih_l0``, ...)
becomes the JAX package's ``(params, state)`` tree of numpy arrays, which
``utils/weights.py::load_jax_params`` maps onto the port's model
(:func:`load_reference_state_dict`).  Layouts: Linear and LSTM weights are
transposed into the tree's ``(in, out)``; conv weights keep theirs;
BatchNorm running statistics go to ``state``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np

from ..config import ModelConfig


def _t(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a.T)


def _lstm(sd: Mapping[str, np.ndarray], prefix: str,
          suffix: str = "") -> Dict[str, np.ndarray]:
    return {
        "wi": _t(sd[f"{prefix}.weight_ih{suffix}"]),
        "wh": _t(sd[f"{prefix}.weight_hh{suffix}"]),
        "bi": sd[f"{prefix}.bias_ih{suffix}"],
        "bh": sd[f"{prefix}.bias_hh{suffix}"],
    }


def _linear(sd: Mapping[str, np.ndarray], prefix: str
            ) -> Dict[str, np.ndarray]:
    p = {"w": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _conv(sd: Mapping[str, np.ndarray], prefix: str
          ) -> Dict[str, np.ndarray]:
    p = {"w": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"]
    return p


def _bn(sd: Mapping[str, np.ndarray], prefix: str
        ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
            {"mean": sd[f"{prefix}.running_mean"],
             "var": sd[f"{prefix}.running_var"]})


def params_from_torch_state_dict(sd: Mapping[str, np.ndarray],
                                 cfg: ModelConfig
                                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Reference ``model_state_dict`` -> (params, state) trees."""
    sd = {k: np.asarray(v, dtype=np.float32) for k, v in sd.items()}

    enc_p: Dict[str, Any] = {
        "embedding": {"table": sd["encoder.embedding.weight"]},
        "convs": [], "bn": [],
        "bilstm": {"fwd": _lstm(sd, "encoder.lstm", "_l0"),
                   "bwd": _lstm(sd, "encoder.lstm", "_l0_reverse")},
    }
    enc_s: Dict[str, Any] = {"bn": []}
    for i in range(cfg.encoder_n_convolutions):
        enc_p["convs"].append(_conv(sd, f"encoder.convolutions.{i}.0"))
        bn_p, bn_s = _bn(sd, f"encoder.convolutions.{i}.1")
        enc_p["bn"].append(bn_p)
        enc_s["bn"].append(bn_s)

    dec_p: Dict[str, Any] = {
        "prenet": [_linear(sd, "decoder.prenet.layers.0"),
                   _linear(sd, "decoder.prenet.layers.1")],
        "attention": {
            "query": _linear(sd, "decoder.attention.query_layer"),
            "memory": _linear(sd, "decoder.attention.memory_layer"),
            "location_conv": _conv(sd, "decoder.attention.location_conv"),
            "location_dense": _linear(sd, "decoder.attention.location_dense"),
            "v": _linear(sd, "decoder.attention.v"),
            "energy_scale": sd["decoder.attention.energy_scale"].reshape(()),
        },
        "attn_lstm": _lstm(sd, "decoder.attention_lstm"),
        "dec_lstm": _lstm(sd, "decoder.decoder_lstm"),
        "proj": _linear(sd, "decoder.linear_projection"),
        "gate": _linear(sd, "decoder.gate_layer"),
    }

    post_p: Dict[str, Any] = {"convs": [], "bn": []}
    post_s: Dict[str, Any] = {"bn": []}
    for i in range(cfg.postnet_n_convolutions):
        post_p["convs"].append(_conv(sd, f"postnet.convolutions.{i}.0"))
        bn_p, bn_s = _bn(sd, f"postnet.convolutions.{i}.1")
        post_p["bn"].append(bn_p)
        post_s["bn"].append(bn_s)

    params = {"encoder": enc_p, "decoder": dec_p, "postnet": post_p}
    state = {"encoder": enc_s, "postnet": post_s}
    return params, state


def torch_state_dict_from_params(params: Dict[str, Any],
                                 state: Dict[str, Any],
                                 cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """(params, state) trees -> the reference's ``state_dict`` layout, the
    inverse of :func:`params_from_torch_state_dict` (no speaker tables: the
    reference has none)."""
    out: Dict[str, np.ndarray] = {}

    def put_linear(prefix, p):
        out[f"{prefix}.weight"] = _t(np.asarray(p["w"]))
        if "b" in p:
            out[f"{prefix}.bias"] = np.asarray(p["b"])

    def put_conv(prefix, p):
        out[f"{prefix}.weight"] = np.asarray(p["w"])
        if "b" in p:
            out[f"{prefix}.bias"] = np.asarray(p["b"])

    def put_bn(prefix, p, s):
        out[f"{prefix}.weight"] = np.asarray(p["scale"])
        out[f"{prefix}.bias"] = np.asarray(p["bias"])
        out[f"{prefix}.running_mean"] = np.asarray(s["mean"])
        out[f"{prefix}.running_var"] = np.asarray(s["var"])

    def put_lstm(prefix, p, suffix=""):
        out[f"{prefix}.weight_ih{suffix}"] = _t(np.asarray(p["wi"]))
        out[f"{prefix}.weight_hh{suffix}"] = _t(np.asarray(p["wh"]))
        out[f"{prefix}.bias_ih{suffix}"] = np.asarray(p["bi"])
        out[f"{prefix}.bias_hh{suffix}"] = np.asarray(p["bh"])

    enc_p, enc_s = params["encoder"], state["encoder"]
    out["encoder.embedding.weight"] = np.asarray(enc_p["embedding"]["table"])
    for i in range(cfg.encoder_n_convolutions):
        put_conv(f"encoder.convolutions.{i}.0", enc_p["convs"][i])
        put_bn(f"encoder.convolutions.{i}.1", enc_p["bn"][i],
               enc_s["bn"][i])
    put_lstm("encoder.lstm", enc_p["bilstm"]["fwd"], "_l0")
    put_lstm("encoder.lstm", enc_p["bilstm"]["bwd"], "_l0_reverse")

    dec = params["decoder"]
    put_linear("decoder.prenet.layers.0", dec["prenet"][0])
    put_linear("decoder.prenet.layers.1", dec["prenet"][1])
    att = dec["attention"]
    put_linear("decoder.attention.query_layer", att["query"])
    put_linear("decoder.attention.memory_layer", att["memory"])
    put_conv("decoder.attention.location_conv", att["location_conv"])
    put_linear("decoder.attention.location_dense", att["location_dense"])
    put_linear("decoder.attention.v", att["v"])
    out["decoder.attention.energy_scale"] = np.asarray(
        att["energy_scale"]).reshape(())
    put_lstm("decoder.attention_lstm", dec["attn_lstm"])
    put_lstm("decoder.decoder_lstm", dec["dec_lstm"])
    put_linear("decoder.linear_projection", dec["proj"])
    put_linear("decoder.gate_layer", dec["gate"])

    post_p, post_s = params["postnet"], state["postnet"]
    for i in range(cfg.postnet_n_convolutions):
        put_conv(f"postnet.convolutions.{i}.0", post_p["convs"][i])
        put_bn(f"postnet.convolutions.{i}.1", post_p["bn"][i],
               post_s["bn"][i])
    return out


def is_reference_state_dict(sd: Mapping[str, Any]) -> bool:
    """Whether ``sd`` has the reference's key layout."""
    return ("encoder.convolutions.0.0.weight" in sd
            and "decoder.prenet.layers.0.weight" in sd)


def load_reference_state_dict(model, sd: Mapping[str, Any]):
    """Fill the port's ``model`` in place from the reference's
    ``state_dict`` (tensors or arrays)."""
    from .weights import load_jax_params
    arrays = {k: (v.detach().float().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v)) for k, v in sd.items()}
    params, state = params_from_torch_state_dict(arrays, model.cfg)
    return load_jax_params(model, params, state)
