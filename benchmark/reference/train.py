"""The reference's first training steps: the plain model of ``model.py``
under ``torch.autograd``, its loss, clip and Adam, from the same seeded
weights, batches and dropout masks the program's first steps took.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.harness import weights as seeded
from benchmark.harness.training_data import (batch_order, dropout_masks,
                                             mask_seed, pad_batch)

from . import model as M


def param_shapes(m: dict) -> Dict[str, tuple]:
    """Names and shapes of Tacotron 2's tensors (parameters and BatchNorm
    statistics), under the program's state-dict names."""
    e, h, a = m["encoder_embedding_dim"], m["decoder_rnn_dim"], \
        m["attention_dim"]
    p, mels = m["prenet_dim"], m["n_mels"]
    s: Dict[str, tuple] = {"encoder.embedding.weight":
                           (m["n_symbols"], m["symbols_embedding_dim"])}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            s[f"{name}.{k}"] = (c,)

    def lstm(name, i, hid):
        s.update({f"{name}.weight_ih": (4 * hid, i),
                  f"{name}.weight_hh": (4 * hid, hid),
                  f"{name}.bias_ih": (4 * hid,), f"{name}.bias_hh": (4 * hid,)})

    for i in range(m["encoder_n_convolutions"]):
        s[f"encoder.convs.{i}.weight"] = (e, e, m["encoder_kernel_size"])
        s[f"encoder.convs.{i}.bias"] = (e,)
        bn(f"encoder.bns.{i}", e)
    lstm("encoder.lstm.fwd", e, e // 2)
    lstm("encoder.lstm.bwd", e, e // 2)
    s["decoder.prenet.0.weight"] = (p, mels)
    s["decoder.prenet.1.weight"] = (p, p)
    d = "decoder.attention"
    s[f"{d}.query_layer.weight"] = (a, m["attention_rnn_dim"])
    s[f"{d}.memory_layer.weight"] = (a, e)
    s[f"{d}.location_conv.weight"] = (m["location_n_filters"], 2,
                                      m["location_kernel_size"])
    s[f"{d}.location_dense.weight"] = (a, m["location_n_filters"])
    s[f"{d}.v.weight"] = (1, a)
    s[f"{d}.v.bias"] = (1,)
    s[f"{d}.energy_scale"] = ()
    lstm("decoder.attention_lstm", p + e, m["attention_rnn_dim"])
    lstm("decoder.decoder_lstm", m["attention_rnn_dim"] + e, h)
    s["decoder.linear_projection.weight"] = (mels, h + e)
    s["decoder.linear_projection.bias"] = (mels,)
    s["decoder.gate_layer.weight"] = (1, h + e)
    s["decoder.gate_layer.bias"] = (1,)
    n = m["postnet_n_convolutions"]
    c = m["postnet_embedding_dim"]
    dims = [mels] + [c] * (n - 1) + [mels]
    for i in range(n):
        s[f"postnet.convs.{i}.weight"] = (dims[i + 1], dims[i],
                                          m["postnet_kernel_size"])
        s[f"postnet.convs.{i}.bias"] = (dims[i + 1],)
        bn(f"postnet.bns.{i}", dims[i + 1])
    return s


def is_parameter(name: str) -> bool:
    return not name.endswith(("running_mean", "running_var"))


def follow(cfgj: dict, traffic: dict, examples, seed: int, device,
           precision: str = "float32", n_steps=None, log=print,
           keep_rows=None, remat: bool = False) -> Dict:
    """Losses of the first ``n_steps`` (default the traffic's
    ``check_steps``), the per-leaf norms of the first step's clipped
    gradient and of the parameters' change after the last, as Python
    floats by name.  ``examples`` are the pool's rows (``.text``,
    ``.mel``); TF32 is off.  ``keep_rows`` keeps only that many rows of
    each batch (a fault the check must catch: rows left out, the mean
    over the rest); ``remat`` recomputes each decoder step in the
    backward (``model.teacher_forced``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, tr = cfgj["model"], cfgj["train"]
    n_steps = traffic["check_steps"] if n_steps is None else n_steps
    q = M.rounding(precision)
    shapes = param_shapes(m)
    w = seeded.draw(shapes, seeded.tacotron2_rules(shapes, m), seed, device)
    params = {n: t for n, t in w.items() if is_parameter(n)}
    p0 = {n: t.clone() for n, t in params.items()}
    state: Dict = {}
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    for k in range(n_steps):
        rows = batch_order(len(examples), traffic["batch"], seed, k)
        rows = rows if keep_rows is None else rows[:keep_rows]
        b = pad_batch([examples[i].text for i in rows],
                      [examples[i].mel for i in rows],
                      traffic["text_pad_multiple"],
                      traffic["mel_pad_multiple"])
        b = {kk: torch.as_tensor(v).to(device) for kk, v in b.items()}
        masks = dropout_masks(m, b["text"].shape[0], b["mel"].shape[2],
                              mask_seed(seed, k), device)
        for t in params.values():
            t.requires_grad_(True)
        post, coarse, gates, aligns = M.teacher_forced(
            params, m, b["text"], b["text_lengths"], b["mel"], masks, q,
            remat)
        total = M.loss(post, coarse, gates, aligns, b["mel"],
                       b["mel_lengths"], b["text_lengths"], k,
                       cfgj["guided_attention"], tr["sigma_warmup_steps"])
        names = list(params)
        gs = torch.autograd.grad(total, [params[n] for n in names],
                                 allow_unused=True)
        grads = {n: torch.zeros_like(params[n]) if g is None else g.detach()
                 for n, g in zip(names, gs)}
        del post, coarse, gates, aligns, gs
        losses.append(float(total.detach()))
        with torch.no_grad():
            for t in params.values():
                t.requires_grad_(False)
            clipped = M.adam_step(params, grads, state, tr, k)
        if k == 0:
            grad_norms = {n: float(torch.linalg.vector_norm(g.double()))
                          for n, g in clipped.items()}
        log(f"reference step {k}: loss {losses[-1]!r}, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if torch.cuda.is_available() else
            f"reference step {k}: loss {losses[-1]!r}")
    change = {n: float(torch.linalg.vector_norm((params[n] - p0[n]).double()))
              for n in params}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
