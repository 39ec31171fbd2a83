"""Seeded weights, made on the card in two large draws.

The distributions are the program's initialisers (``init_weights``,
``hifigan_init``): uniform in +-1/sqrt(fan_in) for linear and convolution
weights and their biases, +-1/sqrt(H) for LSTM tensors, N(0, 1)
embeddings, identity BatchNorm, the gate bias and the energy scale at the
configuration's values.  The draw is the benchmark's own: one uniform and
one normal tensor from a ``torch.Generator`` on the card, cut by name in
sorted order, so that the program and the reference get the same tensors
from one seed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Rule = Tuple[str, float]   # ("uniform", bound) | ("normal", 1) | ("const", v)


def tacotron2_rules(shapes: Dict[str, Tuple[int, ...]], model: dict
                    ) -> Dict[str, Rule]:
    rules: Dict[str, Rule] = {}
    for name, shape in shapes.items():
        if ".bns." in name:
            const = 1.0 if name.endswith((".weight", ".running_var")) else 0.0
            rules[name] = ("const", const)
        elif name == "encoder.embedding.weight":
            rules[name] = ("normal", 1.0)
        elif name == "decoder.gate_layer.bias":
            rules[name] = ("const", model["gate_bias_init"])
        elif name == "decoder.attention.energy_scale":
            rules[name] = ("const", model["energy_scale_init"])
        elif name.rsplit(".", 1)[-1] in ("weight_ih", "weight_hh", "bias_ih",
                                         "bias_hh"):
            rules[name] = ("uniform", (shape[0] // 4) ** -0.5)
        else:
            w = shapes[name.rsplit(".", 1)[0] + ".weight"]
            fan_in = w[1] * (w[2] if len(w) == 3 else 1)
            rules[name] = ("uniform", fan_in ** -0.5)
    return rules


def hifigan_rules(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, Rule]:
    rules: Dict[str, Rule] = {}
    for name in shapes:
        layer = name.rsplit(".", 1)[0]
        w = shapes[layer + ".weight"]
        c_in = w[0] if layer.startswith("ups.") else w[1]
        rules[name] = ("uniform", (c_in * w[2]) ** -0.5)
    return rules


@torch.no_grad()
def draw(shapes: Dict[str, Tuple[int, ...]], rules: Dict[str, Rule],
         seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` by name, from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    names = sorted(shapes)
    numel = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    n_u = sum(numel[n] for n in names if rules[n][0] == "uniform")
    n_n = sum(numel[n] for n in names if rules[n][0] == "normal")
    uni = torch.rand(n_u, generator=gen, device=device).mul_(2).sub_(1)
    nor = torch.randn(max(n_n, 1), generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for n in names:
        kind, v = rules[n]
        k = numel[n]
        if kind == "uniform":
            t = uni[iu:iu + k] * v
            iu += k
        elif kind == "normal":
            t = nor[inn:inn + k] * v
            inn += k
        else:
            t = torch.full((k,), float(v), device=device)
        out[n] = t.reshape(shapes[n]).clone()
    return out
