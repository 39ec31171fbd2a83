"""What the WaveGlow cell's driver, its controls and its tests share: the
widths of the configuration, the seeded weights, and the judgement of a
run's kept batches.

The weights are the benchmark's own draw (``weights.draw``), on the card
from the seed: uniform in +-1/sqrt(in_channels * k) for every convolution's
weight and bias, the distribution of the program's ``waveglow_init``
(``end`` drawn too, not zeroed), and each W the Q of a normal matrix's QR,
its first column negated where its determinant is -1 (as ``glow.py``), the
QR taken on the host.

The judgement is ``serving.judge``'s, with its vocoder stage
(``serving._vocode``) given the reference WaveGlow for the call: every
answering row of each kept batch, on the masked buffer the program vocoded
(each row's frames past its stop at the log floor, the whole cut buffer),
from the seed-0 noise drawn for that buffer's shape on the same device.
"""

from __future__ import annotations

from typing import Dict, Tuple
from unittest import mock

import torch

from benchmark.harness import serving
from benchmark.harness import weights as seeded
from benchmark.reference import waveglow as R

WIDTHS = ("n_mel_channels", "n_flows", "n_group", "n_early_every",
          "n_early_size", "n_layers", "n_channels", "kernel_size",
          "upsample_kernel", "upsample_stride", "sigma")
NOISE_SEED = 0


def widths(cfgj: dict) -> dict:
    """The ``waveglow`` block's widths and sigma (not its notes)."""
    return {k: cfgj["waveglow"][k] for k in WIDTHS}


def _rules(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, seeded.Rule]:
    rules: Dict[str, seeded.Rule] = {}
    for name in shapes:
        if name.startswith("convinv."):
            rules[name] = ("normal", 1.0)
            continue
        layer = name.rsplit(".", 1)[0]
        w = shapes[layer + ".weight"]
        c_in = w[0] if layer == "upsample" else w[1]
        rules[name] = ("uniform", (c_in * w[2]) ** -0.5)
    return rules


@torch.no_grad()
def weights(w: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (``glow.py``'s keys, weight norm folded) on
    ``device``, from ``seed``."""
    shapes = R.shapes(w)
    sd = seeded.draw(shapes, _rules(shapes), seed, device)
    for name in shapes:
        if name.startswith("convinv."):
            q = torch.linalg.qr(sd[name][:, :, 0].cpu())[0]
            if torch.det(q) < 0:
                q[:, 0] = -q[:, 0]
            sd[name] = q[:, :, None].to(device)
    return sd


def vocoder(sd, w: dict):
    """A stand-in for ``serving._vocode``: the reference WaveGlow on the
    masked buffer of a recorded batch, its first ``n`` rows, with the
    seed-0 noise drawn for the whole buffer."""
    def vocode(bt, out, fe, n, hifi, audio, floor, q, device):
        mel = out.mel_postnet.float()
        b, s = mel.shape[:2]
        valid = torch.arange(s, device=device)[None, :, None] < \
            torch.as_tensor(fe, device=device)[:, None, None]
        mel = torch.where(valid, mel, torch.full_like(mel, floor))
        groups = s * w["upsample_stride"] // w["n_group"]
        z = R.noise(b, groups, w, NOISE_SEED, device)
        wav = R.infer(sd, w, mel[:n].transpose(1, 2), z[:n], w["sigma"], q)
        return [wav[i] for i in range(n)]
    return vocode


def judge(batches, cfgj: dict, seed: int, device, log=print
          ) -> Dict[str, float]:
    """``serving.judge`` of the kept batches, ``pcm_gap`` from the
    reference WaveGlow drawn from ``seed``."""
    w = widths(cfgj)
    sd = weights(w, seed, device)
    with mock.patch.object(serving, "_vocode", vocoder(sd, w)):
        return serving.judge(batches, cfgj, seed, device, log)
