"""What the BigVGAN cell's driver, its controls and its tests share: the
widths of the configuration, the seeded weights, and the judgement of a
run's kept batches.

The weights are the benchmark's own draw (``weights.draw``), on the card
from the seed: uniform in +-1/sqrt(in_channels * k) for every convolution's
weight and bias, and uniform in +-0.5 for each channel's log alpha and log
beta, the distributions of the program's ``bigvgan_init``.

The judgement is ``serving.judge``'s, with its vocoder stage
(``serving._vocode``) given the reference BigVGAN: every answering row of
each kept batch, on the masked buffer the program vocoded (each row's
frames past its stop at the log floor, the whole cut buffer, whose end the
generator's replicate pads and zero-padded convolutions see).  The judge
also logs the share of delivered samples at tanh's rails (|y| > 0.99),
where the check would be blind.
"""

from __future__ import annotations

from typing import Dict, Tuple
from unittest import mock

import torch

from benchmark.harness import serving
from benchmark.harness import weights as seeded
from benchmark.reference import bigvgan as R

WIDTHS = ("num_mels", "upsample_initial_channel", "upsample_rates",
          "upsample_kernel_sizes", "resblock_kernel_sizes",
          "resblock_dilation_sizes", "aa_ratio", "aa_taps", "aa_cutoff",
          "aa_half_width")
TUPLES = ("upsample_rates", "upsample_kernel_sizes",
          "resblock_kernel_sizes")


def widths(cfgj: dict) -> dict:
    """The ``bigvgan`` block's widths (not its notes), as
    ``BigVGANConfig`` holds them (tuples)."""
    h = {k: cfgj["bigvgan"][k] for k in WIDTHS}
    for k in TUPLES:
        h[k] = tuple(h[k])
    h["resblock_dilation_sizes"] = tuple(
        tuple(d) for d in h["resblock_dilation_sizes"])
    return h


def _rules(shapes: Dict[str, Tuple[int, ...]]) -> Dict[str, seeded.Rule]:
    rules: Dict[str, seeded.Rule] = {}
    for name in shapes:
        if name.endswith((".alpha", ".beta")):
            rules[name] = ("uniform", 0.5)
            continue
        layer = name.rsplit(".", 1)[0]
        w = shapes[layer + ".weight"]
        c_in = w[0] if layer.startswith("ups.") else w[1]
        rules[name] = ("uniform", (c_in * w[2]) ** -0.5)
    return rules


@torch.no_grad()
def weights(h: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict (NVIDIA's keys, weight norm folded) on ``device``,
    from ``seed``."""
    shapes = R.shapes(h)
    return seeded.draw(shapes, _rules(shapes), seed, device)


def vocoder(sd, h: dict, log=print):
    """A stand-in for ``serving._vocode``: the reference BigVGAN on the
    masked buffer of a recorded batch, its first ``n`` rows."""
    def vocode(bt, out, fe, n, hifi, audio, floor, q, device):
        mel = out.mel_postnet.float()
        s = mel.shape[1]
        valid = torch.arange(s, device=device)[None, :, None] < \
            torch.as_tensor(fe, device=device)[:, None, None]
        mel = torch.where(valid, mel, torch.full_like(mel, floor))
        wav = R.infer(sd, h, mel[:n].transpose(1, 2), q)
        hop = audio["hop_length"]
        rails = sum(int((wav[i, :int(fe[i]) * hop].abs() > 0.99).sum())
                    for i in range(n))
        total = sum(int(fe[i]) * hop for i in range(n))
        log(f"bigvgan: {rails} of {total} delivered samples at |y| > 0.99; "
            f"rms {float(wav.pow(2).mean().sqrt()):.6g}")
        return [wav[i] for i in range(n)]
    return vocode


def judge(batches, cfgj: dict, seed: int, device, log=print
          ) -> Dict[str, float]:
    """``serving.judge`` of the kept batches, ``pcm_gap`` from the
    reference BigVGAN drawn from ``seed``."""
    h = widths(cfgj)
    sd = weights(h, seed, device)
    with mock.patch.object(serving, "_vocode", vocoder(sd, h, log)):
        return serving.judge(batches, cfgj, seed, device, log)
