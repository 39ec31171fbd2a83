"""Plain BigVGAN for the reference (Lee et al., arXiv:2206.04658, at the
widths of NVIDIA's ``configs/bigvgan_22khz_80band.json``): mel -> waveform
over a state dict of NVIDIA's keys with weight norm folded (``conv_pre``,
``ups.{i}.0``, ``resblocks.{n}.convs1.{d}``, ``.convs2.{d}``,
``.activations.{m}.act.alpha`` / ``.beta``, ``activation_post.act.*``,
``conv_post``), in plain fp32 ``torch``.  Products read their inputs
through the rounding ``q`` of ``model.rounding``; the caller turns TF32 off
(``torch.backends.cudnn.allow_tf32``), as ``serving.judge`` does.

Widths ``h`` are the configuration file's ``bigvgan`` block.  The
anti-aliasing filter is built here from its formula in float64 numpy
(``np.kaiser``, ``np.sinc``).  The activation is written out: replicate
padding by edge copies; the upsampler as the zero-stuffed signal (x at the
even samples) convolved with the filter, times the ratio, cut by 15
samples a side; SnakeBeta with ``exp`` of the stored alpha and beta; the
downsampler as every second output of the filter over the padded signal.
These are NVIDIA's ``UpSample1d`` (a grouped transposed convolution),
``SnakeBeta`` (``alpha_logscale``) and ``DownSample1d`` by other
operations; no departure from NVIDIA's arithmetic.  Rows are computed in
blocks of ``rows``, so that a checked batch fits beside the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import Round, rounding


def lowpass(h: dict) -> torch.Tensor:
    """The 12-tap Kaiser-windowed sinc (cutoff 0.25, half-width 0.3 of the
    doubled rate), summing to 1, float32."""
    taps, cutoff = h["aa_taps"], h["aa_cutoff"]
    a = 2.285 * (taps // 2 - 1) * np.pi * 4 * h["aa_half_width"] + 7.95
    assert a > 50, "Kaiser's beta below is the formula for A > 50"
    t = np.arange(taps) - (taps - 1) / 2
    f = 2 * cutoff * np.kaiser(taps, 0.1102 * (a - 8.7)) \
        * np.sinc(2 * cutoff * t)
    return torch.from_numpy((f / f.sum()).astype(np.float32))


def shapes(h: dict) -> Dict[str, Tuple[int, ...]]:
    """Every tensor of the state dict by name."""
    ch, m = h["upsample_initial_channel"], h["num_mels"]
    out = {"conv_pre.weight": (ch, m, 7), "conv_pre.bias": (ch,)}
    n = 0
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        out[f"ups.{i}.0.weight"] = (ch, ch // 2, k)
        out[f"ups.{i}.0.bias"] = (ch // 2,)
        ch //= 2
        for rk, dils in zip(h["resblock_kernel_sizes"],
                            h["resblock_dilation_sizes"]):
            p = f"resblocks.{n}"
            for d in range(len(dils)):
                for c in ("convs1", "convs2"):
                    out[f"{p}.{c}.{d}.weight"] = (ch, ch, rk)
                    out[f"{p}.{c}.{d}.bias"] = (ch,)
            for a in range(2 * len(dils)):
                out[f"{p}.activations.{a}.act.alpha"] = (ch,)
                out[f"{p}.activations.{a}.act.beta"] = (ch,)
            n += 1
    out["activation_post.act.alpha"] = out["activation_post.act.beta"] = \
        (ch,)
    out["conv_post.weight"], out["conv_post.bias"] = (1, ch, 7), (1,)
    return out


def replicate_pad(x, left: int, right: int):
    """``x`` (B, C, T) with its first sample copied ``left`` times in
    front and its last ``right`` times behind."""
    b, c, _ = x.shape
    return torch.cat([x[..., :1].expand(b, c, left), x,
                      x[..., -1:].expand(b, c, right)], dim=-1)


def activation(x, alpha, beta, f, ratio: int):
    """Anti-aliased SnakeBeta of ``x`` (B, C, T) -> (B, C, T)."""
    b, c, t = x.shape
    taps = f.shape[0]
    pad = taps // ratio - 1
    xp = replicate_pad(x, pad, pad)
    z = xp.new_zeros(b, c, ratio * xp.shape[-1] - (ratio - 1))
    z[..., ::ratio] = xp
    w = f.to(x.device).flip(0).view(1, 1, taps).expand(c, 1, taps)
    u = ratio * F.conv1d(F.pad(z, (taps - 1, taps - 1)), w, groups=c)
    cut = pad * ratio + (taps - ratio) // 2
    u = u[..., cut:cut + ratio * t]
    s = u + torch.sin(torch.exp(alpha)[None, :, None] * u) ** 2 \
        / (torch.exp(beta)[None, :, None] + 1e-9)
    s = replicate_pad(s, taps // 2 - 1, taps // 2)
    down = f.to(x.device).view(1, 1, taps).expand(c, 1, taps)
    return F.conv1d(s, down, groups=c)[..., ::ratio]


def _conv(sd, name, x, q: Round, dilation: int = 1):
    w = sd[name + ".weight"]
    k = w.shape[-1]
    return F.conv1d(q(x), q(w), sd[name + ".bias"].float(),
                    dilation=dilation, padding=(k - 1) * dilation // 2)


def _act(sd, name, x, f, h):
    return activation(x, sd[name + ".act.alpha"].float(),
                      sd[name + ".act.beta"].float(), f, h["aa_ratio"])


def amp_block(sd, p: str, x, dils, f, h, q: Round):
    """One AMP block: per dilation d, A, the dilated conv, A, the conv,
    added to ``x``."""
    for i, d in enumerate(dils):
        t = _conv(sd, f"{p}.convs1.{i}", _act(sd, f"{p}.activations.{2 * i}",
                                             x, f, h), q, d)
        t = _conv(sd, f"{p}.convs2.{i}",
                  _act(sd, f"{p}.activations.{2 * i + 1}", t, f, h), q)
        x = x + t
    return x


def mrf(sd, stage: int, x, f, h, q: Round):
    """The mean of stage ``stage``'s AMP blocks on ``x``."""
    n = len(h["resblock_kernel_sizes"])
    total = 0.0
    for j, dils in enumerate(h["resblock_dilation_sizes"]):
        total = total + amp_block(sd, f"resblocks.{stage * n + j}", x, dils,
                                  f, h, q)
    return total / n


def _rows(sd, h: dict, mel, f, q: Round):
    x = _conv(sd, "conv_pre", mel, q)
    for i, (u, k) in enumerate(zip(h["upsample_rates"],
                                   h["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(q(x), q(sd[f"ups.{i}.0.weight"]),
                               sd[f"ups.{i}.0.bias"].float(), stride=u,
                               padding=(k - u) // 2)
        x = mrf(sd, i, x, f, h, q)
    x = _act(sd, "activation_post", x, f, h)
    return torch.tanh(_conv(sd, "conv_post", x, q))[:, 0]


@torch.no_grad()
def infer(sd, h: dict, mel, q: Round = rounding("float32"),
          rows: int = 4) -> torch.Tensor:
    """mel (B, num_mels, T) -> waveform (B, T * prod(upsample_rates)),
    ``rows`` rows at a time."""
    f = lowpass(h).to(mel.device)
    return torch.cat([_rows(sd, h, mel[i:i + rows].float(), f, q)
                      for i in range(0, mel.shape[0], rows)])
