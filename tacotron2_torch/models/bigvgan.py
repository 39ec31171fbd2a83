"""BigVGAN, the anti-aliased GAN vocoder, behind Tacotron 2.

Lee, Ping, Ginsburg, Catanzaro and Yoon, *BigVGAN: A Universal Neural
Vocoder with Large-Scale Training* (arXiv:2206.04658), at the widths of
NVIDIA's ``configs/bigvgan_22khz_80band.json`` (112 M parameters; its
audio settings are the repository's ``AudioConfig``).  The module's
state-dict keys are NVIDIA's with weight norm folded: ``conv_pre``,
``ups.{i}.0``, ``resblocks.{3i+j}.convs1.{d}`` / ``.convs2.{d}``,
``resblocks.{3i+j}.activations.{m}.act.alpha`` / ``.beta``,
``activation_post.act.alpha`` / ``.beta``, ``conv_post``.  NVIDIA's
filter buffers (``*.upsample.filter``, ``*.downsample.lowpass.filter``)
are all the one filter below: the loader checks them and does not keep
them.

Equations, mel (B, 80, T) -> waveform (B, T * 256):

* ``x = conv_pre(mel)`` (80 -> 1536, 7 taps); for each stage i (rates
  4, 4, 2, 2, 2, 2; kernels 8, 8, 4, 4, 4, 4), with C the channels so far:
  ``x = ups[i](x)`` (transposed conv C -> C / 2, stride u_i, padding
  (k_i - u_i) / 2, no activation before it), then ``x`` is the mean of the
  three AMP blocks of kernels 3, 7, 11; after the last stage ``y =
  tanh(conv_post(A_post(x)))`` (24 -> 1, 7 taps, with its bias).
* AMP block (kernel k, dilations 1, 3, 5): for each d, ``xt =
  convs2[d](A_{2m+1}(convs1[d](A_{2m}(x))))`` and ``x = x + xt``, where
  ``convs1[d]`` is dilated by d (padding (k d - d) / 2) and ``convs2[d]``
  is not: six activations a block, each with its own alpha and beta.
* ``A``, the anti-aliased SnakeBeta of :func:`anti_aliased_snake_beta`, on
  (B, C, T): ``u = 2 conv_transpose1d(pad_replicate(x, 5, 5), f, stride
  2, groups C)[..., 15:-15]`` (B, C, 2T); ``s = u + sin(exp(alpha_c) u)^2
  / (exp(beta_c) + 1e-9)``; ``y = conv1d(pad_replicate(s, 5, 6), f,
  stride 2, groups C)`` (B, C, T).
* ``f``, :func:`kaiser_sinc_filter`: 12 taps of a Kaiser-windowed sinc,
  cutoff 0.25 and half-width 0.3 of the doubled rate, summing to 1.

The convolutions run in the weights' type; fp32 weights on the card run
in TF32, cuDNN's default, as HiFi-GAN's do.  The activation is plain
PyTorch here (pads, two grouped convolutions, the snake's elementwise
passes).  The tracer's span ``bigvgan.act`` holds each activation, the
counters ``bigvgan.acts`` and ``bigvgan.act_elems`` count them and the
elements of their inputs (B C T each).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .hifigan import _denorm, _numpy


@dataclasses.dataclass(frozen=True)
class BigVGANConfig:
    """NVIDIA's ``bigvgan_22khz_80band.json`` (SnakeBeta with log-scale
    alpha and beta)."""
    num_mels: int = 80
    upsample_initial_channel: int = 1536
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    aa_ratio: int = 2
    aa_taps: int = 12
    aa_cutoff: float = 0.25
    aa_half_width: float = 0.3


def kaiser_sinc_filter(cutoff: float = 0.25, half_width: float = 0.3,
                       taps: int = 12) -> torch.Tensor:
    """The anti-aliasing low-pass, (taps,) float32: a Kaiser window of
    Kaiser's beta ``0.1102 (A - 8.7)`` for the attenuation ``A = 2.285
    (taps / 2 - 1) pi (4 half_width) + 7.95`` (the formula for A > 50)
    times ``2 cutoff sinc(2 cutoff t)`` at the taps' centres t,
    normalised to sum to 1."""
    a = 2.285 * (taps // 2 - 1) * math.pi * (4 * half_width) + 7.95
    if a <= 50.0:
        raise ValueError(f"attenuation {a:.2f} dB: Kaiser's beta for "
                         "A <= 50 is not this filter's")
    window = torch.kaiser_window(taps, periodic=False, beta=0.1102 * (a - 8.7),
                                 dtype=torch.float64, device="cpu")
    t = torch.arange(taps, dtype=torch.float64, device="cpu") - (taps - 1) / 2
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return (f / f.sum()).float()


def anti_aliased_snake_beta(x: torch.Tensor, log_alpha: torch.Tensor,
                            log_beta: torch.Tensor, filt: torch.Tensor,
                            ratio: int = 2) -> torch.Tensor:
    """SnakeBeta at ``ratio`` times the rate of ``x`` (B, C, T): upsample
    by the transposed low-pass ``filt`` (taps,), the snake with the
    channels' ``exp(log_alpha)`` and ``exp(log_beta)``, downsample by the
    same low-pass; replicate padding at both filters' edges.  (B, C, T)
    in the type of ``x``."""
    c, taps = x.shape[1], filt.shape[-1]
    w = filt.to(x.dtype).view(1, 1, taps).expand(c, 1, taps)
    pad = taps // ratio - 1
    left = pad * ratio + (taps - ratio) // 2
    right = pad * ratio + (taps - ratio + 1) // 2
    u = ratio * F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"),
                                   w, stride=ratio, groups=c)
    u = u[..., left:u.shape[-1] - right]
    alpha = log_alpha.exp().to(x.dtype)[None, :, None]
    beta = log_beta.exp().to(x.dtype)[None, :, None]
    s = u + (1.0 / (beta + 1e-9)) * torch.sin(u * alpha).pow(2)
    s = F.pad(s, (taps // 2 - 1, taps // 2), mode="replicate")
    return F.conv1d(s, w, stride=ratio, groups=c)


class SnakeBeta(nn.Module):
    """A channel's log-scale alpha and beta (NVIDIA's ``act``)."""

    def __init__(self, ch: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(ch))
        self.beta = nn.Parameter(torch.zeros(ch))


class Activation1d(nn.Module):
    """NVIDIA's anti-aliased activation wrapper: its snake is ``act``."""

    def __init__(self, ch: int):
        super().__init__()
        self.act = SnakeBeta(ch)


class AMPBlock(nn.Module):
    """One MRF branch: per dilation, A -> dilated conv -> A -> conv,
    added to the input."""

    def __init__(self, ch: int, k: int, dilations: Tuple[int, ...]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(ch, ch, k, dilation=d, padding=(k * d - d) // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(ch, ch, k, padding=(k - 1) // 2) for _ in dilations)
        self.activations = nn.ModuleList(
            Activation1d(ch) for _ in range(2 * len(dilations)))


class BigVGAN(nn.Module):
    """The generator; ``forward`` is :func:`bigvgan_apply`."""

    def __init__(self, cfg: BigVGANConfig = BigVGANConfig()):
        super().__init__()
        self.cfg = cfg
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
            self.ups.append(nn.ModuleList([nn.ConvTranspose1d(
                ch, ch // 2, k, stride=u, padding=(k - u) // 2)]))
            ch //= 2
            for rk, dils in zip(cfg.resblock_kernel_sizes,
                                cfg.resblock_dilation_sizes):
                self.resblocks.append(AMPBlock(ch, rk, tuple(dils)))
        self.activation_post = Activation1d(ch)
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        # one filter for every up- and downsampler, on the default device
        self.register_buffer(
            "aa_filter", kaiser_sinc_filter(cfg.aa_cutoff, cfg.aa_half_width,
                                            cfg.aa_taps)
            .to(torch.empty(0).device), persistent=False)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return bigvgan_apply(self, mel)


def _activation(act: Activation1d, x: torch.Tensor, filt: torch.Tensor,
                ratio: int) -> torch.Tensor:
    with span("bigvgan.act"):
        count("bigvgan.acts")
        count("bigvgan.act_elems", x.numel())
        return anti_aliased_snake_beta(x, act.act.alpha, act.act.beta, filt,
                                       ratio)


def _amp_block(block: AMPBlock, x: torch.Tensor, filt: torch.Tensor,
               ratio: int) -> torch.Tensor:
    acts = block.activations
    for d, (c1, c2) in enumerate(zip(block.convs1, block.convs2)):
        xt = c1(_activation(acts[2 * d], x, filt, ratio))
        xt = c2(_activation(acts[2 * d + 1], xt, filt, ratio))
        x = x + xt
    return x


@torch.no_grad()
def bigvgan_apply(model: BigVGAN, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T) on the generator's device -> waveform (B, T * 256),
    float32 in [-1, 1].  Runs in the weight dtype (the input is cast to
    it)."""
    cfg = model.cfg
    filt, ratio = model.aa_filter, cfg.aa_ratio
    x = model.conv_pre(mel.to(model.conv_pre.weight.dtype))
    n = len(cfg.resblock_kernel_sizes)
    for i, up in enumerate(model.ups):
        x = up[0](x)
        acc = None
        for j in range(n):
            y = _amp_block(model.resblocks[i * n + j], x, filt, ratio)
            acc = y if acc is None else acc + y
        x = acc / n
    x = model.conv_post(_activation(model.activation_post, x, filt, ratio))
    return torch.tanh(x).float()[:, 0, :]


@torch.no_grad()
def bigvgan_init(seed: int, cfg: BigVGANConfig = BigVGANConfig()
                 ) -> BigVGAN:
    """A generator with fp32 weights drawn on the CPU from ``seed``: every
    convolution's weight and bias uniform in +-1/sqrt(in_channels * k), as
    ``hifigan_init`` draws them, and each channel's log alpha and log beta
    uniform in +-0.5 (NVIDIA starts both at 0, where a swap of the two
    would not show)."""
    gen = torch.Generator().manual_seed(seed)
    model = BigVGAN(cfg)

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            bound = 1.0 / (m.in_channels * m.kernel_size[0]) ** 0.5
            uniform(m.weight, bound)
            uniform(m.bias, bound)
        elif isinstance(m, SnakeBeta):
            uniform(m.alpha, 0.5)
            uniform(m.beta, 0.5)
    return model


def _receptive_span(cfg: BigVGANConfig) -> Tuple[int, int]:
    """The output samples (first, last) that mel frame 0 reaches, in the
    interior (the replicate pads only matter at the buffer's ends): each
    layer's reach on the index it maps to, exactly."""
    r, taps = cfg.aa_ratio, cfg.aa_taps
    pad = taps // r - 1
    left = pad * r + (taps - r) // 2

    def conv(lo, hi, k, d=1):
        h = (k - 1) * d // 2
        return lo - h, hi + h

    def act(lo, hi):
        # up: sample i reaches (i + pad) r + j - left, j in [0, taps)
        lo, hi = (lo + pad) * r - left, (hi + pad) * r + taps - 1 - left
        # down: s[q] reaches m with r m - (taps / 2 - 1) + j = q
        return (-(-(lo - taps + 1 + taps // 2 - 1) // r),
                (hi + taps // 2 - 1) // r)

    lo, hi = conv(0, 0, 7)
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        p = (k - u) // 2
        lo, hi = lo * u - p, hi * u - p + k - 1
        blo, bhi = lo, hi
        for rk, dils in zip(cfg.resblock_kernel_sizes,
                            cfg.resblock_dilation_sizes):
            xlo, xhi = lo, hi
            for d in dils:
                tlo, thi = conv(*act(*conv(*act(xlo, xhi), rk, d)), rk)
                xlo, xhi = min(xlo, tlo), max(xhi, thi)
            blo, bhi = min(blo, xlo), max(bhi, xhi)
        lo, hi = blo, bhi
    return conv(*act(lo, hi), 7)


def receptive_frames(cfg: BigVGANConfig = BigVGANConfig()) -> int:
    """The generator's receptive radius in mel frames: how far past its
    own samples a frame reaches, rounded up, on the wider side."""
    lo, hi = _receptive_span(cfg)
    hop = int(np.prod(cfg.upsample_rates))
    return max(-(-(-lo) // hop), -(-(hi - hop + 1) // hop))


# The published generator's radius (38 frames): past
# ``infer/fused.py::TRIM_MARGIN``, as WaveGlow's is.
RECEPTIVE_FRAMES = receptive_frames()


# ---------------------------------------------------------------------------
# NVIDIA checkpoint conversion
# ---------------------------------------------------------------------------
def _convs(model: BigVGAN):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))]


@torch.no_grad()
def params_from_nvidia_state_dict(sd: Mapping[str, object]) -> BigVGAN:
    """NVIDIA's generator state dict (tensors or arrays, weight-normed or
    not) -> a generator on the CPU, fp32.  ``num_mels`` and
    ``upsample_initial_channel`` are read from ``conv_pre``'s shape, the
    rest is the published configuration; every filter buffer must be the
    configuration's filter."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    if "conv_pre.weight" in sd:
        pre = sd["conv_pre.weight"].shape
    else:
        pre = sd["conv_pre.weight_v"].shape
    model = BigVGAN(BigVGANConfig(num_mels=int(pre[1]),
                                  upsample_initial_channel=int(pre[0])))
    filt = model.aa_filter.numpy()
    for k, v in sd.items():
        if k.endswith(".filter") and not np.allclose(
                np.asarray(v, np.float32).reshape(-1), filt, atol=1e-6):
            raise ValueError(f"{k} is not the 12-tap Kaiser-sinc low-pass")
    resolved = {}
    for name, _ in _convs(model):
        resolved[f"{name}.weight"] = torch.from_numpy(_denorm(sd, name))
        resolved[f"{name}.bias"] = torch.from_numpy(
            np.asarray(sd[f"{name}.bias"], np.float32))
    for name, _ in model.named_parameters():
        if name.endswith((".alpha", ".beta")):
            resolved[name] = torch.from_numpy(
                np.asarray(sd[name], np.float32))
    model.load_state_dict(resolved, strict=True)
    return model


@torch.no_grad()
def nvidia_state_dict(model: BigVGAN, weight_norm: bool = True) -> dict:
    """The inverse of :func:`params_from_nvidia_state_dict`: the
    generator's state dict on the CPU as NVIDIA's file holds it, the
    filter buffers included; with ``weight_norm`` every conv weight split
    as ``nn.utils.weight_norm`` splits it at dim 0."""
    sd = {k: v.detach().cpu().float().clone()
          for k, v in model.state_dict().items()}
    filt = model.aa_filter.detach().cpu().float().view(1, 1, -1)
    for name, m in model.named_modules():
        if isinstance(m, Activation1d):
            sd[f"{name}.upsample.filter"] = filt.clone()
            sd[f"{name}.downsample.lowpass.filter"] = filt.clone()
    if not weight_norm:
        return sd
    for name, _ in _convs(model):
        w = sd.pop(f"{name}.weight")
        sd[f"{name}.weight_g"] = torch.linalg.vector_norm(
            w, dim=tuple(range(1, w.ndim)), keepdim=True)
        sd[f"{name}.weight_v"] = w
    return sd


def _checkpoint_path(checkpoint_path: Optional[str]) -> str:
    path = (checkpoint_path or os.environ.get("BIGVGAN_CHECKPOINT")
            or "bigvgan_generator.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"BigVGAN checkpoint not found at {path!r}; set "
            "BIGVGAN_CHECKPOINT or pass --vocoder griffinlim")
    return path


def load_bigvgan_params(checkpoint_path: Optional[str] = None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> BigVGAN:
    """NVIDIA's generator file as a generator on ``device``, fp32.

    The file: the argument, else ``$BIGVGAN_CHECKPOINT``, else
    ``./bigvgan_generator.pt`` (NVIDIA's name for it); ``{"generator":
    state_dict}`` or the state dict itself.  It is the user's own file,
    unpickled whole as the other vocoders' are."""
    device = resolve_device(device)
    ckpt = torch.load(_checkpoint_path(checkpoint_path), map_location="cpu",
                      weights_only=False)
    sd = ckpt.get("generator", ckpt)
    return params_from_nvidia_state_dict(sd).to(device)
