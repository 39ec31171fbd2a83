"""HiFi-GAN generator (v1), the neural vocoder.

Counterpart of ``tacotron2_tpu/models/hifigan.py``: the generator
architecture of NVIDIA's LJSpeech 22 kHz model (arXiv:2010.05646, config
v1) as an ``nn.Module`` whose state-dict keys are NVIDIA's (``conv_pre``,
``ups.{i}``, ``resblocks.{i}.convs1/2.{j}``, ``conv_post``):

  * conv_pre 80 -> 512 (k=7),
  * 4 transposed-conv upsampling stages (rates 8,8,2,2 / kernels 16,16,4,4),
    halving channels each stage,
  * after each stage a multi-receptive-field fusion (MRF) of 3 residual
    blocks (kernels 3,7,11; dilations (1,3,5) with interleaved unit-dilation
    convs), averaged,
  * conv_post -> 1 channel, tanh; LeakyReLU(0.1) activations.

Its convolutions are ``F.conv1d`` / ``F.conv_transpose1d`` (cuDNN on the
card), as the JAX package leaves them to XLA outside any Pallas kernel.
A converter reads the NGC checkpoint's ``generator`` state dict
(weight-normed or not); with no network the file must be local
(``HIFIGAN_CHECKPOINT`` or ``./hifigan_checkpoint.pt``).
"""

from __future__ import annotations

import copy
import os
from typing import Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device

LRELU_SLOPE = 0.1

# HiFi-GAN v1 (the config used by NVIDIA's LJSpeech 22 kHz models)
N_MELS = 80
UPSAMPLE_RATES = (8, 8, 2, 2)
UPSAMPLE_KERNELS = (16, 16, 4, 4)
UPSAMPLE_INITIAL_CHANNEL = 512
RESBLOCK_KERNELS = (3, 7, 11)
RESBLOCK_DILATIONS = ((1, 3, 5), (1, 3, 5), (1, 3, 5))

# Total upsampling factor: one mel frame -> this many output samples.
TOTAL_UPSAMPLE = int(np.prod(UPSAMPLE_RATES))

# Receptive radius of the generator in INPUT mel frames (analytic bound
# ~13.3; 16 gives margin).  The chunked apply is exact when overlap >= this.
RECEPTIVE_FRAMES = 16


class ResBlock(nn.Module):
    """One MRF branch: per dilation, lrelu -> dilated conv -> lrelu -> conv,
    added to the input."""

    def __init__(self, ch: int, k: int, dilations: Sequence[int]):
        super().__init__()
        self.convs1 = nn.ModuleList(
            nn.Conv1d(ch, ch, k, dilation=d, padding=(k - 1) * d // 2)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            nn.Conv1d(ch, ch, k, padding=(k - 1) // 2) for _ in dilations)


class HiFiGAN(nn.Module):
    """The v1 generator; ``forward`` is :func:`hifigan_apply`."""

    def __init__(self):
        super().__init__()
        ch = UPSAMPLE_INITIAL_CHANNEL
        self.conv_pre = nn.Conv1d(N_MELS, ch, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for u, k in zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS):
            self.ups.append(nn.ConvTranspose1d(ch, ch // 2, k, stride=u,
                                               padding=(k - u) // 2))
            ch //= 2
            for rk, dils in zip(RESBLOCK_KERNELS, RESBLOCK_DILATIONS):
                self.resblocks.append(ResBlock(ch, rk, dils))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return hifigan_apply(self, mel)


@torch.no_grad()
def hifigan_init(seed: int) -> HiFiGAN:
    """A generator with fp32 weights and biases drawn on the CPU from
    ``seed``, uniform in +-1/sqrt(in_channels * k) as the JAX package's
    ``_conv_init`` / ``_convt_init`` draw them."""
    gen = torch.Generator().manual_seed(seed)
    model = HiFiGAN()
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            c_in = m.in_channels
            bound = 1.0 / (c_in * m.kernel_size[0]) ** 0.5
            for p in (m.weight, m.bias):
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return model


def cast_hifigan_bf16(model: HiFiGAN) -> HiFiGAN:
    """bf16 copy of the generator for serving: the conv stack runs in bf16
    (half the activation memory), the waveform comes out fp32."""
    return copy.deepcopy(model).to(torch.bfloat16)


def _resblock(block: ResBlock, x: torch.Tensor) -> torch.Tensor:
    for c1, c2 in zip(block.convs1, block.convs2):
        xt = c1(F.leaky_relu(x, LRELU_SLOPE))
        xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
        x = x + xt
    return x


@torch.no_grad()
def hifigan_apply(model: HiFiGAN, mel: torch.Tensor) -> torch.Tensor:
    """mel (B, 80, T) on the generator's device -> waveform (B, T * 256),
    float32 in [-1, 1].  Runs in the weight dtype (the input is cast to
    it)."""
    x = model.conv_pre(mel.to(model.conv_pre.weight.dtype))
    n_res = len(RESBLOCK_KERNELS)
    for i, up in enumerate(model.ups):
        x = up(F.leaky_relu(x, LRELU_SLOPE))
        acc = None
        for j in range(n_res):
            y = _resblock(model.resblocks[i * n_res + j], x)
            acc = y if acc is None else acc + y
        x = acc / n_res
    x = model.conv_post(F.leaky_relu(x, LRELU_SLOPE))
    # fp32 waveform whatever the compute dtype (bf16 serving cast)
    return torch.tanh(x).float()[:, 0, :]


@torch.no_grad()
def hifigan_apply_chunked(model: HiFiGAN, mel: torch.Tensor,
                          chunk: int = 256,
                          overlap: int = RECEPTIVE_FRAMES) -> torch.Tensor:
    """Memory-bounded generator: the output of :func:`hifigan_apply`.

    Vocodes the mel in windows of ``chunk`` frames extended by ``overlap``
    frames of real context on each side (>= the stack's receptive radius)
    and keeps each window's centre, so peak activation memory scales with
    ``chunk + 2 * overlap`` instead of T.  Window starts clamp to the
    signal, so edge windows see the true utterance edge: the windows and
    the result are those of the JAX package's ``lax.scan``.
    """
    if chunk < 1 or overlap < RECEPTIVE_FRAMES:
        raise ValueError(
            f"chunk must be >= 1 and overlap >= {RECEPTIVE_FRAMES} "
            f"(the generator's receptive radius); got chunk={chunk}, "
            f"overlap={overlap}")
    b, _, t = mel.shape
    if t <= chunk + 2 * overlap:
        return hifigan_apply(model, mel)
    w = chunk + 2 * overlap
    up = TOTAL_UPSAMPLE
    out = torch.zeros(b, t * up, device=mel.device)
    for i in range(-(-t // chunk)):
        s = min(i * chunk, t - chunk)       # the last chunk re-covers the tail
        ws = min(max(s - overlap, 0), t - w)
        wav_w = hifigan_apply(model, mel[:, :, ws:ws + w])
        out[:, s * up:(s + chunk) * up] = \
            wav_w[:, (s - ws) * up:(s - ws + chunk) * up]
    return out


# ---------------------------------------------------------------------------
# NVIDIA checkpoint conversion
# ---------------------------------------------------------------------------
def _denorm(sd: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """Resolve a (possibly weight-normed) conv weight, as the JAX package's
    ``_denorm``: g * v / max(|v|, 1e-12), the norm over all but dim 0."""
    if f"{prefix}.weight" in sd:
        return np.asarray(sd[f"{prefix}.weight"], np.float32)
    g = np.asarray(sd[f"{prefix}.weight_g"], np.float32)
    v = np.asarray(sd[f"{prefix}.weight_v"], np.float32)
    norm = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().float().numpy() if torch.is_tensor(v) \
        else np.asarray(v)


@torch.no_grad()
def params_from_nvidia_state_dict(sd: Mapping[str, object]) -> HiFiGAN:
    """NVIDIA HiFi-GAN ``generator`` state dict (tensors or arrays,
    weight-normed or not) -> a generator on the CPU, fp32.  NVIDIA's
    transposed-conv weights are PyTorch's own (in, out, k) layout."""
    sd = {k: _numpy(v) for k, v in sd.items()}
    model = HiFiGAN()
    resolved = {}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            resolved[f"{name}.weight"] = torch.from_numpy(_denorm(sd, name))
            resolved[f"{name}.bias"] = torch.from_numpy(
                np.asarray(sd[f"{name}.bias"], np.float32))
    model.load_state_dict(resolved, strict=True)
    return model


@torch.no_grad()
def nvidia_state_dict(model: HiFiGAN, weight_norm: bool = True) -> dict:
    """The inverse of :func:`params_from_nvidia_state_dict`: the generator's
    state dict on the CPU as NVIDIA's checkpoint holds it.  With
    ``weight_norm`` every conv weight is split as ``nn.utils.weight_norm``
    splits it at dim 0: ``weight_v`` the weight, ``weight_g`` its norm over
    all but dim 0."""
    sd = {k: v.detach().cpu().float().clone()
          for k, v in model.state_dict().items()}
    if not weight_norm:
        return sd
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            w = sd.pop(f"{name}.weight")
            sd[f"{name}.weight_g"] = torch.linalg.vector_norm(
                w, dim=tuple(range(1, w.ndim)), keepdim=True)
            sd[f"{name}.weight_v"] = w
    return sd


def _checkpoint_path(checkpoint_path: Optional[str]) -> str:
    path = (checkpoint_path or os.environ.get("HIFIGAN_CHECKPOINT")
            or "hifigan_checkpoint.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"HiFi-GAN checkpoint not found at {path!r}; set "
            "HIFIGAN_CHECKPOINT or pass --vocoder griffinlim")
    return path


def load_hifigan_params(checkpoint_path: Optional[str] = None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> HiFiGAN:
    """Load the NGC generator checkpoint as a generator on ``device``, fp32.

    Checkpoint resolution: explicit arg > $HIFIGAN_CHECKPOINT >
    ./hifigan_checkpoint.pt (the reference's cache file name).  With no
    network the file must exist locally.  The file is the user's own
    checkpoint, unpickled whole as the JAX package does (the NGC file holds
    more than tensors)."""
    device = resolve_device(device)
    ckpt = torch.load(_checkpoint_path(checkpoint_path), map_location="cpu",
                      weights_only=False)
    sd = ckpt.get("generator", ckpt)
    return params_from_nvidia_state_dict(sd).to(device)

