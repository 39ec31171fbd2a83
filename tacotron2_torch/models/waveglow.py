"""WaveGlow, the flow vocoder NVIDIA ships with Tacotron 2.

Prenger, Valle and Catanzaro, *WaveGlow: A Flow-based Generative Network
for Speech Synthesis* (arXiv:1811.00002), as NVIDIA's ``glow.py``
computes it (NVIDIA/waveglow; DeepLearningExamples
PyTorch/SpeechSynthesis/Tacotron2).  The module's state-dict keys are
NVIDIA's with weight norm folded: ``upsample``, ``WN.{k}.start``,
``WN.{k}.in_layers.{i}``, ``WN.{k}.res_skip_layers.{i}``,
``WN.{k}.cond_layer``, ``WN.{k}.end``, ``convinv.{k}.conv``.  Only the
inverse pass (synthesis) is here; the forward pass (audio -> z) is in the
benchmark's plain reference.

Equations, with C = ``n_channels``, G = ``n_group`` (8), L = ``n_layers``
and T mel frames (hop 256, so T * 32 groups at G = 8):

* Upsample: ``spect = ConvTranspose1d(80, 80, 1024, stride=256)(mel)``,
  (B, 80, T * 256 + 768), cut to its first T * 256 samples.
* Fold: the mel's channel ``m * G + j`` at group t is ``spect[m, t * G +
  j]``, so ``cond_in`` is (B, 80 * G, T * 32); the audio's channel c at
  group t is sample ``t * G + c``.
* ``WN`` of ``x0`` (h channels) and ``cond_in``: ``x = start(x0)`` (1x1,
  h -> C); for layer i, dilation 2^i, ``a = in_layers[i](x) + c_i`` with
  ``c_i = cond_layer(cond_in)[:, 2 C i : 2 C (i + 1)]`` (3 taps, C -> 2 C;
  1x1, 80 G -> 2 C L); the gate ``g = tanh(a[:, :C]) * sigmoid(a[:,
  C:])``; ``r = res_skip_layers[i](g)`` (1x1); below the last layer ``x
  += r[:, :C]`` and ``skip += r[:, C:]``, the last layer is skip only
  (``skip += r``, C channels); ``out = end(skip)`` (1x1, C -> 2 h) gives
  ``(b, s) = (out[:, :h], out[:, h:])``.
* Flow k (channels n_k: 8, 6 or 4, h = n_k / 2) in reverse: ``a0, a1 =
  audio[:, :h], audio[:, h:]``; ``a1 <- (a1 - b) * exp(-s)`` with ``(b, s)
  = WN_k(a0, cond_in)``; then ``audio <- W_k^-1 audio`` (a 1x1
  convolution by the inverse of the n_k x n_k matrix W_k).
* Early outputs: ``n_early_size`` (2) channels leave the forward pass
  before flows 4 and 8; in reverse they join, in front of the channels,
  after flows 8 and 4 (before flows 7 and 3).
* Noise: ``z`` (B, G, T * 32), standard normal from a ``torch.Generator``
  on the mel's device, seeded 0 unless a seed or tensor is given, drawn
  once a call, scaled by sigma (0.6).  Its slices are the forward pass's
  outputs in order: ``z[:, 0:2]`` joins after flow 4, ``z[:, 2:4]`` after
  flow 8, ``z[:, 4:8]`` is the audio flow 11 starts from.

Load time.  Weight norm is folded (``g * v / |v|``, the norm over all but
dim 0).  Each W^-1 is formed in float64 on the host and cast to the
weight's type the first time a weight is seen (after a load or a move),
then kept.  Each WN layer's conditioning is the product of its own
1024-row slice of ``cond_layer`` (no (B, 8192, T * 32) tensor: 34 GB at B
= 64 and 512 frames).  The convolutions run in the weights' type; fp32
weights on the card run in TF32, cuDNN's default, as HiFi-GAN's do.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from ..utils.profiling import count, span
from .hifigan import _denorm, _numpy


@dataclasses.dataclass(frozen=True)
class WaveGlowConfig:
    """NVIDIA's published settings (DeepLearningExamples' defaults)."""
    n_mel_channels: int = 80
    n_flows: int = 12
    n_group: int = 8
    n_early_every: int = 4
    n_early_size: int = 2
    n_layers: int = 8
    n_channels: int = 512
    kernel_size: int = 3
    upsample_kernel: int = 1024
    upsample_stride: int = 256
    sigma: float = 0.6

    def flow_channels(self) -> List[int]:
        """The channels flow k works on (8, 8, 8, 8, 6, ..., 4)."""
        out, n = [], self.n_group
        for k in range(self.n_flows):
            if k % self.n_early_every == 0 and k > 0:
                n -= self.n_early_size
            out.append(n)
        return out


class WN(nn.Module):
    """The WaveNet-like network of one affine coupling."""

    def __init__(self, n_in: int, n_cond: int, cfg: WaveGlowConfig):
        super().__init__()
        c, k = cfg.n_channels, cfg.kernel_size
        self.start = nn.Conv1d(n_in, c, 1)
        self.in_layers = nn.ModuleList(
            nn.Conv1d(c, 2 * c, k, dilation=2 ** i,
                      padding=(k - 1) * 2 ** i // 2)
            for i in range(cfg.n_layers))
        self.res_skip_layers = nn.ModuleList(
            nn.Conv1d(c, 2 * c if i < cfg.n_layers - 1 else c, 1)
            for i in range(cfg.n_layers))
        self.cond_layer = nn.Conv1d(n_cond, 2 * c * cfg.n_layers, 1)
        self.end = nn.Conv1d(c, 2 * n_in, 1)


class Invertible1x1Conv(nn.Module):
    """W of one flow; :meth:`inverse` is W^-1, formed once a weight."""

    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv1d(c, c, 1, bias=False)
        self._inverse: Optional[torch.Tensor] = None
        self._formed_from = None

    def inverse(self) -> torch.Tensor:
        w = self.conv.weight
        key = (w.data_ptr(), w._version, w.dtype, w.device)
        if key != self._formed_from:
            inv = torch.linalg.inv(w.detach()[:, :, 0].cpu().double())
            self._inverse = inv.to(w.device, w.dtype)[:, :, None]
            self._formed_from = key
        return self._inverse


class WaveGlow(nn.Module):
    """The vocoder; ``forward`` is :func:`waveglow_infer`."""

    def __init__(self, cfg: WaveGlowConfig = WaveGlowConfig()):
        super().__init__()
        self.cfg = cfg
        m = cfg.n_mel_channels
        self.upsample = nn.ConvTranspose1d(m, m, cfg.upsample_kernel,
                                           stride=cfg.upsample_stride)
        self.WN = nn.ModuleList()
        self.convinv = nn.ModuleList()
        for n in cfg.flow_channels():
            self.convinv.append(Invertible1x1Conv(n))
            self.WN.append(WN(n // 2, m * cfg.n_group, cfg))

    def forward(self, mel: torch.Tensor, **kw) -> torch.Tensor:
        return waveglow_infer(self, mel, **kw)


@torch.no_grad()
def waveglow_init(seed: int, cfg: WaveGlowConfig = WaveGlowConfig()
                  ) -> WaveGlow:
    """A vocoder with fp32 weights drawn on the CPU from ``seed``: every
    convolution's weight and bias uniform in +-1/sqrt(in_channels * k), as
    ``hifigan_init`` draws them (``end`` too: NVIDIA zeroes it to start
    training, which would make every coupling the identity); each W a
    random orthogonal matrix of determinant +1 (the Q of a normal matrix's
    QR, its first column negated where the determinant is -1, as
    ``glow.py``)."""
    gen = torch.Generator().manual_seed(seed)
    model = WaveGlow(cfg)
    for m in model.modules():
        if isinstance(m, Invertible1x1Conv):
            n = m.conv.weight.shape[0]
            q = torch.linalg.qr(torch.randn(n, n, generator=gen))[0]
            if torch.det(q) < 0:
                q[:, 0] = -q[:, 0]
            m.conv.weight.copy_(q[:, :, None])
        elif (isinstance(m, (nn.Conv1d, nn.ConvTranspose1d))
              and m.bias is not None):          # not W's
            bound = 1.0 / (m.in_channels * m.kernel_size[0]) ** 0.5
            for p in (m.weight, m.bias):
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
    return model


def fold_mel(spect: torch.Tensor, n_group: int) -> torch.Tensor:
    """(B, M, G * n) upsampled mel -> (B, M * G, n): channel ``m * G +
    j`` at group t is sample ``t * G + j`` of mel channel m."""
    b, m, length = spect.shape
    return (spect.reshape(b, m, length // n_group, n_group)
            .transpose(2, 3).reshape(b, m * n_group, length // n_group))


def draw_noise(batch: int, groups: int, n_group: int,
               device: Union[str, torch.device], seed: int = 0
               ) -> torch.Tensor:
    """The standard normal (B, n_group, groups) draw of one call, from a
    generator on ``device`` seeded ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(batch, n_group, groups, generator=gen, device=device)


def _wn(wn: WN, x0: torch.Tensor, cond_in: torch.Tensor, c: int):
    """(b, s) of one coupling: the WN of ``x0`` and ``cond_in``."""
    x = wn.start(x0)
    skip = None
    last = len(wn.in_layers) - 1
    for i, (layer, res_skip) in enumerate(zip(wn.in_layers,
                                              wn.res_skip_layers)):
        rows = slice(2 * c * i, 2 * c * (i + 1))
        a = layer(x).add_(F.conv1d(cond_in, wn.cond_layer.weight[rows],
                                   wn.cond_layer.bias[rows]))
        r = res_skip(torch.tanh(a[:, :c]).mul_(torch.sigmoid(a[:, c:])))
        del a
        if i < last:
            x = x + r[:, :c]
            r = r[:, c:]
        skip = r if skip is None else skip + r
    out = wn.end(skip)
    h = out.shape[1] // 2
    return out[:, :h], out[:, h:]


@torch.no_grad()
def waveglow_infer(model: WaveGlow, mel: torch.Tensor,
                   sigma: Optional[float] = None,
                   noise: Optional[torch.Tensor] = None,
                   seed: int = 0) -> torch.Tensor:
    """mel (B, n_mel, T) log-mel on the vocoder's device -> waveform (B, T
    * upsample_stride), float32.  ``noise`` (B, n_group, T * stride /
    n_group) is the standard normal draw (default :func:`draw_noise` from
    ``seed``); ``sigma`` defaults to the configuration's 0.6.  Runs in the
    weights' type (the mel and the noise are cast to it)."""
    cfg = model.cfg
    sigma = cfg.sigma if sigma is None else sigma
    dt = model.upsample.weight.dtype
    b, _, t = mel.shape
    length = t * cfg.upsample_stride
    groups = length // cfg.n_group
    with span("waveglow.upsample"):
        spect = model.upsample(mel.to(dt))[:, :, :length]
        cond_in = fold_mel(spect, cfg.n_group)
        del spect
    count("waveglow.groups", b * groups)
    if noise is None:
        noise = draw_noise(b, groups, cfg.n_group, mel.device, seed)
    z = noise.to(dt) * sigma
    with span("waveglow.flows"):
        audio = z[:, cfg.n_group - cfg.flow_channels()[-1]:]
        for k in reversed(range(cfg.n_flows)):
            h = audio.shape[1] // 2
            bias, s = _wn(model.WN[k], audio[:, :h], cond_in, cfg.n_channels)
            audio = torch.cat([audio[:, :h],
                               (audio[:, h:] - bias) * torch.exp(-s)], 1)
            audio = F.conv1d(audio, model.convinv[k].inverse())
            if k % cfg.n_early_every == 0 and k > 0:
                j = (k // cfg.n_early_every - 1) * cfg.n_early_size
                audio = torch.cat([z[:, j:j + cfg.n_early_size], audio], 1)
    return audio.transpose(1, 2).reshape(b, -1).float()


# ---------------------------------------------------------------------------
# NVIDIA checkpoint conversion
# ---------------------------------------------------------------------------
_WEIGHT_NORMED = (".start", ".cond_layer", ".in_layers.", ".res_skip_layers.")


def _config_from_state_dict(sd: Mapping[str, np.ndarray]) -> WaveGlowConfig:
    """The widths a state dict holds (the stride is taken as 256)."""
    def weight(prefix):
        return sd.get(f"{prefix}.weight", sd.get(f"{prefix}.weight_v"))
    n_flows = sum(1 for k in sd if k.startswith("convinv.")
                  and k.endswith(".conv.weight"))
    chans = [sd[f"convinv.{k}.conv.weight"].shape[0] for k in range(n_flows)]
    every = next((k for k in range(1, n_flows) if chans[k] != chans[0]),
                 n_flows)
    up = sd["upsample.weight"]
    w_in = weight("WN.0.in_layers.0")
    return WaveGlowConfig(
        n_mel_channels=up.shape[0], n_flows=n_flows, n_group=chans[0],
        n_early_every=every,
        n_early_size=chans[0] - chans[every] if every < n_flows else 0,
        n_layers=sum(1 for k in sd if k.startswith("WN.0.in_layers.")
                     and k.endswith(".bias")),
        n_channels=weight("WN.0.start").shape[0], kernel_size=w_in.shape[-1],
        upsample_kernel=up.shape[-1])


@torch.no_grad()
def params_from_nvidia_state_dict(sd: Mapping[str, object]) -> WaveGlow:
    """NVIDIA WaveGlow state dict (``glow.py``'s keys, weight-normed or
    not, a ``module.`` prefix or none; tensors or arrays) -> a vocoder on
    the CPU, fp32, its widths read from the tensors' shapes."""
    sd = {k[len("module."):] if k.startswith("module.") else k: _numpy(v)
          for k, v in sd.items()}
    model = WaveGlow(_config_from_state_dict(sd))
    resolved = {}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)):
            resolved[f"{name}.weight"] = torch.from_numpy(_denorm(sd, name))
            if m.bias is not None:
                resolved[f"{name}.bias"] = torch.from_numpy(
                    np.asarray(sd[f"{name}.bias"], np.float32))
    model.load_state_dict(resolved, strict=True)
    return model


@torch.no_grad()
def nvidia_state_dict(model: WaveGlow, weight_norm: bool = True
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`params_from_nvidia_state_dict`: the state dict
    on the CPU as ``glow.py`` holds it; with ``weight_norm`` the layers
    ``glow.py`` weight-norms (``start``, ``cond_layer``, ``in_layers``,
    ``res_skip_layers``) split into ``weight_g`` (the norm over all but dim
    0) and ``weight_v``."""
    sd = {k: v.detach().cpu().float().clone()
          for k, v in model.state_dict().items()}
    if weight_norm:
        for name in [k[:-len(".weight")] for k in sd
                     if k.endswith(".weight")]:
            if any(p in name + "." for p in _WEIGHT_NORMED):
                w = sd.pop(f"{name}.weight")
                sd[f"{name}.weight_g"] = torch.linalg.vector_norm(
                    w, dim=tuple(range(1, w.ndim)), keepdim=True)
                sd[f"{name}.weight_v"] = w
    return sd


def _checkpoint_path(checkpoint_path: Optional[str]) -> str:
    path = (checkpoint_path or os.environ.get("WAVEGLOW_CHECKPOINT")
            or "waveglow_checkpoint.pt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"WaveGlow checkpoint not found at {path!r}; set "
            "WAVEGLOW_CHECKPOINT, pass --waveglow_checkpoint or pass "
            "--vocoder griffinlim")
    return path


def load_waveglow_params(checkpoint_path: Optional[str] = None,
                         device: Union[str, torch.device] = "cuda"
                         ) -> WaveGlow:
    """Load an NVIDIA WaveGlow checkpoint as a vocoder on ``device``, fp32.

    Resolution: explicit arg > $WAVEGLOW_CHECKPOINT >
    ./waveglow_checkpoint.pt.  The file is a state dict, or a dict holding
    one under ``state_dict`` (DeepLearningExamples) or ``model``; it is the
    user's own file, unpickled whole as :func:`load_hifigan_params` does."""
    device = resolve_device(device)
    ckpt = torch.load(_checkpoint_path(checkpoint_path), map_location="cpu",
                      weights_only=False)
    sd = ckpt
    for key in ("state_dict", "model"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    if isinstance(sd, nn.Module):
        sd = sd.state_dict()
    return params_from_nvidia_state_dict(sd).to(device)

