"""Plain vocoders for the reference: the HiFi-GAN V1 generator
(arXiv:2010.05646, config V1) over a state dict, and Griffin-Lim after a
projected-gradient inversion of the Slaney mel filterbank, its short-time
transforms written out (frames, real FFT, windowed overlap-add).  Products
read their inputs through the rounding ``q`` of ``model.rounding``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .model import rounding

LRELU = 0.1
UPSAMPLE_RATES = (8, 8, 2, 2)
UPSAMPLE_KERNELS = (16, 16, 4, 4)
RESBLOCK_KERNELS = (3, 7, 11)
RESBLOCK_DILATIONS = (1, 3, 5)


def hifigan(sd, mel, q=rounding("float32")):
    """mel (B, 80, T) -> waveform (B, T * 256), tanh output."""
    def conv(x, name, dilation=1):
        w = sd[name + ".weight"]
        k = w.shape[-1]
        return F.conv1d(q(x), q(w), sd[name + ".bias"].float(),
                        padding=(k - 1) * dilation // 2, dilation=dilation)

    x = conv(mel, "conv_pre")
    n = len(RESBLOCK_KERNELS)
    for i, (u, k) in enumerate(zip(UPSAMPLE_RATES, UPSAMPLE_KERNELS)):
        x = F.conv_transpose1d(q(F.leaky_relu(x, LRELU)),
                               q(sd[f"ups.{i}.weight"]),
                               sd[f"ups.{i}.bias"].float(), stride=u,
                               padding=(k - u) // 2)
        acc = 0.0
        for j in range(n):
            y = x
            block = f"resblocks.{i * n + j}"
            for m, d in enumerate(RESBLOCK_DILATIONS):
                t = conv(F.leaky_relu(y, LRELU), f"{block}.convs1.{m}", d)
                y = y + conv(F.leaky_relu(t, LRELU), f"{block}.convs2.{m}")
            acc = acc + y
        x = acc / n
    return torch.tanh(conv(F.leaky_relu(x, LRELU), "conv_post"))[:, 0]


def _hz_to_mel(f):
    f = np.asanyarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asanyarray(m, np.float64)
    lin = m * (200.0 / 3.0)
    log = 1000.0 * np.exp((np.log(6.4) / 27) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filterbank(sr, n_fft, n_mels, fmin, fmax) -> np.ndarray:
    """Slaney-scale, Slaney-normalised triangles, (n_mels, 1 + n_fft//2)."""
    freqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fdiff = np.diff(hz)
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                   ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def _window(win_length: int, n_fft: int, device) -> torch.Tensor:
    """Periodic Hann, zero-padded to ``n_fft`` about its centre."""
    n = torch.arange(win_length, dtype=torch.float64)
    w = 0.5 - 0.5 * torch.cos(2.0 * np.pi * n / win_length)
    out = torch.zeros(n_fft, dtype=torch.float64)
    lo = (n_fft - win_length) // 2
    out[lo:lo + win_length] = w
    return out.float().to(device)


def stft(y, n_fft: int, hop: int, window):
    """Centred (reflect-padded by n_fft/2) frames, windowed, real FFT:
    (..., F, T) complex."""
    pad = n_fft // 2
    y = torch.cat([y[..., 1:pad + 1].flip(-1), y,
                   y[..., -pad - 1:-1].flip(-1)], dim=-1)
    frames = y.unfold(-1, n_fft, hop) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def envelope(window, t: int, n_fft: int, hop: int) -> torch.Tensor:
    """The summed square of ``t`` windows a hop apart, floored at 1e-10."""
    w2 = window.double().cpu().square()
    env = torch.zeros((t + n_fft // hop - 1) * hop, dtype=torch.float64)
    for j in range(t):
        env[j * hop:j * hop + n_fft] += w2
    return env.clamp_min(1e-10).float().to(window.device)


def istft(spec, n_fft: int, hop: int, window, env, length: int):
    """Inverse real FFT a frame, the window again, overlap-add in
    ``n_fft / hop`` slices of one hop, divided by the ``envelope``, the
    centre padding cut off."""
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    t, r = frames.shape[-2], n_fft // hop
    parts = frames.reshape(frames.shape[:-2] + (t, r, hop))
    acc = frames.new_zeros(frames.shape[:-2] + (t + r - 1, hop))
    for i in range(r):
        acc[..., i:i + t, :] += parts[..., :, i, :]
    sig = acc.reshape(frames.shape[:-2] + ((t + r - 1) * hop,)) / env
    start = max(0, min(n_fft // 2, sig.shape[-1] - length))
    return sig[..., start:start + length]


def griffin_lim(log_mel, audio: dict, n_iter: int, init_phase_seed: int,
                q=rounding("float32")):
    """Log-power mel (B, n_mels, S) -> waveform (B, S * hop): the
    filterbank inverted by 100 projected gradient steps from the
    pseudo-inverse, then ``n_iter`` Griffin-Lim rounds with momentum 0.99
    from a uniform initial phase drawn on the mel's device from
    ``init_phase_seed``; the short-time transforms as librosa's, centred
    with reflection, inverted by windowed overlap-add."""
    dev = log_mel.device
    n_fft, hop = audio["n_fft"], audio["hop_length"]
    basis_np = mel_filterbank(audio["sampling_rate"], n_fft, audio["n_mels"],
                              audio["fmin"], audio["fmax"])
    basis = torch.from_numpy(basis_np).to(dev)
    pinv = torch.from_numpy(np.linalg.pinv(basis_np)).to(dev)
    lip = float(np.linalg.norm(basis_np, 2) ** 2)
    mel = torch.exp(log_mel)
    s = torch.clamp(torch.matmul(q(pinv), q(mel)), min=0.0)
    for _ in range(100):
        grad = torch.matmul(q(basis.t()),
                            q(torch.matmul(q(basis), q(s)) - mel))
        s = torch.clamp(s - grad / lip, min=0.0)
    gen = torch.Generator(device=dev).manual_seed(init_phase_seed)
    phase = torch.rand(s.shape, generator=gen, device=dev) * (2.0 * np.pi)
    angles = torch.polar(torch.ones_like(s), phase)
    window = _window(audio["win_length"], n_fft, dev)
    prev = torch.zeros_like(angles)
    mom = 0.99 / 1.99
    t = s.shape[-1]
    env = envelope(window, t, n_fft, hop)
    for _ in range(n_iter):
        inverse = istft(s * angles, n_fft, hop, window, env, hop * (t - 1))
        rebuilt = stft(inverse, n_fft, hop, window)
        upd = rebuilt - mom * prev
        angles = upd / (upd.abs() + 1e-16)
        prev = rebuilt
    return istft(s * angles, n_fft, hop, window, env, hop * t)
