"""Mel inversion + Griffin-Lim phase reconstruction on torch tensors.

Counterpart of ``tacotron2_tpu/dsp/griffinlim.py``:

  * mel -> linear spectrogram: non-negative least squares solved by
    projected gradient descent (same objective as librosa's NNLS,
    deterministic); the pseudo-inverse and the step size come from numpy on
    the host, as there, so both packages start from the same bits;
  * Griffin-Lim: iSTFT/STFT rounds with librosa's momentum-accelerated
    update (momentum 0.99, random phase init).

The host entry point :func:`mel_to_audio` reproduces the reference's
orientation auto-fix and log-vs-linear auto-detect heuristics
(reference: src/mel_griffinlim.py:24-40).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import AudioConfig
from ..utils.device import resolve_device
from .mel import filterbank_on, mel_filterbank
from .stft import istft, stft

_MOMENTUM = 0.99  # librosa.griffinlim default


@functools.lru_cache(maxsize=8)
def _inversion_constants(device: torch.device, sr: int, n_fft: int,
                         n_mels: int, fmin: float, fmax: float
                         ) -> Tuple[torch.Tensor, float]:
    """(pseudo-inverse (F, M) on ``device``, Lipschitz constant of the
    gradient = sigma_max(B)^2), host-computed."""
    basis_np = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    pinv = torch.from_numpy(np.linalg.pinv(basis_np)).to(device)
    return pinv, float(np.linalg.norm(basis_np, 2) ** 2)


def mel_to_linear(mel_power: torch.Tensor, *, sr: int, n_fft: int,
                  n_mels: int, fmin: float, fmax: float,
                  n_iters: int = 100) -> torch.Tensor:
    """Invert the mel filterbank: solve ``argmin_{S>=0} ||B S - mel||^2``.

    Args:
        mel_power: (..., n_mels, T) non-negative mel spectrogram.
    Returns:
        (..., 1 + n_fft//2, T) non-negative linear spectrogram.
    """
    dev = mel_power.device
    basis = filterbank_on(dev, sr, n_fft, n_mels, fmin, fmax)   # (M, F)
    pinv, lip = _inversion_constants(dev, sr, n_fft, n_mels, fmin, fmax)
    basis_t = basis.t()
    s = torch.clamp(torch.matmul(pinv, mel_power), min=0.0)
    for _ in range(n_iters):
        resid = torch.matmul(basis, s) - mel_power
        grad = torch.matmul(basis_t, resid)
        s = torch.clamp(s - grad / lip, min=0.0)
    return s


def _initial_phase(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Uniform [0, 2 pi) phase angles drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=gen, device=device) * (2.0 * np.pi)


def griffin_lim(magnitude: torch.Tensor, *, n_fft: int, hop_length: int,
                win_length: int, n_iter: int = 60,
                length: Optional[int] = None, seed: int = 0,
                init_phase: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction (librosa algorithm, momentum 0.99).

    Args:
        magnitude: (..., F, T) non-negative linear magnitude spectrogram.
        seed: seeds the initial phase where ``init_phase`` is None.
        init_phase: (..., F, T) initial phase angles in radians (torch's
            generator does not reproduce ``jax.random``; a caller that
            compares the two packages hands both the same draw).
    Returns:
        (..., length) float32 waveform; default length ``hop * (T - 1)``.
    """
    t = magnitude.shape[-1]
    if init_phase is None:
        init_phase = _initial_phase(magnitude.shape, seed, magnitude.device)
    angles = torch.polar(torch.ones_like(magnitude), init_phase.float())
    rebuilt_prev = torch.zeros_like(angles)
    mom = _MOMENTUM / (1.0 + _MOMENTUM)
    kw = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length)
    for _ in range(n_iter):
        inverse = istft(magnitude * angles, **kw)
        rebuilt = stft(inverse, **kw)
        # Momentum-accelerated phase update (librosa.griffinlim)
        upd = rebuilt - mom * rebuilt_prev
        angles = upd / (torch.abs(upd) + 1e-16)
        rebuilt_prev = rebuilt
    out_len = length if length is not None else hop_length * (t - 1)
    return istft(magnitude * angles, length=out_len, **kw)


def mel_to_audio(mel, n_iter: int = 60, cfg: Optional[AudioConfig] = None,
                 device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Waveform from a (n_mels, T) mel — log-power or linear, auto-detected.

    Reproduces the reference fallback vocoder's heuristics
    (reference: src/mel_griffinlim.py:7-50):
      * transposed-input auto-fix,
      * treat as log-mel (exponentiate) if ``min < -0.5`` or dynamic
        range ``> 5.0``, else clip at 0,
      * invert with ``power=1.0`` semantics (mel values treated as
        magnitude, not power).
    """
    cfg = cfg or AudioConfig()
    device = resolve_device(device)
    mel_np = np.asarray(mel, dtype=np.float32)
    if mel_np.ndim != 2:
        raise ValueError(f"expected 2-D mel, got shape {mel_np.shape}")
    if mel_np.shape[0] != cfg.n_mels and mel_np.shape[1] == cfg.n_mels:
        mel_np = mel_np.T

    mn, mx = float(mel_np.min()), float(mel_np.max())
    if (mn < -0.5) or (mx - mn > 5.0):
        mel_lin = np.exp(mel_np)      # log-power -> power
    else:
        mel_lin = np.maximum(mel_np, 0.0)

    linear = mel_to_linear(
        torch.from_numpy(mel_lin).to(device), sr=cfg.sampling_rate,
        n_fft=cfg.n_fft, n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax)
    wav = griffin_lim(linear, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                      win_length=cfg.win_length, n_iter=n_iter)
    return wav.cpu().numpy()
