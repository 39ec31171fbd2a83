"""STFT / iSTFT with librosa-compatible conventions, on torch tensors.

Counterpart of ``tacotron2_tpu/dsp/stft.py``: framing is a strided view
(``frame[j] = y[j * hop : j * hop + n_fft]``), the window is a precomputed
periodic Hann, the transform a batched rFFT.  The window and the
window-sum-square envelope are made with numpy on the host, as there, and
moved to the signal's device once.

Conventions matched to ``librosa.stft`` defaults:
  * ``center=True``: reflect-pad the signal by ``n_fft // 2`` on both sides
  * periodic Hann window of ``win_length``, zero-padded (centered) to ``n_fft``
  * frame count ``1 + len(y) // hop_length``
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (``scipy.signal.get_window('hann', N, fftbins=True)``)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def padded_window(win_length: int, n_fft: int, dtype=np.float32) -> np.ndarray:
    """Hann window zero-padded (centered) to ``n_fft``, librosa style."""
    if win_length > n_fft:
        raise ValueError("win_length must be <= n_fft")
    win = hann_window(win_length, dtype)
    lpad = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=dtype)
    out[lpad:lpad + win_length] = win
    return out


def n_frames(n_samples: int, hop_length: int) -> int:
    """Number of STFT frames for a centered transform."""
    return 1 + n_samples // hop_length


@functools.lru_cache(maxsize=16)
def _window_on(device: torch.device, win_length: int,
               n_fft: int) -> torch.Tensor:
    return torch.from_numpy(padded_window(win_length, n_fft)).to(device)


def reflect_pad_last(y: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides (the edge sample
    is not repeated, as ``np.pad(mode='reflect')``)."""
    left = torch.flip(y[..., 1:pad + 1], dims=(-1,))
    right = torch.flip(y[..., -pad - 1:-1], dims=(-1,))
    return torch.cat([left, y, right], dim=-1)


def frame_signal(y: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True) -> torch.Tensor:
    """Slice a signal into overlapping frames.

    Args:
        y: (..., S) signal.
        center: if True, reflect-pad by ``n_fft // 2`` first (librosa
            ``center=True``); frame count is ``1 + S // hop``.  If False, the
            caller already padded; frame count is ``1 + (S - n_fft) // hop``.
    Returns:
        (..., T, n_fft) frames (a view of the padded signal).
    """
    if center:
        y = reflect_pad_last(y, n_fft // 2)
    return y.unfold(-1, n_fft, hop_length)


def stft(y: torch.Tensor, *, n_fft: int, hop_length: int,
         win_length: int, center: bool = True) -> torch.Tensor:
    """Complex STFT, (..., F, T) layout, complex64."""
    window = _window_on(y.device, win_length, n_fft)
    frames = frame_signal(y.float(), n_fft, hop_length, center) * window
    return torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(-1, -2)


def stft_magnitude_squared(y: torch.Tensor, *, n_fft: int, hop_length: int,
                           win_length: int,
                           center: bool = True) -> torch.Tensor:
    """|STFT|^2 power spectrogram of a (..., S) signal: (..., n_fft//2 + 1,
    T) float32 (librosa layout: frequency first, time last)."""
    spec = stft(y, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                center=center)
    return spec.real ** 2 + spec.imag ** 2


def stft_magnitude(y: torch.Tensor, *, n_fft: int, hop_length: int,
                   win_length: int) -> torch.Tensor:
    """|STFT| magnitude spectrogram, (..., F, T) float32."""
    return torch.sqrt(stft_magnitude_squared(
        y, n_fft=n_fft, hop_length=hop_length, win_length=win_length))


def _overlap_add_blocks(frames: torch.Tensor, n_fft: int,
                        hop: int) -> torch.Tensor:
    """Overlap-add via hop-block accumulation (requires hop | n_fft).

    frames: (..., T, n_fft) -> (..., (T + r - 1) * hop) signal, where
    ``r = n_fft / hop``: ``r`` slice-adds, in the JAX package's order.
    """
    r = n_fft // hop
    t = frames.shape[-2]
    parts = frames.reshape(frames.shape[:-2] + (t, r, hop))
    acc = frames.new_zeros(frames.shape[:-2] + (t + r - 1, hop))
    for i in range(r):
        acc[..., i:i + t, :] += parts[..., :, i, :]
    return acc.reshape(frames.shape[:-2] + ((t + r - 1) * hop,))


def _window_sumsquare(window: np.ndarray, t: int, n_fft: int,
                      hop: int) -> np.ndarray:
    """Host-side window-sum-square envelope for iSTFT normalization."""
    r = n_fft // hop
    total = (t + r - 1) * hop
    wss = np.zeros(total, dtype=np.float32)
    w2 = (window.astype(np.float64) ** 2)
    for j in range(t):
        wss[j * hop:j * hop + n_fft] += w2
    return wss.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _wss_on(device: torch.device, win_length: int, n_fft: int, hop: int,
            t: int) -> torch.Tensor:
    wss = _window_sumsquare(padded_window(win_length, n_fft), t, n_fft, hop)
    return torch.from_numpy(np.maximum(wss, 1e-10)).to(device)


def istft(spec: torch.Tensor, *, n_fft: int, hop_length: int, win_length: int,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT with windowed overlap-add and window-sum normalization.

    Args:
        spec: (..., F, T) complex STFT.
        length: output length; defaults to ``(T - 1) * hop_length`` (the
            centered-transform inverse, padding trimmed).
    Returns:
        (..., length) float32 signal.
    """
    if n_fft % hop_length != 0:
        raise NotImplementedError("istft requires hop_length | n_fft")
    window = _window_on(spec.device, win_length, n_fft)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)
    frames = frames * window  # synthesis window

    t = spec.shape[-1]
    sig = _overlap_add_blocks(frames, n_fft, hop_length)
    sig = sig / _wss_on(spec.device, win_length, n_fft, hop_length, t)

    pad = n_fft // 2
    if length is None:
        length = hop_length * (t - 1)
    # a start that would run past the end is clamped, as
    # ``jax.lax.dynamic_slice_in_dim`` does
    start = max(0, min(pad, sig.shape[-1] - length))
    return sig[..., start:start + length]
