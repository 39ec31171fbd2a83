"""Mel filterbank and log-mel extraction (batched, torch tensors).

Counterpart of ``tacotron2_tpu/dsp/mel.py``: power STFT -> mel filterbank
product -> clip at 1e-5 -> natural log.  Output layout (n_mels, T), float32.
The filterbank is made with numpy on the host (bit for bit the JAX
package's) and moved to the signal's device once.

The filterbank follows librosa's defaults exactly: Slaney mel scale
(``htk=False``) and Slaney area normalization (``norm='slaney'``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..config import AudioConfig
from ..utils.device import resolve_device
from .stft import stft_magnitude_squared

# --- Slaney mel scale (librosa hz_to_mel/mel_to_hz with htk=False) ---------
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP  # = 15.0
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq):
    freq = np.asanyarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(log_region,
                    _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
                    mels)
    return mels


def mel_to_hz(mels):
    mels = np.asanyarray(mels, dtype=np.float64)
    freqs = mels * _F_SP
    log_region = mels >= _MIN_LOG_MEL
    freqs = np.where(log_region,
                     _MIN_LOG_HZ * np.exp(_LOGSTEP * (mels - _MIN_LOG_MEL)),
                     freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, 1 + n_fft//2)."""
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # (n_mels + 2,) band edges in Hz

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney-style area normalization
    enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def default_filterbank(cfg: AudioConfig) -> np.ndarray:
    return mel_filterbank(cfg.sampling_rate, cfg.n_fft, cfg.n_mels,
                          cfg.fmin, cfg.fmax)


@functools.lru_cache(maxsize=8)
def filterbank_on(device: torch.device, sr: int, n_fft: int, n_mels: int,
                  fmin: float, fmax: float) -> torch.Tensor:
    """:func:`mel_filterbank` as a tensor on ``device`` (moved once)."""
    return torch.from_numpy(
        mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)


def log_mel_spectrogram(y: torch.Tensor, *, sr: int = 22050, n_fft: int = 1024,
                        hop_length: int = 256, win_length: int = 1024,
                        n_mels: int = 80, fmin: float = 0.0,
                        fmax: float = 8000.0, mel_eps: float = 1e-5,
                        center: bool = True) -> torch.Tensor:
    """log(clip(mel_power, eps)) spectrogram, (..., n_mels, T) float32.

    Batched: ``y`` may be (S,) or (B, S); all leading dims vectorize.
    Runs on ``y``'s device.
    """
    power = stft_magnitude_squared(y, n_fft=n_fft, hop_length=hop_length,
                                   win_length=win_length,
                                   center=center)  # (..., F, T)
    basis = filterbank_on(y.device, sr, n_fft, n_mels, fmin, fmax)
    mel_power = torch.matmul(basis, power)
    return torch.log(torch.clamp(mel_power, min=mel_eps))


def get_mel_spectrogram_array(y: np.ndarray,
                              cfg: Optional[AudioConfig] = None,
                              device: Union[str, torch.device] = "cuda"
                              ) -> np.ndarray:
    """Host-convenience wrapper: float waveform -> (n_mels, T) numpy
    log-mel, computed on ``device``."""
    cfg = cfg or AudioConfig()
    device = resolve_device(device)
    out = log_mel_spectrogram(
        torch.from_numpy(np.asarray(y, np.float32)).to(device),
        sr=cfg.sampling_rate, n_fft=cfg.n_fft,
        hop_length=cfg.hop_length, win_length=cfg.win_length,
        n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax, mel_eps=cfg.mel_eps)
    return out.cpu().numpy()


def batched_log_mel_with_lengths(
        y_padded: torch.Tensor, sample_lengths: torch.Tensor, *,
        sr: int = 22050, n_fft: int = 1024, hop_length: int = 256,
        win_length: int = 1024, n_mels: int = 80, fmin: float = 0.0,
        fmax: float = 8000.0,
        mel_eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corpus-scale batched extraction over pre-padded signals.

    Each input signal must already be reflect-padded by ``n_fft // 2`` on
    both sides on the host (see :func:`reflect_pad_batch`) and zero-padded
    to a common length — this reproduces librosa's ``center=True`` boundary
    frames exactly even inside a batch.

    Args:
        y_padded: (B, S_max + n_fft) padded float signals.
        sample_lengths: (B,) true (un-padded) sample counts.
    Returns:
        (mels (B, n_mels, T_max), mel_lengths (B,)); frames beyond each
        item's true frame count hold log(eps) and should be trimmed on host.
    """
    mels = log_mel_spectrogram(
        y_padded, sr=sr, n_fft=n_fft, hop_length=hop_length,
        win_length=win_length, n_mels=n_mels, fmin=fmin, fmax=fmax,
        mel_eps=mel_eps, center=False)
    mel_lengths = 1 + sample_lengths // hop_length
    # Mask padding frames to the log-floor so downstream stats stay sane.
    frame_idx = torch.arange(mels.shape[-1], device=mels.device)[None, :]
    valid = frame_idx < mel_lengths[:, None]
    floor = mels.new_tensor(float(np.float32(np.log(mel_eps))))
    return torch.where(valid[:, None, :], mels, floor), mel_lengths


def reflect_pad_batch(signals, pad: int, total_len: int) -> np.ndarray:
    """Host-side prep for :func:`batched_log_mel_with_lengths`.

    Reflect-pads each 1-D float signal by ``pad`` on both sides, then
    zero-pads to ``total_len`` samples.  Returns (B, total_len) float32.
    """
    out = np.zeros((len(signals), total_len), dtype=np.float32)
    for i, s in enumerate(signals):
        s = np.asarray(s, dtype=np.float32)
        padded = np.pad(s, (pad, pad), mode="reflect")
        out[i, :padded.shape[0]] = padded
    return out
