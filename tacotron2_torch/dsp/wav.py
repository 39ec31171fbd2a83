"""Waveform I/O and resampling (host-side).

An own copy of the JAX package's ``tacotron2_tpu/dsp/wav.py``.

Replaces the reference's ``librosa.load`` / ``scipy write_wav`` usage
(reference: src/audio.py:33, inference.py:94).  WAV via scipy's wavfile
module; FLAC via the optional ``soundfile`` package when present (gated,
since this environment has no audio codec libs).  Resampling is polyphase
(scipy), applied only when the file rate differs from the target.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

try:  # optional FLAC support
    import soundfile as _sf
except ImportError:  # pragma: no cover
    _sf = None


def _to_float(data: np.ndarray) -> np.ndarray:
    """Convert integer PCM to float32 in [-1, 1)."""
    if data.dtype == np.int16:
        return data.astype(np.float32) / 32768.0
    if data.dtype == np.int32:
        return data.astype(np.float32) / 2147483648.0
    if data.dtype == np.uint8:
        return (data.astype(np.float32) - 128.0) / 128.0
    return data.astype(np.float32)


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return y
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(y, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(path: str, target_sr: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Load an audio file as mono float32, optionally resampled.

    Returns (waveform, sampling_rate).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        sr, data = wavfile.read(path)
        y = _to_float(np.asarray(data))
    elif _sf is not None:
        y, sr = _sf.read(path, dtype="float32")
    else:
        raise RuntimeError(
            f"Cannot read {path!r}: non-WAV formats require the optional "
            "'soundfile' package (not installed).")
    if y.ndim > 1:  # downmix to mono (librosa.load default)
        y = y.mean(axis=1)
    y = y.astype(np.float32)
    if target_sr is not None and sr != target_sr:
        y = resample(y, sr, target_sr)
        sr = target_sr
    return y, sr


def save_wav(path: str, y: np.ndarray, sr: int) -> None:
    """Write a float32 WAV (same as the reference's scipy write_wav call)."""
    wavfile.write(path, sr, np.asarray(y, dtype=np.float32))
