"""Shared vocoding helper with a handful of stable shapes.

Counterpart of ``tacotron2_tpu/infer/vocode.py``.  Gate-trimmed mels have
arbitrary lengths; this helper pads the time axis to 128-frame buckets
(log-floor frames), vocodes, and trims the audio back, so that batched
traffic stacks mels of one bucket into one vocoder call and the cached
window-sum envelopes (``dsp/stft.py``) are reused.  ``vocoder`` is a
callable (the HiFi-GAN closure of :func:`try_load_hifigan`, or WaveGlow's
of :func:`try_load_waveglow`) or None for Griffin-Lim.  The loaders return
None, with a message (the JAX package's for HiFi-GAN), when the vocoder
cannot be loaded, so that callers fall back to Griffin-Lim.
"""

from __future__ import annotations

import importlib
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import AudioConfig
from ..dsp.griffinlim import griffin_lim, mel_to_linear
from ..utils.device import resolve_device

_FRAME_BUCKET = 128


def _griffin_lim_batch(mels: np.ndarray, cfg: AudioConfig, iters: int,
                       device: torch.device) -> np.ndarray:
    """(G, t_pad, n_mels) log-power mels -> (G, t_pad * hop) audio."""
    t_pad = mels.shape[1]
    # exp: these are log-power mels; explicit length covers ALL t_pad
    # frames (griffin_lim's default hop*(T-1) would drop the last one)
    mel_power = torch.exp(torch.from_numpy(
        np.ascontiguousarray(mels.transpose(0, 2, 1))).to(device))
    linear = mel_to_linear(mel_power, sr=cfg.sampling_rate, n_fft=cfg.n_fft,
                           n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax)
    return griffin_lim(linear, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                       win_length=cfg.win_length, n_iter=iters,
                       length=t_pad * cfg.hop_length).cpu().numpy()


def vocode_mel(mel: np.ndarray, cfg: AudioConfig,
               vocoder: Optional[Callable] = None,
               griffinlim_iters: int = 60,
               device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """(T, n_mels) log-mel -> waveform (T * hop samples).

    ``vocoder``: optional callable (B, n_mels, T) -> (B, samples); None
    uses Griffin-Lim on ``device``.
    """
    t_true = int(mel.shape[0])
    t_pad = -(-t_true // _FRAME_BUCKET) * _FRAME_BUCKET
    mel = _pad_frames(mel, t_pad, cfg.mel_eps)
    if vocoder is not None:
        audio = np.asarray(vocoder(mel.T[None])[0])
    else:
        audio = _griffin_lim_batch(mel[None], cfg, griffinlim_iters,
                                   resolve_device(device))[0]
    return audio[: t_true * cfg.hop_length]


def _pad_frames(mel: np.ndarray, t_pad: int, eps: float) -> np.ndarray:
    t = int(mel.shape[0])
    if t_pad == t:
        return mel
    return np.concatenate(
        [mel, np.full((t_pad - t, mel.shape[1]), np.log(eps), mel.dtype)],
        axis=0)


def vocode_mels(mels: Sequence[np.ndarray], cfg: AudioConfig,
                vocoder: Optional[Callable] = None,
                griffinlim_iters: int = 60, max_group: int = 16,
                device: Union[str, torch.device] = "cuda"
                ) -> List[np.ndarray]:
    """Batched counterpart of :func:`vocode_mel` for a list of
    variable-length (T_i, n_mels) mels — returns trimmed waveforms in
    order.

    Mels sharing a 128-frame time bucket are stacked and vocoded in ONE
    call, at the group's own size (the JAX package pads a group to a
    power-of-two batch to bound its number of compiled shapes; eager code
    has none to bound).  ``max_group`` splits oversized buckets into
    several calls, which bounds a neural vocoder's activation memory.
    """
    out = [None] * len(mels)
    buckets = {}
    for i, m in enumerate(mels):
        t_pad = -(-int(m.shape[0]) // _FRAME_BUCKET) * _FRAME_BUCKET
        buckets.setdefault(t_pad, []).append(i)
    groups = [(t_pad, all_idxs[s:s + max_group])
              for t_pad, all_idxs in buckets.items()
              for s in range(0, len(all_idxs), max_group)]
    if vocoder is None:
        device = resolve_device(device)
    for t_pad, idxs in groups:
        stacked = np.stack([_pad_frames(mels[i], t_pad, cfg.mel_eps)
                            for i in idxs])            # (G, t_pad, n_mels)
        if vocoder is not None:
            audio = np.asarray(vocoder(stacked.transpose(0, 2, 1)))
        else:
            audio = _griffin_lim_batch(stacked, cfg, griffinlim_iters, device)
        for j, i in enumerate(idxs):
            out[i] = audio[j, : int(mels[i].shape[0]) * cfg.hop_length]
    return out


_VOCODER_NAMES = {"hifigan": "HiFi-GAN", "waveglow": "WaveGlow"}


def _try_load(loader_name: str, checkpoint_path: Optional[str],
              vocoder: str = "hifigan", **kw):
    """Run a loader of ``models.<vocoder>``, returning None (with the JAX
    package's message, or its like for WaveGlow) on ANY failure -- missing
    checkpoint, wrong layout -- so callers fall back to Griffin-Lim instead
    of crashing."""
    try:
        module = importlib.import_module(f"..models.{vocoder}", __package__)
        return getattr(module, loader_name)(checkpoint_path, **kw)
    except Exception as e:
        print(f"{_VOCODER_NAMES[vocoder]} unavailable "
              f"({type(e).__name__}: {e}); falling back to Griffin-Lim.")
        return None


def try_load_hifigan(checkpoint_path: Optional[str] = None,
                     device: Union[str, torch.device] = "cuda"):
    """HiFi-GAN vocoder callable on ``device``, or None on any failure (see
    :func:`_try_load`)."""
    return _try_load("load_hifigan_vocoder", checkpoint_path, device=device)


def try_load_hifigan_params(checkpoint_path: Optional[str] = None,
                            device: Union[str, torch.device] = "cuda"):
    """The HiFi-GAN generator on ``device`` (the ``hifigan_params`` of the
    fused synthesis path), or None on any failure (see :func:`_try_load`)."""
    return _try_load("load_hifigan_params", checkpoint_path, device=device)


def try_load_waveglow(checkpoint_path: Optional[str] = None,
                      device: Union[str, torch.device] = "cuda"):
    """WaveGlow vocoder callable on ``device``
    (``models/waveglow.py::load_waveglow_vocoder``), or None on any
    failure (see :func:`_try_load`)."""
    return _try_load("load_waveglow_vocoder", checkpoint_path, "waveglow",
                     device=device)


def try_load_waveglow_params(checkpoint_path: Optional[str] = None,
                             device: Union[str, torch.device] = "cuda"):
    """The WaveGlow module on ``device`` (the ``waveglow`` of the fused
    synthesis path), or None on any failure (see :func:`_try_load`)."""
    return _try_load("load_waveglow_params", checkpoint_path, "waveglow",
                     device=device)
