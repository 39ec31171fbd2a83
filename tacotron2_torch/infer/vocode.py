"""The vocoder seam, and the shared vocoding helper of the modular path.

A vocoder is any callable ``mel (B, n_mels, S) log-mel on the device ->
waveform (B, S * hop) on the device``.  The port has four:
:class:`GriffinLim` here, ``models/hifigan.py::HiFiGAN``,
``models/waveglow.py::WaveGlow`` and ``models/bigvgan.py::BigVGAN`` (each
module's ``forward`` is its inference).  :func:`load_vocoder` reads a
neural one from NVIDIA's checkpoint; :func:`try_load_vocoder` returns None
instead, with the JAX package's message (or its like for WaveGlow and
BigVGAN), so that callers fall back to Griffin-Lim.  Every synthesis path
takes one such callable (``infer/fused.py::synthesize_wav`` as its
``vocoder=``).

Counterpart of ``tacotron2_tpu/infer/vocode.py``: gate-trimmed mels have
arbitrary lengths; :func:`vocode_mels` pads the time axis to 128-frame
buckets (log-floor frames), vocodes, and trims the audio back, so that
batched traffic stacks mels of one bucket into one vocoder call and the
cached window-sum envelopes (``dsp/stft.py``) are reused.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import AudioConfig
from ..dsp.griffinlim import griffin_lim, mel_to_linear
from ..utils.device import resolve_device

Vocoder = Callable[[torch.Tensor], torch.Tensor]
Device = Union[str, torch.device]

_FRAME_BUCKET = 128


@dataclasses.dataclass(frozen=True, eq=False)
class GriffinLim:
    """Mel inversion + ``iters`` Griffin-Lim rounds as a vocoder.

    The mel is log-power; the waveform covers all S frames (an explicit
    length: ``griffin_lim``'s default hop * (S - 1) would drop the last).
    ``init_phase`` (B, n_fft // 2 + 1, S) is the initial phase; None draws
    it from seed 0 for the call's shape on the mel's device."""
    acfg: AudioConfig
    iters: int = 60
    init_phase: Optional[torch.Tensor] = None

    def __call__(self, mel: torch.Tensor) -> torch.Tensor:
        a = self.acfg
        linear = mel_to_linear(torch.exp(mel), sr=a.sampling_rate,
                               n_fft=a.n_fft, n_mels=a.n_mels, fmin=a.fmin,
                               fmax=a.fmax)
        return griffin_lim(linear, n_fft=a.n_fft, hop_length=a.hop_length,
                           win_length=a.win_length, n_iter=self.iters,
                           length=mel.shape[-1] * a.hop_length,
                           init_phase=self.init_phase)


# the neural vocoders by name, as the fallback message spells them
VOCODERS = {"hifigan": "HiFi-GAN", "waveglow": "WaveGlow",
            "bigvgan": "BigVGAN"}


def load_vocoder(name: str, checkpoint_path: Optional[str] = None,
                 device: Device = "cuda", *, bf16: bool = False,
                 chunk_frames: Optional[int] = None) -> Vocoder:
    """The neural vocoder ``name`` ("hifigan", "waveglow" or "bigvgan")
    read from NVIDIA's checkpoint (``models/<name>.py::load_<name>_params``:
    the argument, the environment variable, the file in the working
    directory) onto ``device``.

    ``bf16`` casts its weights (half the activation memory); the audio
    stays fp32.  ``chunk_frames`` (HiFi-GAN) bounds the generator's peak
    activation memory by the exact chunked evaluation
    (``models/hifigan.py::hifigan_apply_chunked``)."""
    if name not in VOCODERS:
        raise ValueError(f"unknown vocoder {name!r}; one of {list(VOCODERS)}")
    if chunk_frames is not None and (chunk_frames < 1 or name != "hifigan"):
        raise ValueError(f"chunk_frames must be >= 1 and is HiFi-GAN's, got "
                         f"{chunk_frames} for {name}")
    module = importlib.import_module(f"..models.{name}", __package__)
    model = getattr(module, f"load_{name}_params")(checkpoint_path, device)
    if bf16:
        model = model.to(torch.bfloat16)
    if chunk_frames:
        return functools.partial(module.hifigan_apply_chunked, model,
                                 chunk=chunk_frames)
    return model


def try_load_vocoder(name: str, checkpoint_path: Optional[str] = None,
                     device: Device = "cuda", **kw) -> Optional[Vocoder]:
    """:func:`load_vocoder`, or None where ``name`` names no neural vocoder
    (the JAX package takes any other name for Griffin-Lim) or where it
    cannot be loaded -- a missing checkpoint, a wrong layout -- after one
    line saying so, so that callers fall back to Griffin-Lim instead of
    crashing."""
    if name not in VOCODERS:
        return None
    try:
        return load_vocoder(name, checkpoint_path, device, **kw)
    except Exception as e:
        print(f"{VOCODERS[name]} unavailable ({type(e).__name__}: {e}); "
              f"falling back to Griffin-Lim.")
        return None


def vocode_array(vocoder: Vocoder, mels: np.ndarray,
                 device: Device = "cuda") -> np.ndarray:
    """(G, T, n_mels) log-mels on the host -> (G, T * hop) audio on the
    host, through ``vocoder`` on ``device``."""
    mel_ct = torch.from_numpy(np.ascontiguousarray(
        mels.transpose(0, 2, 1), np.float32)).to(resolve_device(device))
    return vocoder(mel_ct).cpu().numpy()


def vocode_mel(mel: np.ndarray, cfg: AudioConfig, vocoder: Vocoder,
               device: Device = "cuda") -> np.ndarray:
    """(T, n_mels) log-mel -> waveform (T * hop samples), the mel padded
    to its 128-frame bucket for the vocoder."""
    return vocode_mels([mel], cfg, vocoder, device=device)[0]


def _pad_frames(mel: np.ndarray, t_pad: int, eps: float) -> np.ndarray:
    t = int(mel.shape[0])
    if t_pad == t:
        return mel
    return np.concatenate(
        [mel, np.full((t_pad - t, mel.shape[1]), np.log(eps), mel.dtype)],
        axis=0)


def vocode_mels(mels: Sequence[np.ndarray], cfg: AudioConfig,
                vocoder: Vocoder, max_group: int = 16,
                device: Device = "cuda") -> List[np.ndarray]:
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
    for t_pad, idxs in groups:
        stacked = np.stack([_pad_frames(mels[i], t_pad, cfg.mel_eps)
                            for i in idxs])            # (G, t_pad, n_mels)
        audio = vocode_array(vocoder, stacked, device)
        for j, i in enumerate(idxs):
            out[i] = audio[j, : int(mels[i].shape[0]) * cfg.hop_length]
    return out
