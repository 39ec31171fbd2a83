"""DSP of the port: counterpart of ``tacotron2_tpu/dsp``."""

from .griffinlim import griffin_lim, mel_to_audio, mel_to_linear
from .mel import (batched_log_mel_with_lengths, default_filterbank,
                  get_mel_spectrogram_array, hz_to_mel, log_mel_spectrogram,
                  mel_filterbank, mel_to_hz, reflect_pad_batch)
from .stft import (frame_signal, hann_window, istft, n_frames, padded_window,
                   stft, stft_magnitude, stft_magnitude_squared)
from .wav import load_audio, resample, save_wav

from ..config import AudioConfig


def get_mel_spectrogram(filepath: str, cfg: AudioConfig = AudioConfig(),
                        device="cuda"):
    """File -> (n_mels, T) float32 log-mel, matching the reference's
    `get_mel_spectrogram` semantics (reference: src/audio.py:27-48)."""
    y, _ = load_audio(filepath, target_sr=cfg.sampling_rate)
    return get_mel_spectrogram_array(y, cfg, device)


__all__ = [
    "griffin_lim", "mel_to_audio", "mel_to_linear",
    "batched_log_mel_with_lengths", "default_filterbank",
    "get_mel_spectrogram_array", "get_mel_spectrogram", "hz_to_mel",
    "log_mel_spectrogram", "mel_filterbank", "mel_to_hz",
    "reflect_pad_batch", "frame_signal", "hann_window", "istft", "n_frames",
    "padded_window", "stft", "stft_magnitude", "stft_magnitude_squared",
    "load_audio",
    "resample", "save_wav",
]
