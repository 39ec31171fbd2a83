"""A small synthetic corpus in the preprocessed layout, made from a seed.

The training loop reads a corpus as the JAX package's preprocessing writes
it: ``metadata.csv`` (``filepath,text``), ``text/<base>.npy`` (token ids)
and ``mels/<base>.npy`` ((n_mels, T) log-mels).  :func:`write_corpus`
writes one without audio files or the JAX package: sentences of words
drawn from a seed go through the port's text frontend, and each token
becomes a formant tone (two sines whose frequencies and length come from
the crc32 of the symbol, as ``tools/make_synth_corpus.py`` derives them
from a phoneme), so the mels follow the text and a model can learn to
align them.  :func:`write_sine_corpus` writes the JAX package's
verification corpus instead: two sentences in turn over sines of one pitch
each.  The log-mels come from ``dsp/mel.py``.
"""

from __future__ import annotations

import os
import zlib
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SYMBOLS, AudioConfig
from ..dsp.mel import get_mel_spectrogram_array
from ..text import text_to_sequence
from .metadata import _write_csv

WORDS = ("water", "river", "mountain", "shadow", "morning", "silver",
         "garden", "window", "thunder", "velvet", "candle", "meadow",
         "winter", "summer", "paper", "stone", "light", "dream")


def token_tone(token: int, sr: int) -> np.ndarray:
    """The tone of one token: 40-100 ms of two enveloped sines."""
    h = zlib.crc32(SYMBOLS[token].encode("utf-8")) % 1000
    f1 = 220.0 + (h % 17) * 40.0
    f2 = 900.0 + (h % 23) * 110.0
    n = int(sr * (0.04 + (h % 7) * 0.01))
    t = np.arange(n) / sr
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                     / (0.01 * sr))
    return (0.3 * env * (0.5 * np.sin(2 * np.pi * f1 * t)
                         + 0.3 * np.sin(2 * np.pi * f2 * t))
            ).astype(np.float32)


def _write(out_dir: str, utterances: List[Tuple[str, str, np.ndarray]],
           n_val: int, audio: AudioConfig,
           device: Union[str, torch.device]) -> Tuple[str, Optional[str]]:
    """Write (base name, text, waveform) utterances; the last ``n_val``
    into a second metadata file.  Returns both CSVs' paths."""
    for sub in ("text", "mels"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    rows: List[dict] = []
    for base, text, wav in utterances:
        np.save(os.path.join(out_dir, "text", f"{base}.npy"),
                np.asarray(text_to_sequence(text), np.int32))
        np.save(os.path.join(out_dir, "mels", f"{base}.npy"),
                get_mel_spectrogram_array(wav, audio, device=device))
        rows.append({"filepath": f"wavs/{base}.wav", "text": text})
    n = len(rows)
    train_csv = os.path.join(out_dir, "metadata.csv")
    _write_csv(train_csv, rows[:n - n_val], ["filepath", "text"])
    if not n_val:
        return train_csv, None
    val_csv = os.path.join(out_dir, "val_metadata.csv")
    _write_csv(val_csv, rows[n - n_val:], ["filepath", "text"])
    return train_csv, val_csv


def write_corpus(out_dir: str, n: int, seed: int = 0, n_val: int = 0,
                 words: Tuple[int, int] = (2, 5),
                 audio: Optional[AudioConfig] = None,
                 device: Union[str, torch.device] = "cuda"
                 ) -> Tuple[str, Optional[str]]:
    """Write ``n`` utterances of formant tones under ``out_dir``; the last
    ``n_val`` go to a second metadata file for validation.  Sentences have
    ``words`` (lo, hi) words.  Returns the paths of the training and
    validation ``metadata`` CSVs (None without ``n_val``)."""
    audio = audio or AudioConfig()
    rng = np.random.default_rng(seed)
    utterances = []
    for i in range(n):
        k = int(rng.integers(words[0], words[1] + 1))
        text = " ".join(WORDS[int(j)]
                        for j in rng.integers(0, len(WORDS), k)) + "."
        wav = np.concatenate([token_tone(int(t), audio.sampling_rate)
                              for t in text_to_sequence(text)])
        utterances.append((f"SYN-{i:04d}", text, wav))
    return _write(out_dir, utterances, n_val, audio, device)


def write_sine_corpus(out_dir: str, audio: Optional[AudioConfig] = None,
                      device: Union[str, torch.device] = "cuda") -> str:
    """The JAX package's verification corpus (its verify recipe): 16
    utterances, the two texts in turn, utterance i a sine of 150 + 12 i Hz
    lasting 0.8 + 0.1 i s at amplitude 0.35.  Returns the metadata CSV."""
    audio = audio or AudioConfig()
    sr = audio.sampling_rate
    texts = ["Hello world, this is a test.", "The quick brown fox."] * 8
    utterances = []
    for i, text in enumerate(texts):
        t = np.arange(int(sr * (0.8 + 0.1 * i))) / sr
        wav = (0.35 * np.sin(2 * np.pi * (150 + 12 * i) * t)
               ).astype(np.float32)
        utterances.append((f"LJT-{i:04d}", text, wav))
    return _write(out_dir, utterances, 0, audio, device)[0]
