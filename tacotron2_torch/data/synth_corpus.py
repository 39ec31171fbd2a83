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

:func:`make_synth_corpus` is instead a copy of ``tools/make_synth_corpus.py``:
the raw corpus (``wavs/`` of float32 WAV and a metadata file) that
``prepare_ljspeech`` / ``preprocess_corpus`` turn into the layout above,
bit for bit the tool's from the same seed.
"""

from __future__ import annotations

import os
import zlib
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import SYMBOLS, AudioConfig
from ..dsp.mel import get_mel_spectrogram_array
from ..text import G2p, text_to_sequence
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


# ---- the raw corpus of tools/make_synth_corpus.py ----

SR = 22050

# Words chosen to cover a wide phoneme set with CMUdict entries.
VOCAB = [
    "water", "river", "mountain", "shadow", "morning", "silver",
    "garden", "window", "thunder", "velvet", "candle", "meadow",
    "winter", "summer", "paper", "stone", "light", "dream",
    "voice", "music", "gentle", "golden", "hollow", "whisper",
    "travel", "wonder", "simple", "better", "never", "always",
]

_FRICATIVES = set("S Z SH ZH F V TH DH HH CH JH".split())
_STOPS = set("P B T D K G".split())


def _phoneme_params(phoneme: str, rng: np.random.Generator):
    """Deterministic per-phoneme acoustic fingerprint (crc32, not the
    salted built-in ``hash``, so separate runs agree)."""
    h = zlib.crc32(phoneme.encode("utf-8")) % 1000
    f1 = 220.0 + (h % 17) * 40.0          # 220..860 Hz
    f2 = 900.0 + (h % 23) * 110.0         # 900..3300 Hz
    noisy = phoneme in _FRICATIVES
    burst = phoneme in _STOPS
    dur = 0.07 + (h % 7) * 0.01           # 70..130 ms
    return f1, f2, noisy, burst, dur


def synth_utterance(phonemes, rng: np.random.Generator,
                    formant_scale: float = 1.0,
                    prosody: float = 0.0) -> np.ndarray:
    """Phonemes -> float32 waveform: per phoneme two formant sines (noise
    for fricatives, a closure for stops), 70-130 ms, enveloped; 40 ms of
    silence per space.  ``formant_scale`` shifts every formant (a
    'speaker').  ``prosody`` > 0 adds a per-utterance rate scale
    (1 +- prosody/2), per-phoneme duration jitter (+- prosody/4), a slow
    pitch wobble (+- prosody*3%) and a -38 dB noise floor; 0.0 draws
    nothing from ``rng`` for them."""
    rate = 1.0 + prosody * (rng.uniform(-0.5, 0.5) if prosody else 0.0)
    chunks = []
    phase = rng.uniform(0, 2 * np.pi) if prosody else 0.0
    wobble_hz = 2.5
    t_off = 0.0
    for ph in phonemes:
        if ph == " ":
            n_sil = int(SR * 0.04 * rate)
            chunks.append(np.zeros(n_sil, np.float32))
            t_off += n_sil / SR
            continue
        core = ph.rstrip("012")
        f1, f2, noisy, burst, dur = _phoneme_params(core, rng)
        f1 *= formant_scale
        f2 *= formant_scale
        if prosody:
            dur *= rate * (1.0 + prosody * rng.uniform(-0.25, 0.25))
        n = int(SR * dur)
        t = np.arange(n) / SR
        if prosody:
            wob = 1.0 + prosody * 0.03 * np.sin(
                2 * np.pi * wobble_hz * (t + t_off) + phase)
        else:
            wob = 1.0
        sig = (0.5 * np.sin(2 * np.pi * f1 * t * wob)
               + 0.3 * np.sin(2 * np.pi * f2 * t * wob))
        if noisy:
            sig = 0.35 * sig + 0.4 * rng.standard_normal(n)
        if burst:
            sig[: n // 3] *= 0.15          # closure then release
        env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                         / (0.012 * SR))
        sig = 0.3 * sig * env
        if prosody:
            sig = sig + 0.0126 * rng.standard_normal(n)   # ~-38 dB floor
        chunks.append(sig.astype(np.float32))
        t_off += n / SR
    return np.concatenate(chunks) if chunks else np.zeros(SR // 10,
                                                          np.float32)


def make_synth_corpus(outdir: str, n: int = 256, seed: int = 0,
                      min_words: int = 3, max_words: int = 8,
                      prosody: float = 0.0, n_speakers: int = 1,
                      rows: Optional[Iterable[int]] = None) -> str:
    """``tools/make_synth_corpus.py``'s corpus: ``outdir/wavs/SYN-iiii.wav``
    and ``outdir/metadata.csv`` (LJSpeech's pipe format with one speaker,
    ``filepath,text,speaker_id`` with more; utterances round-robin over
    speakers whose formants are scaled apart by 1.0 .. 1.3).  ``rows``
    names the utterances written to disk (all when None); every one of the
    ``n`` is synthesized all the same, so the random stream, and each
    written file, is the tool's.  Returns the metadata path."""
    from scipy.io import wavfile

    g2p = G2p()
    keep = None if rows is None else set(rows)
    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(outdir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)

    written = []
    for i in range(n):
        n_words = int(rng.integers(min_words, max_words + 1))
        words = [VOCAB[int(j)] for j in rng.integers(0, len(VOCAB), n_words)]
        text = " ".join(words) + "."
        phonemes = g2p(" ".join(words))
        speaker = i % max(1, n_speakers)
        scale = (1.0 if n_speakers <= 1
                 else 1.0 + 0.3 * speaker / (n_speakers - 1))
        wav = synth_utterance(phonemes, rng, formant_scale=scale,
                              prosody=prosody)
        if keep is not None and i not in keep:
            continue
        base = f"SYN-{i:04d}"
        path = os.path.join(wav_dir, f"{base}.wav")
        wavfile.write(path, SR, wav)
        written.append((base, os.path.abspath(path), text, speaker,
                        len(wav) / SR))

    meta = os.path.join(outdir, "metadata.csv")
    with open(meta, "w", encoding="utf-8") as f:
        if n_speakers > 1:
            # ready-to-preprocess CSV carrying speaker ids
            f.write("filepath,text,speaker_id\n")
            for _, path, text, speaker, _ in written:
                f.write(f'{path},"{text}",{speaker}\n')
        else:
            # LJSpeech pipe format (feed through prepare_ljspeech_metadata)
            f.write("\n".join(f"{b}|{t}|{t}" for b, _, t, _, _ in written))
    mean_sec = (sum(d for *_, d in written) / len(written)) if written else 0.0
    print(f"{len(written)} of {n} utterances ({max(1, n_speakers)} speakers) "
          f"-> {outdir} (~{mean_sec:.2f}s each)")
    return meta
