"""Batch assembly for training.

An own copy of ``collate`` and ``_round_up`` from
``tacotron2_tpu/data/dataset.py`` (numpy only), so that training code and
its tests build batches the way the trainer does.  The dataset reader and
the epoch loader come with the training loop.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np


class Example(NamedTuple):
    text: np.ndarray        # (T_text,) int token ids
    mel: np.ndarray         # (n_mels, T_mel) float32 log-mel
    speaker_id: int = 0


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def collate(examples: Sequence[Example], text_pad_multiple: int = 32,
            mel_pad_multiple: int = 64,
            fixed_text_len: Optional[int] = None,
            fixed_mel_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Assemble a batch dict with quantised padded shapes.

    Sorts by text length descending, zero-pads text and mel, rounds the
    padded dims up to the given multiples.
    """
    order = np.argsort([-len(e.text) for e in examples], kind="stable")
    examples = [examples[i] for i in order]

    text_lengths = np.asarray([len(e.text) for e in examples], dtype=np.int32)
    mel_lengths = np.asarray([e.mel.shape[1] for e in examples],
                             dtype=np.int32)
    t_text = fixed_text_len or _round_up(int(text_lengths.max()),
                                         text_pad_multiple)
    t_mel = fixed_mel_len or _round_up(int(mel_lengths.max()),
                                       mel_pad_multiple)
    n_mels = examples[0].mel.shape[0]

    b = len(examples)
    text = np.zeros((b, t_text), dtype=np.int32)
    mel = np.zeros((b, n_mels, t_mel), dtype=np.float32)
    for i, e in enumerate(examples):
        text[i, :len(e.text)] = e.text
        mel[i, :, :e.mel.shape[1]] = e.mel
    speakers = np.asarray([e.speaker_id for e in examples], dtype=np.int32)
    return {"text": text, "text_lengths": text_lengths, "mel": mel,
            "mel_lengths": mel_lengths, "speaker_ids": speakers}
