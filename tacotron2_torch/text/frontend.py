"""Text frontend: raw text -> padded int32 token batches.

An own copy of the JAX package's ``tacotron2_tpu/text/frontend.py`` (numpy
and the standard library only; the symbol table is the port's config
copy).  The scalar path (`text_to_sequence`) has the same observable semantics as
the reference (reference: src/text.py:41-57): normalize -> G2P -> symbol-ID
lookup with *silent* out-of-vocabulary drop.

The batch path (`texts_to_batch`) produces a fixed-shape, zero-padded
``(B, T)`` int32 array plus lengths, ready for the device.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import SYMBOL_TO_ID, SYMBOLS
from .g2p import G2p
from .normalize import normalize_text


@functools.lru_cache(maxsize=1)
def _default_g2p() -> G2p:
    return G2p()


def text_to_sequence(text: str, g2p: Optional[G2p] = None) -> List[int]:
    """Convert text to a list of symbol IDs (silent OOV drop,
    reference: src/text.py:52-56)."""
    g2p = g2p or _default_g2p()
    normalized = normalize_text(text)
    phonemes = g2p(normalized)
    return [SYMBOL_TO_ID[p] for p in phonemes if p in SYMBOL_TO_ID]


def sequence_to_text(sequence: Sequence[int]) -> str:
    """Inverse mapping for debugging/export: IDs -> space-joined symbols
    (reference: train.py:31-37)."""
    return ' '.join(SYMBOLS[i] for i in sequence)


def pad_sequences(sequences: Sequence[Sequence[int]],
                  pad_to: Optional[int] = None,
                  pad_multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad ID sequences into a fixed-shape int32 batch.

    Returns ``(tokens (B, T), lengths (B,))``.  ``pad_to`` forces the padded
    length (for bucketed static shapes); otherwise the max length rounded up
    to ``pad_multiple`` is used.
    """
    lengths = np.asarray([len(s) for s in sequences], dtype=np.int32)
    max_len = int(lengths.max()) if len(sequences) else 0
    if pad_to is None:
        pad_to = (-(-max_len // pad_multiple) * pad_multiple
                  if pad_multiple > 1 else max_len)
    if pad_to < max_len:
        raise ValueError(f"pad_to={pad_to} < longest sequence {max_len}")
    tokens = np.zeros((len(sequences), max(pad_to, 1)), dtype=np.int32)
    for i, s in enumerate(sequences):
        tokens[i, :len(s)] = np.asarray(s, dtype=np.int32)
    return tokens, lengths


def texts_to_batch(texts: Sequence[str], g2p: Optional[G2p] = None,
                   pad_to: Optional[int] = None,
                   pad_multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Full frontend for a batch of raw strings."""
    seqs = [text_to_sequence(t, g2p) for t in texts]
    return pad_sequences(seqs, pad_to=pad_to, pad_multiple=pad_multiple)
