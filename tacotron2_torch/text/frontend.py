"""Token-id batching: an own copy of the JAX package's ``pad_sequences``
(``tacotron2_tpu/text/frontend.py``).  The text -> token path is a later
slice of the port."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def pad_sequences(sequences: Sequence[Sequence[int]],
                  pad_to: Optional[int] = None,
                  pad_multiple: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad ID sequences into a fixed-shape int32 batch.

    Returns ``(tokens (B, T), lengths (B,))``.  ``pad_to`` forces the padded
    length; otherwise the max length rounded up to ``pad_multiple`` is used.
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
