"""Text normalization: the stage that runs before G2P.

Same observable pipeline as the reference normalizer
(reference: src/text.py:12-30):

  1. lowercase
  2. expand digit runs to words
  3. replace '.', ',', '-' with spaces
  4. strip any remaining non-word/non-space characters
  5. collapse whitespace

Number expansion uses our standalone :mod:`tacotron2_torch.text.numbers`
instead of the external `inflect` engine.
"""

from __future__ import annotations

import re

from .numbers import number_to_words

_DIGIT_RUN = re.compile(r"(\d+)")
_PUNCT_TO_SPACE = re.compile(r"[.,-]")
_NON_WORD = re.compile(r"[^\w\s]")
_MULTI_SPACE = re.compile(r"\s+")


def normalize_text(text: str) -> str:
    """Lowercase, expand numbers, strip punctuation, collapse whitespace."""
    text = text.lower()
    text = _DIGIT_RUN.sub(lambda m: number_to_words(m.group(0)), text)
    text = _PUNCT_TO_SPACE.sub(' ', text)
    text = _NON_WORD.sub('', text)
    text = _MULTI_SPACE.sub(' ', text).strip()
    return text
