"""Text frontend of the port: own copies of the JAX package's
``tacotron2_tpu/text`` modules (numpy and the standard library only)."""

from .frontend import (pad_sequences, sequence_to_text, text_to_sequence,
                       texts_to_batch)
from .g2p import G2p, letter_to_sound
from .lexicon import find_lexicon_path, load_lexicon, parse_cmudict
from .normalize import normalize_text
from .numbers import number_to_words

__all__ = [
    "text_to_sequence", "sequence_to_text", "texts_to_batch", "pad_sequences",
    "G2p", "letter_to_sound", "load_lexicon", "parse_cmudict",
    "find_lexicon_path", "normalize_text", "number_to_words",
]
