"""Pronunciation lexicon loading (CMUdict).

The reference reaches CMUdict through the `g2p_en`/NLTK stack
(reference: src/text.py:35, preprocess.py:10-11).  Here the lexicon is a
first-class, dependency-free component: a plain dict ``WORD -> phonemes``
parsed from any CMUdict-format file.

Supported on-disk formats:
  * NLTK corpus format:   ``WORD 1 HH AH0 L OW1`` (variant number column)
  * Upstream cmudict:     ``WORD  HH AH0 L OW1`` / ``WORD(2)  ...``
  * gzip-compressed copies of either

Only the first pronunciation variant of each word is kept, matching
g2p_en's lookup behavior.
"""

from __future__ import annotations

import functools
import gzip
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

_VARIANT_PAREN = re.compile(r"^(.+)\((\d+)\)$")

# Candidate lexicon locations, in priority order.
_DEFAULT_SEARCH_PATHS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "third_party",
                 "cmudict", "cmudict.gz"),
    os.path.join(os.path.dirname(__file__), "..", "..", "third_party",
                 "cmudict", "cmudict"),
    "./nltk_data/corpora/cmudict/cmudict",
)


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", encoding="latin-1")
    return open(path, "r", encoding="latin-1")


def _parse_line(line: str) -> Optional[Tuple[str, Tuple[str, ...]]]:
    """One CMUdict line -> (lowercase word, phoneme tuple), or None for
    comments/blank/malformed lines.  Handles both the NLTK variant-number
    column (``WORD 1 PH ...``) and the upstream ``WORD(2) PH ...`` form."""
    line = line.strip()
    if not line or line.startswith(";;;"):
        return None
    parts = line.split()
    if len(parts) < 2:
        return None
    word = parts[0]
    rest = parts[1:]
    if rest and rest[0].isdigit() and len(rest) > 1:
        phones = rest[1:]              # NLTK format: WORD <n> PH ...
    else:
        m = _VARIANT_PAREN.match(word)
        if m:                          # upstream format: WORD(2) PH ...
            word = m.group(1)
        phones = rest
    return word.lower(), tuple(phones)


def parse_cmudict(path: str) -> Dict[str, Tuple[str, ...]]:
    """Parse a CMUdict-format file into ``{lowercase word: phoneme tuple}``.

    Keeps only the first variant per word (g2p_en uses cmudict()[word][0]).
    """
    return {word: variants[0]
            for word, variants in parse_cmudict_variants(path).items()}


def find_lexicon_path(explicit: Optional[str] = None,
                      extra_paths: Sequence[str] = ()) -> Optional[str]:
    """Locate a CMUdict file: explicit arg > vendored > cwd."""
    candidates: List[str] = []
    if explicit:
        candidates.append(explicit)
    candidates.extend(p for p in _DEFAULT_SEARCH_PATHS if p)
    candidates.extend(extra_paths)
    for c in candidates:
        c = os.path.abspath(c)
        if os.path.isfile(c):
            return c
    return None


def parse_cmudict_variants(path: str) -> Dict[str, List[Tuple[str, ...]]]:
    """Like :func:`parse_cmudict` but keeps EVERY pronunciation variant,
    in file order (variant 1 first).  Used to validate the curated
    homograph table (text/homographs.py) against the lexicon."""
    lex: Dict[str, List[Tuple[str, ...]]] = {}
    with _open_maybe_gzip(path) as f:
        for line in f:
            parsed = _parse_line(line)
            if parsed is not None:
                lex.setdefault(parsed[0], []).append(parsed[1])
    return lex


@functools.lru_cache(maxsize=4)
def load_lexicon(path: Optional[str] = None) -> Dict[str, Tuple[str, ...]]:
    """Load (and cache) the pronunciation lexicon."""
    resolved = find_lexicon_path(path)
    if resolved is None:
        raise FileNotFoundError(
            "No CMUdict lexicon found. Pass a path or place a cmudict "
            "file at third_party/cmudict/cmudict[.gz].")
    return parse_cmudict(resolved)
