"""Token ids of the traffic's sentences for the reference.

The sentences are lowercase words of the frozen vocabulary in
``benchmark/traffic/vocab.json``, joined by single spaces and ended by a
period.  Every word is in CMUdict, so the frontend's answer is each word's
first CMUdict pronunciation, the words separated by the space symbol; the
sentence-final period carries no symbol.  The lexicon is read from the
repository's ``third_party/cmudict/cmudict.gz``; the symbol table is the
configuration file's.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Sequence, Tuple


def read_lexicon(path: str, words: Sequence[str]) -> Dict[str, Tuple[str, ...]]:
    """First pronunciation of each of ``words`` (NLTK layout: ``WORD 1 PH
    ...``)."""
    want = {w.upper() for w in words}
    out = {}
    with gzip.open(path, "rt", encoding="latin-1") as f:
        for line in f:
            parts = line.split()
            if len(parts) > 2 and parts[0] in want and parts[1] == "1":
                out[parts[0].lower()] = tuple(parts[2:])
    missing = want - {w.upper() for w in out}
    if missing:
        raise ValueError(f"not in the lexicon: {sorted(missing)}")
    return out


def token_ids(sentence: str, lexicon: Dict[str, Tuple[str, ...]],
              symbols: Sequence[str]) -> List[int]:
    index = {s: i for i, s in enumerate(symbols)}
    ids: List[int] = []
    for k, word in enumerate(sentence.rstrip(".").split(" ")):
        if k:
            ids.append(index[" "])
        ids.extend(index[p] for p in lexicon[word])
    return ids
