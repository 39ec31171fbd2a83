"""Data-driven letter-to-sound model: joint-sequence graphone n-gram.

An own copy of the JAX package's ``tacotron2_tpu/text/lts_model.py``.
The runtime half of the trained LTS fallback (the reference reaches this
capability through g2p_en's neural LTS network, reference: src/text.py:35).
``tools/train_lts.py`` fits the model offline on CMUdict — EM-aligned
(letter, 0..2 phonemes) "graphone" chunks, order-6 counts — and ships it
as a single npz of CSR count tables; this module loads those tables and
beam-decodes pronunciations with interpolated probabilities computed
directly from the counts.  Default smoothing (r5) is Kneser-Ney-style
absolute discounting (D=0.9, measured +4.3% word accuracy over the r4
Witten-Bell recursion — see LtsModel._prob); ``smoothing="witten_bell"``
restores the r4 formula.  Either way evaluation is lazy, so
pruned/unseen contexts fall through to their lower-order estimate.

Training excludes a deterministic 10% of CMUdict (crc32(word) % 10 == 0);
``is_model_holdout`` exposes that split so evaluation (tools/eval_g2p.py)
scores the model only on words it has never seen.
"""

from __future__ import annotations

import functools
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_VOWEL_PH = {"AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
             "IH", "IY", "OW", "OY", "UH", "UW"}

# The table is read where the repository keeps its one copy of it, beside
# the JAX package's text modules (resolved from this module's location, as
# lexicon.py finds third_party/cmudict).
DEFAULT_MODEL_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "tacotron2_tpu", "text", "data",
    "lts_ngram.npz"))


class LtsModel:
    """Beam-search G2P decoder over the trained graphone n-gram."""

    def __init__(self, path: str = DEFAULT_MODEL_PATH,
                 smoothing: str = "kneser_ney", discount: float = 0.9):
        if smoothing not in ("kneser_ney", "witten_bell"):
            raise ValueError(f"unknown smoothing {smoothing!r}")
        self.smoothing = smoothing
        self.discount = float(discount)
        z = np.load(path, allow_pickle=False)
        self.order = int(z["order"])
        vocab = [str(v) for v in z["vocab"]]
        self.bos, self.eos = 0, 1
        # graphone id -> (letter, phone tuple); ids 0/1 are BOS/EOS
        self.phones: List[Tuple[str, ...]] = [(), ()]
        for v in vocab[2:]:
            _, _, ph = v.partition("|")
            self.phones.append(tuple(ph.split()) if ph else ())
        # letter -> candidate graphone ids (most frequent first)
        letters = [str(c) for c in z["letters"]]
        lptr, lids = z["letter_ptr"], z["letter_ids"]
        self.letter_cands: Dict[str, np.ndarray] = {
            c: lids[lptr[i]: lptr[i + 1]] for i, c in enumerate(letters)}
        # per-order tables: {ctx bytes: row}, CSR targets/counts, and the
        # per-row totals / distinct-type counts Witten-Bell needs
        self._ctx_row: List[Dict[bytes, int]] = []
        self._ptr: List[np.ndarray] = []
        self._tgt: List[np.ndarray] = []
        self._cnt: List[np.ndarray] = []
        self._tot: List[np.ndarray] = []
        self._ntyp: List[np.ndarray] = []
        for n in range(self.order):
            ctx = np.ascontiguousarray(z[f"ctx{n}"], np.int32)
            ptr = z[f"ptr{n}"]
            cnt = z[f"cnt{n}"]
            self._ctx_row.append(
                {ctx[r].tobytes(): r for r in range(ctx.shape[0])})
            self._ptr.append(ptr)
            self._tgt.append(z[f"tgt{n}"])
            self._cnt.append(cnt)
            self._tot.append(np.add.reduceat(
                cnt, ptr[:-1]) if len(cnt) else np.zeros(0, np.int64))
            self._ntyp.append(np.diff(ptr))
        self._uniform = 1.0 / max(len(vocab), 1)

    # -- probability ----------------------------------------------------

    def _prob(self, ctx: Tuple[int, ...], w: int) -> float:
        """Interpolated P(w | ctx) from raw counts.

        Default smoothing (r5): absolute discounting in the Kneser-Ney
        style — every seen count donates ``discount`` mass to the
        lower-order distribution::

            P_n(w | ctx) = max(c - D, 0) / c(ctx)
                           + (D * T(ctx) / c(ctx)) * P_{n-1}(w | ctx[1:])

        Measured against the r4 Witten-Bell recursion on the CMUdict
        holdout (same counts, same beam): 67.8% -> 72.1% word accuracy
        at D=0.9 — the strong discount compensates for the singleton
        contexts the trainer prunes at orders >= 4, which Witten-Bell
        (whose interpolation weight falls as counts grow) cannot.
        ``smoothing="witten_bell"`` restores the r4 recursion exactly.
        """
        if not ctx:
            row = 0 if self._ctx_row[0] else -1
            if row < 0:
                return self._uniform
            n = 0
        else:
            n = len(ctx)
            row = self._ctx_row[n].get(
                np.asarray(ctx, np.int32).tobytes(), -1)
        lower = self._prob(ctx[1:], w) if ctx else self._uniform
        if row < 0:
            return lower
        lo, hi = int(self._ptr[n][row]), int(self._ptr[n][row + 1])
        tgt = self._tgt[n][lo:hi]
        i = np.searchsorted(tgt, w)
        c = int(self._cnt[n][lo + i]) if i < len(tgt) and tgt[i] == w else 0
        total = int(self._tot[n][row])
        types = int(self._ntyp[n][row])
        if self.smoothing == "witten_bell":
            return (c + types * lower) / (total + types)
        D = self.discount
        return max(c - D, 0.0) / total + (D * types / total) * lower

    # -- decoding --------------------------------------------------------

    def pronounce(self, word: str, beam: int = 24,
                  cands_per_letter: int = 24) -> Optional[List[str]]:
        """Best-beam pronunciation, or None when the word contains a
        letter the model has no graphones for (caller falls back to the
        rule LTS)."""
        word = word.lower()
        n_ctx = self.order - 1
        init = tuple([self.bos] * n_ctx)
        hyps: List[Tuple[float, Tuple[int, ...], Tuple[str, ...]]] = [
            (0.0, init, ())]
        for ch in word:
            cands = self.letter_cands.get(ch)
            if cands is None or len(cands) == 0:
                return None
            nxt = []
            for lp, ctx, ph in hyps:
                for g in cands[:cands_per_letter]:
                    g = int(g)
                    p = self._prob(ctx, g)
                    nxt.append((lp + np.log(max(p, 1e-30)),
                                ctx[1:] + (g,), ph + self.phones[g]))
            nxt.sort(key=lambda h: -h[0])
            hyps = nxt[:beam]
        best, best_lp = None, -np.inf
        for lp, ctx, ph in hyps:
            lp += np.log(max(self._prob(ctx, self.eos), 1e-30))
            if lp > best_lp:
                best_lp, best = lp, ph
        if not best:
            return None
        return _ensure_primary_stress(list(best))


def _ensure_primary_stress(phones: List[str]) -> List[str]:
    """CMUdict words carry exactly one primary stress; if the decoded
    sequence has none, promote the first stressable vowel."""
    if any(p.endswith("1") for p in phones):
        return phones
    for i, p in enumerate(phones):
        if p.rstrip("012") in _VOWEL_PH:
            phones[i] = p.rstrip("012") + "1"
            break
    return phones


def is_model_holdout(word: str, mod: int = 10, rem: int = 0) -> bool:
    """True when ``word`` is in the deterministic 10% of CMUdict the
    shipped model never trained on (the honest evaluation set)."""
    return zlib.crc32(word.lower().encode()) % mod == rem


@functools.lru_cache(maxsize=1)
def load_default_model() -> Optional[LtsModel]:
    """The shipped model, or None when the artifact is absent
    (``G2p(lts_model=False)`` is the way to run without it)."""
    if not os.path.isfile(DEFAULT_MODEL_PATH):
        return None
    return LtsModel(DEFAULT_MODEL_PATH)
