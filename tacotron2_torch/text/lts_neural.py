"""Neural letter-to-sound model: attention seq2seq, numpy inference.

The reference's OOV fallback is g2p_en's neural LTS network
(reference: src/text.py:35).  An own copy of the JAX package's
``tacotron2_tpu/text/lts_neural.py``: ``tools/train_lts_neural.py`` trains
a compact attention seq2seq (BiLSTM character encoder -> Luong-attention
LSTM phoneme decoder) on CMUdict and exports the weights as one npz
(``tacotron2_tpu/text/data/lts_neural.npz``, the repository's one copy,
opened by path); this module runs inference in plain numpy — the text
frontend stays dependency-free and host-side (G2P runs at data-prep/serving time, not on the card).

Holdout protocol matches the graphone n-gram (lts_model.py): words with
``crc32(word) % 10 == 0`` are never trained on, so held-out accuracy is
a true OOV measurement.

Decoding: width-``beam`` beam search over phoneme steps (numpy, batch
1 — the LTS fallback only sees rare OOV words).  The model vocabulary
is fixed by the trainer: letters a-z (PAD=0), phones = PAD/BOS/EOS +
the 69 stress-marked ARPAbet symbols CMUdict uses.
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

import numpy as np

# The weights are read where the repository keeps its one copy of them,
# beside the JAX package's text modules (resolved from this module's
# location, as lexicon.py finds third_party/cmudict).
DEFAULT_MODEL_PATH = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "tacotron2_tpu", "text", "data",
    "lts_neural.npz"))

PAD, BOS, EOS = 0, 1, 2
MAX_WORD_LEN = 24
MAX_PHONES = 28


def letter_ids(word: str) -> Optional[np.ndarray]:
    """a-z -> 1..26; None when the word has any other character."""
    ids = []
    for ch in word.lower():
        o = ord(ch) - ord("a")
        if not 0 <= o < 26:
            return None
        ids.append(o + 1)
    return np.asarray(ids, np.int32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _lstm_step(wi, wh, b, x, h, c):
    g = x @ wi + h @ wh + b
    H = h.shape[-1]
    i, f, gg, o = g[:H], g[H:2 * H], g[2 * H:3 * H], g[3 * H:]
    c2 = _sigmoid(f) * c + _sigmoid(i) * np.tanh(gg)
    h2 = _sigmoid(o) * np.tanh(c2)
    return h2, c2


class NeuralLts:
    """Numpy inference over the trained seq2seq weights."""

    def __init__(self, path: str = DEFAULT_MODEL_PATH):
        z = np.load(path, allow_pickle=False)
        self.p = {k: np.asarray(z[k], np.float32) for k in z.files
                  if k != "phone_symbols"}
        self.phone_symbols = [str(s) for s in z["phone_symbols"]]
        self.dec_h = self.p["dec_wh"].shape[0]

    def _encode(self, ids: np.ndarray) -> np.ndarray:
        """Encoder states over the FULL padded length (MAX_WORD_LEN).

        The trainer encodes zero-padded batches, so the backward LSTM
        walks the trailing PAD embeddings before reaching the real
        letters — its state at the real positions depends on that walk.
        Inference must replicate the padding exactly (the attention
        mask hides pad positions from scoring, but not their influence
        on the bidirectional states); skipping it shifts the encodings
        enough to break EOS behavior (measured: looping decodes)."""
        p = self.p
        padded = np.zeros(MAX_WORD_LEN, np.int32)
        padded[:len(ids)] = ids
        xs = p["enc_emb"][padded]                    # (Lp, E)
        Lp = xs.shape[0]
        H = p["enc_fwd_wh"].shape[0]
        out = np.zeros((Lp, 2 * H), np.float32)
        h = c = np.zeros(H, np.float32)
        for t in range(Lp):
            h, c = _lstm_step(p["enc_fwd_wi"], p["enc_fwd_wh"],
                              p["enc_fwd_b"], xs[t], h, c)
            out[t, :H] = h
        h = c = np.zeros(H, np.float32)
        for t in range(Lp - 1, -1, -1):
            h, c = _lstm_step(p["enc_bwd_wi"], p["enc_bwd_wh"],
                              p["enc_bwd_b"], xs[t], h, c)
            out[t, H:] = h
        return out                                   # (Lp, 2H)

    def pronounce(self, word: str, beam: int = 5,
                  max_phones: int = MAX_PHONES) -> Optional[List[str]]:
        """Best-beam pronunciation, or None for un-encodable words
        (non a-z characters or length beyond the trained cap)."""
        ids = letter_ids(word)
        if ids is None or not 1 <= len(ids) <= MAX_WORD_LEN:
            return None
        p = self.p
        enc = self._encode(ids)                      # (Lp, 2H)
        keys = enc @ p["attn_w"]                     # (Lp, Hd)
        # attention mask: pad positions never receive weight (the
        # trainer masks scores with -1e9 the same way)
        score_mask = np.full(enc.shape[0], -1e9, np.float32)
        score_mask[:len(ids)] = 0.0
        H = self.dec_h
        z0 = np.zeros(H, np.float32)
        # beam entries: (neg logp, phone ids, h, c, ctx)
        beams = [(0.0, [], z0, z0, np.zeros(enc.shape[1], np.float32))]
        done = []
        for _ in range(max_phones):
            cand = []
            for lp, seq, h, c, ctx in beams:
                prev = seq[-1] if seq else BOS
                x = np.concatenate([p["dec_emb"][prev], ctx])
                h2, c2 = _lstm_step(p["dec_wi"], p["dec_wh"], p["dec_b"],
                                    x, h, c)
                score = keys @ h2 + score_mask       # (Lp,)
                a = np.exp(score - score.max())
                a /= a.sum()
                ctx2 = a @ enc                       # (2H,)
                logits = np.concatenate([h2, ctx2]) @ p["out_w"] + p["out_b"]
                logp = logits - (np.log(np.exp(logits - logits.max()).sum())
                                 + logits.max())
                for t in np.argsort(-logp)[:beam]:
                    cand.append((lp - logp[t], seq + [int(t)], h2, c2,
                                 ctx2))
            beams = []
            for entry in sorted(cand, key=lambda e: e[0]):
                if entry[1][-1] == EOS:
                    done.append((entry[0], entry[1]))
                else:
                    beams.append(entry)
                if len(beams) >= beam:
                    break
            if not beams:
                break
        if not done and beams:
            done = [(lp, seq + [EOS]) for lp, seq, *_ in beams[:1]]
        if not done:
            return None
        _, best = min(done, key=lambda e: e[0] / max(len(e[1]), 1))
        phones = [self.phone_symbols[t] for t in best[:-1]
                  if t > EOS]
        return phones or None


def is_model_holdout(word: str, mod: int = 10, rem: int = 0) -> bool:
    """Same deterministic split as the graphone model (lts_model.py)."""
    import zlib
    return zlib.crc32(word.lower().encode()) % mod == rem


@functools.lru_cache(maxsize=1)
def load_default_model() -> Optional[NeuralLts]:
    """The shipped model, or None when the artifact is absent
    (``G2p(lts_model=False)`` is the way to run without it)."""
    if not os.path.isfile(DEFAULT_MODEL_PATH):
        return None
    return NeuralLts(DEFAULT_MODEL_PATH)
