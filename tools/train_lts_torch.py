#!/usr/bin/env python
"""Offline trainer for the joint-sequence (graphone) LTS model, for the port.

The port's copy of ``tools/train_lts.py``: the same flags, the same
pipeline and the same table, with the PyTorch package's lexicon
(``tacotron2_torch/text/lexicon.py``) and, for the quick held-out check,
its ``text/lts_model.py::LtsModel``.  It is numpy on the host, as the JAX
tool is: nothing of it runs on a card.

Pipeline:
  1. EM alignment: each word becomes a lattice over "graphones" (one
     letter paired with 0/1/2 phonemes), and forward-backward under a
     unigram graphone model re-estimates chunk probabilities (8
     iterations).
  2. Viterbi: the converged model picks each word's single best graphone
     sequence; then a bigram Viterbi realigns every word (Sequitur-style).
  3. N-gram counts: order N (default 6) over those sequences, contexts seen
     once dropped at orders >= 4 (Witten-Bell or Kneser-Ney smoothing is
     applied at decode time by ``LtsModel``).
  4. Serialization: vocabulary + per-order CSR count tables into one
     ``.npz``, by default ``tacotron2_torch/text/data/lts_ngram.npz`` (a
     directory git ignores; the committed table stays the JAX package's).

Holdout protocol: words with ``crc32(word) % 10 == 0`` are excluded from
training (alignment and counts); ``tools/eval_g2p_torch.py`` scores only
on them.

    python tools/train_lts_torch.py [--order 6] [--em-iters 8] [--eval 2000]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import zlib
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from tacotron2_torch.text.lexicon import load_lexicon  # noqa: E402

HOLDOUT_MOD = 10      # crc32(word) % HOLDOUT_MOD == HOLDOUT_REM is held out
HOLDOUT_REM = 0
MAX_PHONES_PER_LETTER = 2


def is_holdout(word: str) -> bool:
    return zlib.crc32(word.encode()) % HOLDOUT_MOD == HOLDOUT_REM


def training_words(lex: Dict[str, Tuple[str, ...]]
                   ) -> List[Tuple[str, Tuple[str, ...]]]:
    out = []
    for w, ph in lex.items():
        if not w.isalpha() or is_holdout(w):
            continue
        if len(ph) > MAX_PHONES_PER_LETTER * len(w) or len(w) > 24:
            continue        # unalignable under the chunk limits
        out.append((w, ph))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# 1+2. EM alignment over graphone unigrams, then Viterbi.


def _arcs(word: str, phones: Sequence[str], i: int, j: int):
    """Arcs leaving lattice node (i, j): consume letter i with k phones."""
    for k in range(0, MAX_PHONES_PER_LETTER + 1):
        if j + k <= len(phones):
            yield k, (word[i], tuple(phones[j: j + k]))


def em_align(pairs, iters: int = 8, floor: float = 1e-12):
    """Forward-backward EM on unigram graphone probabilities."""
    probs: Dict[Tuple[str, Tuple[str, ...]], float] = defaultdict(
        lambda: 1.0)  # iteration 0: count all alignment paths uniformly
    for it in range(iters):
        counts: Dict[Tuple[str, Tuple[str, ...]], float] = defaultdict(float)
        ll = 0.0
        aligned = 0
        for word, phones in pairs:
            L, P = len(word), len(phones)
            # forward
            fwd = np.zeros((L + 1, P + 1))
            fwd[0, 0] = 1.0
            for i in range(L):
                for j in range(P + 1):
                    f = fwd[i, j]
                    if f == 0.0:
                        continue
                    for k, g in _arcs(word, phones, i, j):
                        fwd[i + 1, j + k] += f * probs[g]
            z = fwd[L, P]
            if z <= 0.0:
                continue
            aligned += 1
            ll += np.log(z)
            # backward
            bwd = np.zeros((L + 1, P + 1))
            bwd[L, P] = 1.0
            for i in range(L - 1, -1, -1):
                for j in range(P, -1, -1):
                    acc = 0.0
                    for k, g in _arcs(word, phones, i, j):
                        acc += probs[g] * bwd[i + 1, j + k]
                    bwd[i, j] = acc
            # expected counts
            for i in range(L):
                for j in range(P + 1):
                    f = fwd[i, j]
                    if f == 0.0:
                        continue
                    for k, g in _arcs(word, phones, i, j):
                        c = f * probs[g] * bwd[i + 1, j + k] / z
                        if c > 0.0:
                            counts[g] += c
            del fwd, bwd
        total = sum(counts.values())
        probs = defaultdict(lambda: floor,
                            {g: max(c / total, floor)
                             for g, c in counts.items()})
        print(f"  EM iter {it}: {aligned}/{len(pairs)} aligned, "
              f"avg log-lik {ll / max(aligned, 1):.4f}, "
              f"{len(counts)} graphone types", flush=True)
    return probs


def viterbi_align_bigram(word: str, phones: Sequence[str], probs,
                         bigram_counts, unigram_counts, n_types: int
                         ) -> List[Tuple[str, Tuple[str, ...]]] | None:
    """Viterbi under a BIGRAM graphone model (r5): one Sequitur-style
    alignment iteration — the unigram-EM alignment trains a bigram model
    over its own Viterbi output, and this pass realigns each word under
    that bigram (Witten-Bell smoothed against the unigram), which
    resolves chunking ambiguities the context-free model cannot (e.g.
    whether 'x'->K S attaches the S to the next letter).  States are
    (i, j, incoming graphone); each (i, j) admits at most
    MAX_PHONES_PER_LETTER+1 incoming graphones, so the DP stays linear.
    """
    L, P = len(word), len(phones)
    total_uni = max(sum(unigram_counts.values()), 1)

    def p_uni(g):
        return ((unigram_counts.get(g, 0) + n_types / total_uni)
                / (total_uni + n_types))

    def p_big(g_prev, g):
        row = bigram_counts.get(g_prev)
        if not row:
            return p_uni(g)
        tot = sum(row.values())
        typ = len(row)
        return (row.get(g, 0) + typ * p_uni(g)) / (tot + typ)

    # dp[(i, j)][g_in] = (score, backpointer (k, g_prev))
    dp: Dict[Tuple[int, int], Dict] = {(0, 0): {None: (0.0, None)}}
    for i in range(L):
        for j in range(P + 1):
            cell = dp.get((i, j))
            if not cell:
                continue
            for k, g in _arcs(word, phones, i, j):
                if probs[g] <= 0.0 and g not in unigram_counts:
                    continue
                best_s, best_prev = -np.inf, None
                for g_prev, (s, _) in cell.items():
                    s2 = s + np.log(max(p_big(g_prev, g), 1e-30))
                    if s2 > best_s:
                        best_s, best_prev = s2, g_prev
                nxt = dp.setdefault((i + 1, j + k), {})
                if g not in nxt or best_s > nxt[g][0]:
                    nxt[g] = (best_s, (k, best_prev))
    end = dp.get((L, P))
    if not end:
        return None
    # trace back the best final state
    g = max(end, key=lambda g_: end[g_][0])
    seq = []
    i, j = L, P
    while i > 0:
        s, (k, g_prev) = dp[(i, j)][g]
        seq.append(g)
        i, j, g = i - 1, j - k, g_prev
    return seq[::-1]


def viterbi_align(word: str, phones: Sequence[str], probs
                  ) -> List[Tuple[str, Tuple[str, ...]]] | None:
    L, P = len(word), len(phones)
    best = np.full((L + 1, P + 1), -np.inf)
    back: Dict[Tuple[int, int], Tuple[int, Tuple[str, Tuple[str, ...]]]] = {}
    best[0, 0] = 0.0
    for i in range(L):
        for j in range(P + 1):
            b = best[i, j]
            if b == -np.inf:
                continue
            for k, g in _arcs(word, phones, i, j):
                p = probs[g]
                if p <= 0.0:
                    continue
                s = b + np.log(p)
                if s > best[i + 1, j + k]:
                    best[i + 1, j + k] = s
                    back[(i + 1, j + k)] = (k, g)
    if best[L, P] == -np.inf:
        return None
    seq = []
    i, j = L, P
    while i > 0:
        k, g = back[(i, j)]
        seq.append(g)
        i, j = i - 1, j - k
    return seq[::-1]


# ---------------------------------------------------------------------------
# 3. N-gram counts (Witten-Bell interpolation happens at decode time in
#    lts_model.py; this trainer only materializes the count tables).

BOS = "<s>"
EOS = "</s>"


def count_ngrams(sequences: List[List[int]], order: int, bos_id: int,
                 eos_id: int):
    """Per-order {context tuple: {target id: count}} over the graphone id
    sequences (BOS-padded contexts, EOS-terminated)."""
    grams = [defaultdict(lambda: defaultdict(int)) for _ in range(order)]
    for seq in sequences:
        toks = [bos_id] * (order - 1) + seq + [eos_id]
        n_ctx = order - 1
        for pos in range(n_ctx, len(toks)):
            w = toks[pos]
            for n in range(order):
                ctx = tuple(toks[pos - n: pos])
                grams[n][ctx][w] += 1
    return grams


def prune_ngrams(grams, min_context_count: int = 2, from_order: int = 4):
    """Drop contexts with total count < min_context_count at orders >=
    from_order (decode backs off to the lower order there)."""
    for n in range(len(grams)):
        if n + 1 < from_order:
            continue
        drop = [ctx for ctx, tgt in grams[n].items()
                if sum(tgt.values()) < min_context_count]
        for ctx in drop:
            del grams[n][ctx]
    return grams


def serialize(path: str, vocab: List[str], grams, order: int,
              letter_cands: Dict[str, List[int]]):
    """Pack vocabulary + per-order CSR count tables into one npz."""
    arrays = {
        "vocab": np.array(vocab),
        "order": np.int32(order),
        "holdout_mod": np.int32(HOLDOUT_MOD),
        "holdout_rem": np.int32(HOLDOUT_REM),
    }
    for n, table in enumerate(grams):
        ctxs = sorted(table.keys())
        ctx_arr = np.array(ctxs, np.int32).reshape(len(ctxs), n)
        row_ptr = np.zeros(len(ctxs) + 1, np.int64)
        tgt_ids, tgt_counts = [], []
        for r, ctx in enumerate(ctxs):
            items = sorted(table[ctx].items())
            tgt_ids.extend(t for t, _ in items)
            tgt_counts.extend(c for _, c in items)
            row_ptr[r + 1] = len(tgt_ids)
        arrays[f"ctx{n}"] = ctx_arr
        arrays[f"ptr{n}"] = row_ptr
        arrays[f"tgt{n}"] = np.array(tgt_ids, np.int32)
        arrays[f"cnt{n}"] = np.array(tgt_counts, np.int32)
    letters = sorted(letter_cands.keys())
    arrays["letters"] = np.array(letters)
    arrays["letter_ptr"] = np.cumsum(
        [0] + [len(letter_cands[c]) for c in letters]).astype(np.int64)
    arrays["letter_ids"] = np.array(
        [g for c in letters for g in letter_cands[c]], np.int32)
    np.savez_compressed(path, **arrays)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--order", type=int, default=6)
    ap.add_argument("--em-iters", type=int, default=8)
    ap.add_argument("--min-context-count", type=int, default=2)
    ap.add_argument("--realign", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="second-stage bigram Viterbi realignment "
                         "(Sequitur-style; r5)")
    ap.add_argument("--prune-from-order", type=int, default=4,
                    help="orders >= this drop contexts below "
                         "--min-context-count (higher keeps more of the "
                         "long-context mass the decoder backs off to; "
                         "the r5 order-8 model uses 6)")
    ap.add_argument("--cands-per-letter", type=int, default=24)
    ap.add_argument("--eval", type=int, default=2000,
                    help="quick holdout eval size after training")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tacotron2_torch", "text", "data", "lts_ngram.npz"))
    a = ap.parse_args()

    lex = load_lexicon()
    pairs = training_words(lex)
    n_hold = sum(1 for w in lex if w.isalpha() and is_holdout(w))
    print(f"training words: {len(pairs)} (holdout excluded: {n_hold})",
          flush=True)

    t0 = time.time()
    probs = em_align(pairs, iters=a.em_iters)
    print(f"EM done in {time.time() - t0:.0f}s", flush=True)

    t0 = time.time()
    aligned_pairs = []
    skipped = 0
    for w, ph in pairs:
        seq = viterbi_align(w, ph, probs)
        if seq is None:
            skipped += 1
            continue
        aligned_pairs.append((w, ph, seq))
    print(f"Viterbi done in {time.time() - t0:.0f}s "
          f"({skipped} unalignable)", flush=True)

    if a.realign:
        # Sequitur-style second stage: train a bigram graphone model on
        # the unigram alignments, realign every word under it.
        t0 = time.time()
        uni_counts: Dict = defaultdict(int)
        big_counts: Dict = defaultdict(lambda: defaultdict(int))
        for _, _, seq in aligned_pairs:
            prev = None
            for g in seq:
                uni_counts[g] += 1
                big_counts[prev][g] += 1
                prev = g
        n_types = len(uni_counts)
        changed = 0
        realigned = []
        for w, ph, seq in aligned_pairs:
            seq2 = viterbi_align_bigram(w, ph, probs, big_counts,
                                        uni_counts, n_types)
            if seq2 is None:
                seq2 = seq
            elif seq2 != seq:
                changed += 1
            realigned.append((w, ph, seq2))
        aligned_pairs = realigned
        print(f"bigram realignment done in {time.time() - t0:.0f}s "
              f"({changed}/{len(aligned_pairs)} words changed)",
              flush=True)

    alignments = [seq for _, _, seq in aligned_pairs]

    # graphone vocabulary (BOS/EOS first; epsilon chunks are ordinary ids)
    gset = sorted({g for seq in alignments for g in seq})
    vocab = [BOS, EOS] + ["{}|{}".format(c, " ".join(p)) for c, p in gset]
    gid = {g: i + 2 for i, g in enumerate(gset)}
    sequences = [[gid[g] for g in seq] for seq in alignments]

    # letter -> candidate graphone ids, most frequent first, capped
    freq = defaultdict(int)
    for seq in sequences:
        for g in seq:
            freq[g] += 1
    by_letter = defaultdict(list)
    for (c, p), i in gid.items():
        by_letter[c].append(i)
    letter_cands = {c: sorted(ids, key=lambda i: -freq[i])
                    [: a.cands_per_letter]
                    for c, ids in by_letter.items()}

    t0 = time.time()
    grams = count_ngrams(sequences, a.order, bos_id=0, eos_id=1)
    grams = prune_ngrams(grams, a.min_context_count, a.prune_from_order)
    sizes = [sum(len(t) for t in g.values()) for g in grams]
    print(f"n-gram counts done in {time.time() - t0:.0f}s; entries/order: "
          f"{sizes}", flush=True)

    os.makedirs(os.path.dirname(a.out), exist_ok=True)
    serialize(a.out, vocab, grams, a.order, letter_cands)
    print(f"model written: {a.out} "
          f"({os.path.getsize(a.out) / 1e6:.1f} MB)", flush=True)

    if a.eval:
        from tacotron2_torch.text.lts_model import LtsModel
        model = LtsModel(a.out)
        hold = sorted(w for w in lex
                      if w.isalpha() and 4 <= len(w) <= 14 and is_holdout(w))
        import random
        random.Random(0).shuffle(hold)
        n_ok = n = 0
        t0 = time.time()
        for w in hold[: a.eval]:
            pred = model.pronounce(w)
            if pred is None:
                continue
            n += 1
            truth = tuple(p.rstrip("012") for p in lex[w])
            if tuple(p.rstrip("012") for p in pred) == truth:
                n_ok += 1
        print(f"holdout quick eval (model stage only): {n_ok}/{n} = "
              f"{n_ok / max(n, 1):.2%} stress-blind word accuracy "
              f"({(time.time() - t0) / max(n, 1) * 1e3:.1f} ms/word)",
              flush=True)


if __name__ == "__main__":
    main()
