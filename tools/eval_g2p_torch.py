#!/usr/bin/env python
"""Held-out CMUdict evaluation of the G2P cascade, for the port.

The port's copy of ``tools/eval_g2p.py``: the same flags, the same stats
and misses, the same ``--json``, scored through the PyTorch package's text
frontend (``tacotron2_torch/text/g2p.py::G2p``, ``text/lexicon.py``,
``text/lts_model.py`` and ``text/lts_neural.py``, which read the
repository's one copy of the CMUdict and of the two LTS tables).  It runs
on the host: the frontend is numpy.

Each sampled CMUdict word is hidden from the lexicon in place, the cascade
predicts it, and the prediction is scored against the word's own entry.
Where the trained n-gram table is present the sample is drawn from its
training holdout only (``crc32(word) % 10 == 0``), so the accuracy is an
out-of-vocabulary measurement.

Scores reported per cascade stage and overall:
  * word accuracy, ignoring stress digits, and with them;
  * mean phoneme error rate (Levenshtein over symbols, stress-blind);
  * the most frequent miss patterns.

    python tools/eval_g2p_torch.py --n 4000 --seed 0 [--misses 40] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable from any cwd

from tacotron2_torch.text.g2p import G2p  # noqa: E402
from tacotron2_torch.text.lexicon import load_lexicon  # noqa: E402
from tacotron2_torch.text.lts_model import (  # noqa: E402
    is_model_holdout, load_default_model)


def strip_stress(phones: Sequence[str]) -> Tuple[str, ...]:
    return tuple(p.rstrip("012") for p in phones)


def edit_distance(a: Sequence[str], b: Sequence[str]) -> int:
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def evaluate(n: int = 4000, seed: int = 0, n_misses: int = 40):
    import random
    lex = load_lexicon()
    # When the trained LTS model is active, score ONLY on its training
    # holdout (the deterministic 10% of CMUdict tools/train_lts.py never
    # saw) — otherwise "held out of the lexicon in place" words could
    # still have been n-gram training data, inflating accuracy.
    model_active = load_default_model() is not None
    words = sorted(w for w in lex
                   if w.isalpha() and 4 <= len(w) <= 14
                   and (is_model_holdout(w) if model_active else True))
    random.Random(seed).shuffle(words)
    sample = words[:n]

    stats = {"n": len(sample), "word_ok": 0, "word_ok_stress": 0,
             "phone_edits": 0, "phone_total": 0, "by_stage": {}}
    misses: List[dict] = []
    g = G2p(lexicon=lex, homographs=False)
    for w in sample:
        # hold the word out in place (G2p keeps a reference to lex)
        truth = lex.pop(w)
        pred = tuple(g.pronounce(w))
        stage = g.resolution(w)
        lex[w] = truth
        st = stats["by_stage"].setdefault(stage, {"n": 0, "word_ok": 0})
        st["n"] += 1
        p_ns, t_ns = strip_stress(pred), strip_stress(truth)
        d = edit_distance(p_ns, t_ns)
        stats["phone_edits"] += d
        stats["phone_total"] += len(t_ns)
        if p_ns == t_ns:
            stats["word_ok"] += 1
            st["word_ok"] += 1
            if pred == tuple(truth):
                stats["word_ok_stress"] += 1
        else:
            misses.append({"word": w, "stage": stage,
                           "pred": " ".join(pred),
                           "truth": " ".join(truth), "edits": d})

    misses.sort(key=lambda m: -m["edits"])
    stats["word_acc"] = stats["word_ok"] / stats["n"]
    stats["word_acc_stress"] = stats["word_ok_stress"] / stats["n"]
    stats["per"] = stats["phone_edits"] / stats["phone_total"]
    return stats, misses[:n_misses]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--misses", type=int, default=40)
    p.add_argument("--json", action="store_true")
    a = p.parse_args()
    stats, misses = evaluate(a.n, a.seed, a.misses)
    if a.json:
        json.dump({"stats": stats, "worst_misses": misses},
                  sys.stdout, indent=1)
        print()
        return
    print(f"held-out CMUdict words: {stats['n']}")
    print(f"word accuracy (stress-blind): {stats['word_acc']:.2%}")
    print(f"word accuracy (with stress):  {stats['word_acc_stress']:.2%}")
    print(f"phoneme error rate:           {stats['per']:.2%}")
    for stage, st in sorted(stats["by_stage"].items()):
        print(f"  {stage:>11}: {st['n']:5d} words, "
              f"{st['word_ok'] / max(st['n'], 1):.2%} correct")
    print("worst misses:")
    for m in misses:
        print(f"  [{m['stage']}] {m['word']!r}: {m['pred']}  "
              f"(truth: {m['truth']})")


if __name__ == "__main__":
    main()
