"""Mel-scale diagnostics: stats printing and scale classification.

An own copy of the JAX package's ``tacotron2_tpu/utils/diagnostics.py``.

Mirrors the reference's runtime diagnostics (reference: train.py:590-614,
inference.py:98-111, gt_vocoder_check.py:19-39): percentile stats plus the
linear-vs-log heuristics used to catch scale mismatches before vocoding.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def mel_stats(mel) -> Dict[str, float]:
    m = np.asarray(mel, dtype=np.float64).reshape(-1)
    q = np.quantile(m, [0.01, 0.05, 0.5, 0.95, 0.99])
    return {
        "min": float(m.min()), "max": float(m.max()),
        "mean": float(m.mean()), "std": float(m.std()),
        "p01": float(q[0]), "p05": float(q[1]), "p50": float(q[2]),
        "p95": float(q[3]), "p99": float(q[4]),
    }


def classify_mel_scale(stats: Dict[str, float]) -> str:
    """LIKELY_LINEAR_0_1 / LIKELY_LOG / AMBIGUOUS
    (reference: gt_vocoder_check.py:32-39)."""
    linear_like = stats["min"] >= -1e-4 and 0.0 <= stats["max"] <= 1.05
    narrow_dyn = (stats["max"] - stats["min"]) < 1.2
    if linear_like and narrow_dyn:
        return "LIKELY_LINEAR_0_1"
    if stats["min"] < -0.5:
        return "LIKELY_LOG"
    return "AMBIGUOUS"


def print_mel_diagnostics(mel, tag: str) -> Dict[str, float]:
    """Print stats + scale interpretation (reference: train.py:590-614)."""
    s = mel_stats(mel)
    print(f"[MEL DIAG] {tag}: min {s['min']:.4f} max {s['max']:.4f} "
          f"mean {s['mean']:.4f} std {s['std']:.4f}")
    print(f"[MEL DIAG] {tag}: p01 {s['p01']:.4f} p05 {s['p05']:.4f} "
          f"p50 {s['p50']:.4f} p95 {s['p95']:.4f} p99 {s['p99']:.4f}")
    scale = classify_mel_scale(s)
    if scale == "LIKELY_LINEAR_0_1":
        print(f"[MEL DIAG] {tag}: Looks 0-1 linear/min-max normalized (NOT "
              f"log). Pretrained HiFi-GAN expects log-mel (negative values).")
    else:
        print(f"[MEL DIAG] {tag}: Distribution looks log-compressed "
              f"(negatives / wide dynamic range).")
    return s


def attention_entropy(alignments) -> float:
    """Mean attention-row entropy (reference: train.py:243-250)."""
    a = np.clip(np.asarray(alignments, dtype=np.float64), 1e-8, None)
    return float(-(a * np.log(a)).sum(-1).mean())
