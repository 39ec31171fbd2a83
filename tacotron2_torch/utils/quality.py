"""Audio/model quality metrics beyond training losses.

The training loop's only quality signals are mel L1, gate BCE, and
attention entropy (reference: train.py:458-461) — regressions that
preserve L1 (duration drift, boundary artifacts, attention smearing) are
invisible to them.  This module adds the standard regression metrics:

  * **Mel-cepstral distortion (MCD)** — log-mel -> cepstra via DCT-II,
    10/ln10 * sqrt(2 |c_p - c_t|^2) over coefficients 1..K, frame-aligned
    for teacher-forced outputs and DTW-aligned for autoregressive ones.
  * **Gate-timing error** — |predicted stop frame - true mel length|.
  * **Alignment diagonality** — fraction of attention mass within a band
    around the ideal (linear) text-audio diagonal; smeared or collapsed
    attention scores low even when the loss looks fine.

Pure numpy on the host: an own copy of ``tacotron2_tpu/utils/quality.py``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_LOG10 = float(np.log(10.0))


def mel_cepstra(log_mel: np.ndarray, n_coefs: int = 13) -> np.ndarray:
    """Cepstra from log mels via an orthonormal DCT-II over the mel axis.

    log_mel: (T, n_mels) NATURAL-log mel power (the framework's cache
    scale).  Returns (T, n_coefs) keeping coefficients 0..n_coefs-1;
    MCD conventionally drops c0 (overall energy) downstream.
    """
    t, m = log_mel.shape
    # natural log -> log10 (the MCD convention's 10/ln10 factor assumes
    # dB-like cepstra; the constant scaling is absorbed consistently)
    x = log_mel / _LOG10
    n = np.arange(m)
    k = np.arange(n_coefs)[:, None]
    basis = np.cos(np.pi * k * (2 * n + 1) / (2 * m))   # (C, M)
    basis *= np.sqrt(2.0 / m)
    basis[0] /= np.sqrt(2.0)
    return x @ basis.T


def mcd_frame_aligned(pred: np.ndarray, target: np.ndarray,
                      n_coefs: int = 13) -> float:
    """MCD (dB) between frame-aligned log-mel sequences (T, n_mels).

    Teacher-forced outputs are frame-aligned with their targets by
    construction; lengths must match (trim to the shorter first if not).
    """
    t = min(pred.shape[0], target.shape[0])
    cp = mel_cepstra(pred[:t], n_coefs)[:, 1:]
    ct = mel_cepstra(target[:t], n_coefs)[:, 1:]
    d = np.sqrt(2.0 * np.sum((cp - ct) ** 2, axis=1))
    return float((10.0 / _LOG10) * np.mean(d))


def mcd_dtw(pred: np.ndarray, target: np.ndarray,
            n_coefs: int = 13) -> float:
    """MCD (dB) under dynamic-time-warping alignment (autoregressive
    outputs whose length differs from the target's).  O(T1*T2) host DP —
    fine at <=1000 frames."""
    cp = mel_cepstra(pred, n_coefs)[:, 1:]
    ct = mel_cepstra(target, n_coefs)[:, 1:]
    t1, t2 = cp.shape[0], ct.shape[0]
    # pairwise euclidean distances (T1, T2)
    d2 = (np.sum(cp ** 2, axis=1)[:, None] + np.sum(ct ** 2, axis=1)[None]
          - 2.0 * cp @ ct.T)
    dist = np.sqrt(np.maximum(d2, 0.0))
    acc = np.full((t1 + 1, t2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, t1 + 1):
        row_prev = acc[i - 1]
        row = acc[i]
        for j in range(1, t2 + 1):
            row[j] = dist[i - 1, j - 1] + min(row_prev[j], row[j - 1],
                                              row_prev[j - 1])
    # path length normalization: count the warping path steps
    i, j, steps = t1, t2, 0
    while i > 1 or j > 1:
        steps += 1
        moves = [(acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1)]
        _, i, j = min(moves, key=lambda m: m[0])
    steps += 1
    return float((10.0 / _LOG10) * np.sqrt(2.0) * acc[t1, t2] / steps)


def gate_timing_error(pred_end: int, true_len: int) -> int:
    """|predicted stop frame - true frame count| (frames)."""
    return abs(int(pred_end) - int(true_len))


def alignment_diagonality(attn: np.ndarray, text_len: Optional[int] = None,
                          mel_len: Optional[int] = None,
                          band: float = 0.12) -> float:
    """Fraction of attention mass within a band around the ideal diagonal.

    attn: (T_dec, T_enc) rows ~ softmax over encoder positions.  The
    ideal position for decoder step t is ``t/T_dec * text_len``; the band
    half-width is ``band * text_len`` (>= 2 positions).  1.0 = perfectly
    monotonic-diagonal attention; smeared/collapsed attention scores low.
    """
    t_dec = int(mel_len) if mel_len else attn.shape[0]
    t_enc = int(text_len) if text_len else attn.shape[1]
    a = attn[:t_dec, :t_enc]
    a = a / np.maximum(a.sum(axis=1, keepdims=True), 1e-8)
    ideal = (np.arange(t_dec) + 0.5) / t_dec * t_enc
    width = max(2.0, band * t_enc)
    pos = np.arange(t_enc)[None, :]
    in_band = np.abs(pos - ideal[:, None]) <= width
    return float(np.mean(np.sum(a * in_band, axis=1)))


def summarize(values) -> Dict[str, float]:
    arr = np.asarray([float(v) for v in values], np.float64)
    if arr.size == 0:
        return {"n": 0}
    return {"n": int(arr.size), "mean": float(arr.mean()),
            "median": float(np.median(arr)), "p90": float(
                np.percentile(arr, 90)), "max": float(arr.max())}
