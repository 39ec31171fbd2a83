"""WaveGlow (arXiv:1811.00002, NVIDIA's ``glow.py``) counted from its
widths: parameters, multiply-adds per group of ``n_group`` samples (a
multiply-add is two operations) and the bytes a call needs.

A flow of ``n`` channels (h = n / 2) costs, per group: the WN's ``start``
(h x C), ``n_layers`` dilated convolutions (C x 2C x kernel), the
conditioning (80 G x 2 C a layer), the residual and skip products (C x 2C,
the last C x C), ``end`` (C x 2h), and W (n x n).  The upsampling
transposed convolution costs 80 x 80 x 1024 a mel frame, spread over the
frame's ``stride / n_group`` groups.  Elementwise work (the gate, the
coupling's exp, the adds) is left out: no peak rate applies to it.
Bytes: the weights once, and per group the folded mel (80 G values), the
noise (G) and the output (G samples), at ``dt`` bytes a value.
"""

from __future__ import annotations

from typing import Iterable, List


def flow_channels(w: dict) -> List[int]:
    out, n = [], w["n_group"]
    for k in range(w["n_flows"]):
        if k % w["n_early_every"] == 0 and k > 0:
            n -= w["n_early_size"]
        out.append(n)
    return out


def _wn(w: dict, h: int) -> int:
    """Multiply-adds of one flow's WN a group."""
    c, n = w["n_channels"], w["n_layers"]
    cond = w["n_mel_channels"] * w["n_group"]
    return (h * c + n * (c * 2 * c * w["kernel_size"] + cond * 2 * c)
            + (n - 1) * c * 2 * c + c * c + c * 2 * h)


def wn_group(w: dict) -> int:
    """The WNs' multiply-adds a group, all flows."""
    return sum(_wn(w, n // 2) for n in flow_channels(w))


def group(w: dict) -> int:
    """Every multiply-add a group: the WNs, the W's and the upsampling's
    share."""
    m = w["n_mel_channels"]
    up = m * m * w["upsample_kernel"] * w["n_group"] // w["upsample_stride"]
    return wn_group(w) + sum(n * n for n in flow_channels(w)) + up


def ops(w: dict, groups: int) -> int:
    return 2 * group(w) * groups


def frame(w: dict) -> int:
    """Operations a mel frame (``stride / n_group`` groups)."""
    return ops(w, w["upsample_stride"] // w["n_group"])


def params(w: dict) -> int:
    c, n, k = w["n_channels"], w["n_layers"], w["kernel_size"]
    m, cond = w["n_mel_channels"], w["n_mel_channels"] * w["n_group"]
    total = m * m * w["upsample_kernel"] + m
    for f in flow_channels(w):
        h = f // 2
        total += (f * f + h * c + c + n * (2 * c * c * k + 2 * c)
                  + (n - 1) * (2 * c * c + 2 * c) + c * c + c
                  + 2 * c * n * (cond + 1) + c * 2 * h + 2 * h)
    return total


def nbytes(w: dict, groups: Iterable[int], dt: int = 4) -> int:
    """One call over rows of ``groups`` groups each."""
    per = w["n_mel_channels"] * w["n_group"] + 2 * w["n_group"]
    return dt * (params(w) + per * sum(int(g) for g in groups))
