"""Helpers the per-layer metric readers share."""

from __future__ import annotations

from typing import Optional

from benchmark.counts.peaks import least_time_s


def roofline_share(session, symbol: str, least_s: float) -> Optional[float]:
    """Per cent: the least time the kernel's launches in the window could
    take over the device time the trace gives them; None where the trace
    holds none of the kernel."""
    device_s, n = session.trace.kernel_time_s(symbol)
    if n == 0 or device_s <= 0:
        return None
    return 100.0 * least_s / device_s


def train_precision(config: dict) -> str:
    p = config["train"]["precision"]
    return "bfloat16" if p in ("bfloat16", "bf16") else "float32"


def dtype_bytes(precision: str) -> int:
    return 2 if precision == "bfloat16" else 4


__all__ = ["roofline_share", "train_precision", "dtype_bytes",
           "least_time_s"]
