"""Device helpers that also run on the CPU, where the tests drive a whole
run at a tiny size (no card: no memory reading, no trace)."""

from __future__ import annotations

import torch


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev: torch.device) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def build_kernels(dev: torch.device, names=None) -> None:
    """Build the program's CUDA sources (cached in its ``_build/``)."""
    if dev.type == "cuda":
        from tacotron2_torch.ops import _build
        if names is None:
            _build.build()
        else:
            _build.build(names)
