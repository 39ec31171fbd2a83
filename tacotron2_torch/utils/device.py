"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch
from torch import nn


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on; asking for CUDA where there is
    none raises instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def check_module_device(module: nn.Module, device: torch.device) -> None:
    """Raise unless every parameter of ``module`` lies on ``device``."""
    for name, p in module.named_parameters():
        if p.device.type != device.type or (
                device.index is not None and p.device.index != device.index):
            raise ValueError(
                f"parameter {name} is on {p.device}, the call asks for "
                f"{device}; move the model first (model.to(device))")
