"""Fused eval-mode Conv1d + BatchNorm + activation.

Replaces the Pallas kernel ``tacotron2_tpu/ops/convbn_kernel.py::
conv_bn_act_pallas``.  In eval mode BatchNorm is a per-channel affine, so a
layer ``act(BN(conv1d(x, W) + b))`` folds to ``act(conv1d(x, W') + h)``
with

    g  = bn.weight / sqrt(running_var + eps)
    W' = W * g        (per output channel)
    h  = bn.bias + (b - running_mean) * g

:func:`fold_conv_bn` forms ``W'`` and ``h`` in fp32 (plain PyTorch, as the
fold is outside the Pallas body there); ``W'`` is then rounded once to the
weight dtype, the input is rounded to the weight dtype, the ``K`` per-tap
products are summed in fp32 and the result is written once, fp32.  The CUDA
C++ kernel (``csrc/conv_bn_act.cu``) does that on the card; its source note
has the design and its bound.  :func:`conv_bn_act_reference` is the plain
version, the same arithmetic step by step.  Serving only: training keeps
the unfused Conv1d + batch-statistics BatchNorm of ``models/layers.py``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..models.layers import BatchNorm, Conv1d
from . import _build

ACTS = {"none": 0, "relu": 1, "tanh": 2}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_bn_act")
    lib.t2_conv_bn_act.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.t2_conv_bn_act.restype = ctypes.c_int
    return lib


@torch.no_grad()
def fold_conv_bn(conv: Conv1d, bn: BatchNorm, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold eval-mode BatchNorm into the conv weights.  Returns
    ``(wmat (K, C_in, C_out), h (C_out,))``, both fp32 (not yet rounded to
    the weight dtype)."""
    g = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    w = conv.weight.float() * g[:, None, None]            # (C_out, C_in, K)
    h = bn.bias.float() - bn.running_mean.float() * g
    if conv.bias is not None:
        h = h + conv.bias.float() * g
    return w.permute(2, 1, 0), h


def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(y)
    if act == "tanh":
        return torch.tanh(y)
    return y


@torch.no_grad()
def conv_bn_act_reference(x: torch.Tensor, conv: Conv1d, bn: BatchNorm,
                          eps: float, act: str) -> torch.Tensor:
    """Plain PyTorch version of the folded layer, step by step.
    x (B, C_in, T) -> (B, C_out, T) fp32."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    wdtype = conv.weight.dtype
    wmat, h = fold_conv_bn(conv, bn, eps)
    wmat = wmat.to(wdtype).float()                        # rounded once
    k = wmat.shape[0]
    t = x.shape[2]
    xt = x.transpose(1, 2).to(wdtype).float()             # (B, T, C_in)
    xt = F.pad(xt, (0, 0, (k - 1) // 2, k // 2))
    y = torch.zeros(x.shape[0], t, wmat.shape[2], device=x.device)
    for tap in range(k):
        y = y + torch.matmul(xt[:, tap:tap + t], wmat[tap])
    return _activate(y + h, act).transpose(1, 2)


@torch.no_grad()
def conv_bn_act(x: torch.Tensor, conv: Conv1d, bn: BatchNorm, eps: float,
                act: str) -> torch.Tensor:
    """Fused eval-mode conv + BatchNorm + activation.
    x (B, C_in, T), fp32 or the weight dtype -> (B, C_out, T) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise).  Odd kernel sizes only ('same' padding).
    ``conv_bn_act.launches`` counts launches."""
    if x.device.type == "cpu":
        return conv_bn_act_reference(x, conv, bn, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bn_act: unsupported device {x.device}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    c_out, c_in, k = conv.weight.shape
    wdtype = conv.weight.dtype
    if wdtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_bn_act: weight dtype {wdtype}")
    if x.ndim != 3 or x.shape[1] != c_in or x.shape[0] < 1 or x.shape[2] < 1:
        raise ValueError(f"conv_bn_act: input {tuple(x.shape)} does not fit "
                         f"a conv of {c_in} input channels")
    if x.dtype not in (torch.float32, wdtype):
        raise TypeError(f"conv_bn_act: input dtype {x.dtype} with "
                        f"{wdtype} weights")
    if k % 2 == 0:
        raise ValueError("conv_bn_act supports odd kernel sizes only")
    if conv.weight.device != x.device or bn.running_var.device != x.device:
        raise ValueError("conv_bn_act: weights and input on different "
                         "devices")
    wmat, h = fold_conv_bn(conv, bn, eps)
    w = wmat.permute(0, 2, 1).to(wdtype).contiguous()     # (K, C_out, C_in)
    h = h.contiguous()
    x = x.float().contiguous()
    b, _, t = x.shape
    out = torch.empty(b, c_out, t, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().t2_conv_bn_act(
        x.data_ptr(), w.data_ptr(), h.data_ptr(), out.data_ptr(), b, c_in,
        c_out, t, k, ACTS[act], int(wdtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"conv_bn_act: launch failed with CUDA error "
                           f"{err}")
    conv_bn_act.launches += 1
    return out


conv_bn_act.launches = 0
