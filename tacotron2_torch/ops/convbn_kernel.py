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
version, the same arithmetic step by step, folding on every call.  Serving
only: training keeps the unfused Conv1d + batch-statistics BatchNorm of
``models/layers.py``.

The kernel takes the fold from :func:`folded_weights`, which keeps it on
the layer, already rounded and in the kernel's layout, until a tensor it
was made from changes (see there), so a call with the fold cached is one
launch.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import BatchNorm, Conv1d
from . import _build

ACTS = {"none": 0, "relu": 1, "tanh": 2}
TILE = 64          # output channels (and time steps) of the kernel's tile
CHUNK = 32         # the folded weights' C_in is padded to whole chunks
MAX_TAPS = 9       # the kernel stages 4 steps on either side of a tile


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_bn_act")
    lib.t2_conv_bn_act.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.t2_conv_bn_act.restype = ctypes.c_int
    lib.t2_conv_bn_act_weight_map.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.t2_conv_bn_act_weight_map.restype = ctypes.c_int
    lib.t2_conv_bn_act_clusters.argtypes = [ctypes.c_int] * 4
    lib.t2_conv_bn_act_clusters.restype = ctypes.c_int
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


@dataclass
class Fold:
    """A layer's fold in the kernel's layout: ``w`` (K, C_out_pad,
    C_in_pad) in the weight dtype, rounded once, zero past (C_out, C_in),
    with C_out_pad a multiple of ``TILE`` and C_in_pad of ``CHUNK``; ``h``
    (C_out,) fp32; ``wmap`` the TMA tensor map of ``w`` (bf16 weights on
    the card only).  ``key`` and ``sources`` (weak references to the
    storages it was made from) say what it was made from."""
    w: torch.Tensor
    h: torch.Tensor
    wmap: Optional[ctypes.Array] = None
    key: tuple = ()
    sources: tuple = ()


# one fold per layer, dropped with the layer
_FOLDS: "weakref.WeakKeyDictionary[Conv1d, Fold]" = weakref.WeakKeyDictionary()


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


@torch.no_grad()
def _make_fold(conv: Conv1d, bn: BatchNorm, eps: float) -> Fold:
    wmat, h = fold_conv_bn(conv, bn, eps)
    k, c_in, c_out = wmat.shape
    w = torch.zeros(k, _ceil_to(c_out, TILE), _ceil_to(c_in, CHUNK),
                    dtype=conv.weight.dtype, device=conv.weight.device)
    w[:, :c_out, :c_in] = wmat.permute(0, 2, 1)          # rounded once
    fold = Fold(w, h.contiguous())
    if w.is_cuda and w.dtype == torch.bfloat16:
        fold.wmap = ctypes.create_string_buffer(128)
        err = _lib().t2_conv_bn_act_weight_map(
            w.data_ptr(), k, w.shape[1], w.shape[2],
            ctypes.addressof(fold.wmap))
        if err != 0:
            raise RuntimeError(f"conv_bn_act: the weights' tensor map failed "
                               f"with error {err}")
    return fold


def folded_weights(conv: Conv1d, bn: BatchNorm, eps: float) -> Fold:
    """The layer's fold for the kernel, made once and kept while nothing it
    was made from changes.

    The key is ``eps`` and, for each of ``conv.weight``, ``conv.bias``,
    ``bn.weight``, ``bn.bias``, ``bn.running_mean`` and ``bn.running_var``,
    its address, version counter, dtype and device, and its storage.  An
    in-place write (an optimizer step, ``load_state_dict``'s copy, a
    train-mode BatchNorm update) bumps the version; a new tensor
    (``load_state_dict`` with ``assign``, ``cast_params_bf16``,
    ``.to(dtype)``, ``.to(device)``) has another storage, even where it
    takes a freed one's address.  The fold holds its sources' storages
    through weak references only, so a replaced weight is freed.  A write
    through ``.data`` bumps no version and is not seen; inference tensors
    carry no version, so their fold is made on every call."""
    tensors = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
               bn.running_var)
    if any(t is not None and t.is_inference() for t in tensors):
        return _make_fold(conv, bn, eps)
    key = (eps,) + tuple(
        None if t is None else (t.data_ptr(), t._version, t.dtype, t.device)
        for t in tensors)
    fold = _FOLDS.get(conv)
    if fold is None or fold.key != key or any(
            t is not None and ref() is not t.untyped_storage()
            for t, ref in zip(tensors, fold.sources)):
        fold = _make_fold(conv, bn, eps)
        fold.key = key
        fold.sources = tuple(None if t is None
                             else weakref.ref(t.untyped_storage())
                             for t in tensors)
        _FOLDS[conv] = fold
    return fold


SPLITS = (1, 2, 4, 8)


def split_count(b: int, t: int, c_in: int, c_out: int,
                capacity: Tuple[int, ...]) -> int:
    """Blocks of a cluster that share one output tile's C_in: the largest
    of ``SPLITS``, up to the number of C_in chunks, for which the launch's
    clusters all fit on the card at once (``capacity[i]``: clusters of
    ``SPLITS[i]`` blocks the card holds), else 1.  One short request's 8
    tiles get 8 blocks each; a launch that fills the card alone is not
    split."""
    tiles = b * -(-t // TILE) * -(-c_out // TILE)
    chunks = -(-c_in // CHUNK)
    split = 1
    for s, clusters in zip(SPLITS, capacity):
        if s <= chunks and tiles <= clusters:
            split = s
    return split


@functools.lru_cache(maxsize=None)
def _capacity(device: torch.device, is_bf16: bool, x_bf16: bool, k: int
              ) -> Tuple[int, ...]:
    with torch.cuda.device(device):
        n = tuple(_lib().t2_conv_bn_act_clusters(int(is_bf16), int(x_bf16),
                                                 k, s) for s in SPLITS)
    if min(n) <= 0:
        raise RuntimeError(f"conv_bn_act: occupancy query gave {n}")
    return n


def launch_split(x: torch.Tensor, conv: Conv1d) -> int:
    """The split :func:`conv_bn_act` launches with for this CUDA input."""
    c_out, c_in, k = conv.weight.shape
    return split_count(x.shape[0], x.shape[2], c_in, c_out, _capacity(
        x.device, conv.weight.dtype == torch.bfloat16,
        x.dtype == torch.bfloat16, k))


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
    x (B, C_in, T) at any strides, fp32 or the weight dtype -> (B, C_out,
    T) fp32.

    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise): one launch a call once the layer's fold is made.  Kernel
    sizes up to ``MAX_TAPS``, odd or even, with 'same' padding as
    ``models/layers.py::conv1d_same`` pads: ``(k - 1) // 2`` steps before,
    ``k // 2`` after.  ``conv_bn_act.launches`` counts launches."""
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
    if k > MAX_TAPS:
        raise ValueError(f"conv_bn_act takes kernel sizes up to {MAX_TAPS} "
                         f"(the input is staged with 4 steps on either side "
                         f"of a tile); got {k}")
    if conv.weight.device != x.device or bn.running_var.device != x.device:
        raise ValueError("conv_bn_act: weights and input on different "
                         "devices")
    return _launch(x, folded_weights(conv, bn, eps), act,
                   launch_split(x, conv))


def _launch(x: torch.Tensor, fold: Fold, act: str, split: int
            ) -> torch.Tensor:
    """One launch of the kernel on a made fold, ``split`` blocks a tile."""
    k, c_out_pad, c_in_pad = fold.w.shape
    c_out = fold.h.shape[0]
    b, c_in, t = x.shape
    out = torch.empty(b, c_out, t, device=x.device)
    err = _lib().t2_conv_bn_act(
        x.data_ptr(), *x.stride(), int(x.dtype == torch.bfloat16),
        fold.w.data_ptr(),
        None if fold.wmap is None else ctypes.addressof(fold.wmap),
        fold.h.data_ptr(), out.data_ptr(), b, c_in, c_out,
        t, k, c_out_pad, c_in_pad, ACTS[act],
        int(fold.w.dtype == torch.bfloat16), split,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_bn_act: launch failed with CUDA error "
                           f"{err}")
    conv_bn_act.launches += 1
    return out


conv_bn_act.launches = 0
