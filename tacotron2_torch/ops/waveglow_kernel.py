"""WaveGlow's WN layer: its elementwise work in two passes, the gate and
the residual and skip adds, with the biases of the products folded in.

No TPU kernel is replaced: the JAX package has no WaveGlow.  The three
products of a WN layer (``in_layers[i]``, the conditioning's slice of
``cond_layer``, ``res_skip_layers[i]``) run without their biases
(``models/waveglow.py::_wn``); these two passes add them:

    wn_gate(p, q, b_in, b_cond)     a = (p + b_in) + (q + b_cond)
                                    g = tanh(a[:, :C]) * sigmoid(a[:, C:])
    wn_res_skip(r, bias, x, skip)   r = r + bias
                                    r of 2C channels (below the last layer):
                                        x += r[:, :C], then r = r[:, C:]
                                    skip = r where skip is None, else
                                    skip += r

p and q are (B, 2C, N), r (B, 2C, N) or, on the last layer, (B, C, N); x
and skip (B, C, N).  The plain versions (:func:`wn_gate_reference`,
:func:`wn_res_skip_reference`) are the PyTorch passes the layer ran
before, in their order and type; the CPU runs them.  The CUDA kernels
(``csrc/waveglow_wn.cu``) give their bits, each tensor read and written
once; its source note has the design and the bytes.  ``wn_res_skip``
updates ``x`` and ``skip`` in place (the WN's own buffers) and returns
``skip``, a new tensor on the first layer.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import _build

_FLOATS = (torch.float32, torch.bfloat16)


def wn_gate_reference(p: torch.Tensor, q: torch.Tensor, b_in: torch.Tensor,
                      b_cond: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`wn_gate`."""
    a = (p + b_in[:, None]).add_(q + b_cond[:, None])
    c = a.shape[1] // 2
    return torch.tanh(a[:, :c]).mul_(torch.sigmoid(a[:, c:]))


def wn_res_skip_reference(r: torch.Tensor, bias: torch.Tensor,
                          x: torch.Tensor, skip: Optional[torch.Tensor]
                          ) -> torch.Tensor:
    """Plain PyTorch version of :func:`wn_res_skip`."""
    c = x.shape[1]
    r = r + bias[:, None]
    if r.shape[1] == 2 * c:
        x.add_(r[:, :c])
        r = r[:, c:]
    return r.contiguous() if skip is None else skip.add_(r)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("waveglow_wn")
    lib.t2_wn_gate.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                               + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    lib.t2_wn_gate.restype = ctypes.c_int
    lib.t2_wn_res_skip.argtypes = ([ctypes.c_void_p] * 4
                                   + [ctypes.c_int] * 6
                                   + [ctypes.c_longlong] * 6
                                   + [ctypes.c_void_p])
    lib.t2_wn_res_skip.restype = ctypes.c_int
    return lib


def _check(what: str, dtype: torch.dtype, device: torch.device,
           **tensors: torch.Tensor) -> None:
    """Every tensor of ``dtype`` (fp32 or bf16) on ``device``, its last
    dimension contiguous (the kernels address rows by their strides)."""
    if dtype not in _FLOATS:
        raise TypeError(f"{what}: dtype {dtype}; takes float32 or bfloat16")
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, not {dtype}")
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, not {device}")
        if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} has strides {t.stride()}; "
                             "its last dimension must be contiguous")


def _launched(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def wn_gate(p: torch.Tensor, q: torch.Tensor, b_in: torch.Tensor,
            b_cond: torch.Tensor) -> torch.Tensor:
    """g (B, C, N) of ``in_layers[i]``'s product ``p`` and the
    conditioning's ``q`` (B, 2C, N), both without bias, and their biases
    (2C,).  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise).  ``wn_gate.launches`` counts launches."""
    _check("wn_gate", p.dtype, p.device, p=p, q=q, b_in=b_in,
           b_cond=b_cond)
    if (p.dim() != 3 or p.shape[1] % 2 or q.shape != p.shape
            or b_in.shape != p.shape[1:2] or b_cond.shape != p.shape[1:2]):
        raise ValueError(f"wn_gate: shapes p {tuple(p.shape)}, q "
                         f"{tuple(q.shape)}, b_in {tuple(b_in.shape)}, "
                         f"b_cond {tuple(b_cond.shape)}")
    dev = p.device
    if dev.type == "cpu":
        return wn_gate_reference(p, q, b_in, b_cond)
    if dev.type != "cuda":
        raise ValueError(f"wn_gate: unsupported device {dev}")
    b, c2, n = p.shape
    g = p.new_empty(b, c2 // 2, n)
    if g.numel() == 0:
        return g
    _launched("wn_gate", _lib().t2_wn_gate(
        p.data_ptr(), q.data_ptr(), b_in.data_ptr(), b_cond.data_ptr(),
        g.data_ptr(), p.dtype == torch.bfloat16, b, c2 // 2, n,
        p.stride(0), p.stride(1), q.stride(0), q.stride(1), g.stride(0),
        g.stride(1), _stream(p)))
    wn_gate.launches += 1
    return g


def wn_res_skip(r: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                skip: Optional[torch.Tensor]) -> torch.Tensor:
    """Add ``res_skip_layers[i]``'s product ``r`` (B, 2C or C, N), without
    bias, and its ``bias`` into ``x`` and ``skip`` (B, C, N) in place;
    returns ``skip`` (a new tensor where ``skip`` is None).  ``r`` of C
    channels is the last layer's: ``x`` is left as it is.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise).
    ``wn_res_skip.launches`` counts launches."""
    more = {} if skip is None else {"skip": skip}
    _check("wn_res_skip", r.dtype, r.device, r=r, bias=bias, x=x, **more)
    if (x.dim() != 3 or r.dim() != 3 or r.shape[::2] != x.shape[::2]
            or r.shape[1] not in (x.shape[1], 2 * x.shape[1])
            or bias.shape != r.shape[1:2]
            or (skip is not None and skip.shape != x.shape)):
        raise ValueError(f"wn_res_skip: shapes r {tuple(r.shape)}, bias "
                         f"{tuple(bias.shape)}, x {tuple(x.shape)}, skip "
                         f"{None if skip is None else tuple(skip.shape)}")
    dev = r.device
    if dev.type == "cpu":
        return wn_res_skip_reference(r, bias, x, skip)
    if dev.type != "cuda":
        raise ValueError(f"wn_res_skip: unsupported device {dev}")
    b, c, n = x.shape
    out = x.new_empty(b, c, n) if skip is None else skip
    if out.numel() == 0:
        return out
    _launched("wn_res_skip", _lib().t2_wn_res_skip(
        r.data_ptr(), bias.data_ptr(), x.data_ptr(), out.data_ptr(),
        r.dtype == torch.bfloat16, b, c, n, r.shape[1] == 2 * c,
        skip is not None, r.stride(0), r.stride(1), x.stride(0), x.stride(1),
        out.stride(0), out.stride(1), _stream(r)))
    wn_res_skip.launches += 1
    return out


wn_gate.launches = 0
wn_res_skip.launches = 0
