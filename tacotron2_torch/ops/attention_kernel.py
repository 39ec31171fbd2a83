"""Attention tail: energies -> masked softmax -> context, one decode step.

Replaces the Pallas kernel ``tacotron2_tpu/ops/attention_kernel.py::
attention_tail``.  The forward is the kernel; the backward, which the JAX
package writes in plain ``jnp`` (``_attention_tail_bwd``), is plain PyTorch
here (:class:`_AttentionTail`):

    e    = energy_scale * (tanh(qsum) . v_w + v_b)      # (B, T_enc)
    e    = where(mask, -1e9, e)
    attn = softmax(e)                                   # over T_enc
    ctx  = attn @ memory                                # (B, D)

Dtype policy (the Pallas kernel's): ``qsum`` arrives in the compute dtype
and is upcast before an fp32 tanh; energies and softmax are fp32;
``memory`` is read in the compute dtype of ``qsum`` and the context is
summed in fp32.

The kernel (``csrc/attention_tail.cu``, CUDA C++) splits each batch item's
T_enc across a thread-block cluster of up to eight blocks, starts the copy
of its ``memory`` rows before the energies, combines the softmax and
reduce-scatters the context through distributed shared memory; its source
note has the design and its bound (bytes).  :func:`tail_plan` picks the
split and the tiles on the host, so that the CPU tests can check them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build

THREADS = 256            # the kernel's block
MAX_SPLIT = 8            # portable cluster size
MIN_ROWS = 4             # rows a block takes before an item is split further
MAX_ITEMS = 65535        # batch items a launch (grid rows); more launch again
STAGE_BYTES = 64 * 1024  # memory rows a ring stage holds, at most
SMEM_LIMIT = 232448      # shared memory a block may take on an H100
HEAD_BYTES = 256         # the kernel's barriers and softmax statistics
_FLOATS = (torch.float32, torch.bfloat16)
# the kernel's dtype flags: bf16 where the bit is set, else fp32
Q_BF16, MEM_BF16, VW_BF16, VB_BF16, SCALE_BF16 = 1, 2, 4, 8, 16


class TailPlan(NamedTuple):
    """Block ``r`` of an item's cluster of ``split`` takes T_enc rows
    ``[r * rows, min((r + 1) * rows, T_enc))``, staging ``memory`` in tiles
    of ``tile_rows`` rows through ``stages`` ring stages; ``smem_bytes`` is
    the block's shared memory."""
    split: int
    rows: int
    tile_rows: int
    stages: int
    smem_bytes: int


def _up16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=None)
def tail_plan(b: int, t_enc: int, a: int, d: int,
              mem_dtype: torch.dtype) -> TailPlan:
    """The launch plan for qsum (b, t_enc, a) and memory (b, t_enc, d) of
    ``mem_dtype``.  Splits an item into the most blocks (a power of two up
    to ``MAX_SPLIT``) that keep ``MIN_ROWS`` rows each and leave no block
    empty; tiles of memory rows, each padded to 16 bytes, fill at most
    ``STAGE_BYTES``, evened out.  The kernel takes any A and D; raises on
    a memory dtype other than fp32 or bf16, an empty shape, and a memory
    row too wide for a stage or for a block's shared memory."""
    if mem_dtype not in _FLOATS:
        raise TypeError(f"attention_tail: memory dtype {mem_dtype}")
    if min(b, t_enc, a, d) < 1:
        raise ValueError(f"attention_tail: shapes B={b} T_enc={t_enc} "
                         f"A={a} D={d}")
    row_bytes = _up16(d * mem_dtype.itemsize)
    if row_bytes > STAGE_BYTES:
        raise ValueError(f"attention_tail: a memory row of D={d} is "
                         f"{row_bytes} bytes, more than a ring stage's "
                         f"{STAGE_BYTES}")
    split = 1
    while (split < MAX_SPLIT and 2 * split <= -(-t_enc // MIN_ROWS)
           and (2 * split - 1) * -(-t_enc // (2 * split)) < t_enc):
        split *= 2
    rows = -(-t_enc // split)
    n_tiles = -(-rows // (STAGE_BYTES // row_bytes))
    tile_rows = -(-rows // n_tiles)
    stages = 1 if n_tiles == 1 else 2
    cols = -(-d // split)       # the context's columns a block sums
    smem = (HEAD_BYTES + stages * tile_rows * row_bytes + _up16(4 * d)
            + _up16(4 * split * cols) + 2 * _up16(4 * tile_rows))
    if smem > SMEM_LIMIT:
        raise ValueError(f"attention_tail: D={d} needs {smem} bytes of "
                         f"shared memory a block, more than {SMEM_LIMIT}")
    return TailPlan(split, rows, tile_rows, stages, smem)


def attention_tail_reference(qsum: torch.Tensor, v_w: torch.Tensor,
                             v_b: torch.Tensor, energy_scale: torch.Tensor,
                             mask: torch.Tensor, memory: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version with the kernel's dtype policy.

    qsum (B, T, A) compute dtype; v_w (A,); v_b, energy_scale 0-d;
    mask (B, T) bool, True = pad; memory (B, T, D).
    Returns (attn (B, T) fp32, ctx (B, D) fp32).
    """
    f = torch.promote_types(qsum.dtype, torch.float32)
    th = torch.tanh(qsum.to(f))
    e = (th @ v_w.to(f) + v_b.to(f)) * energy_scale.to(f)
    e = e.masked_fill(mask, -1e9)
    attn = torch.softmax(e, dim=1)
    mem = memory.to(qsum.dtype).to(f)
    ctx = torch.einsum("bt,btd->bd", attn, mem)
    return attn, ctx


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("attention_tail")
    lib.t2_attention_tail.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.t2_attention_tail.restype = ctypes.c_int
    lib.t2_attention_tail_smem.argtypes = [ctypes.c_int] * 5
    lib.t2_attention_tail_smem.restype = ctypes.c_longlong
    return lib


def _outputs(b: int, t: int, d: int, device: torch.device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """attn (b, t) and ctx (b, d), fp32.  Two allocations: one buffer cut
    into two views was no faster on an H100's host (PERF.md)."""
    return (torch.empty(b, t, device=device),
            torch.empty(b, d, device=device))


def _launch(qsum, v_w, v_b, energy_scale, mask, memory, plan: TailPlan
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on checked, contiguous CUDA tensors."""
    b, t, a = qsum.shape
    d = memory.shape[2]
    attn, ctx = _outputs(b, t, d, qsum.device)
    bf16 = torch.bfloat16
    flags = ((qsum.dtype == bf16) * Q_BF16 | (memory.dtype == bf16) * MEM_BF16
             | (v_w.dtype == bf16) * VW_BF16 | (v_b.dtype == bf16) * VB_BF16
             | (energy_scale.dtype == bf16) * SCALE_BF16)
    err = _lib().t2_attention_tail(
        qsum.data_ptr(), v_w.data_ptr(), v_b.data_ptr(),
        energy_scale.data_ptr(), mask.data_ptr(), memory.data_ptr(),
        attn.data_ptr(), ctx.data_ptr(), b, t, a, d, plan.split, plan.rows,
        plan.tile_rows, flags,
        # PyTorch's current stream as a handle: torch.cuda.current_stream()
        # builds a Stream object first, 6 us of a 20 us call (PERF.md)
        torch._C._cuda_getCurrentRawStream(qsum.device.index))
    if err != 0:
        raise RuntimeError(f"attention_tail: launch failed with CUDA error "
                           f"{err}")
    attention_tail.launches += -(-b // MAX_ITEMS)
    return attn, ctx


def _forward(qsum: torch.Tensor, v_w: torch.Tensor, v_b: torch.Tensor,
             energy_scale: torch.Tensor, mask: torch.Tensor,
             memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = qsum.device
    if dev.type == "cpu":
        return attention_tail_reference(qsum, v_w, v_b, energy_scale, mask,
                                        memory)
    if dev.type != "cuda":
        raise ValueError(f"attention_tail: unsupported device {dev}")
    if (qsum.dtype not in _FLOATS or memory.dtype not in _FLOATS
            or mask.dtype != torch.bool or v_w.dtype not in _FLOATS
            or v_b.dtype not in _FLOATS
            or energy_scale.dtype not in _FLOATS):
        raise TypeError(f"attention_tail: dtypes qsum {qsum.dtype}, memory "
                        f"{memory.dtype}, mask {mask.dtype}, v {v_w.dtype} "
                        f"{v_b.dtype}, scale {energy_scale.dtype}")
    b, t, a = qsum.shape
    shape = memory.shape
    if (len(shape) != 3 or shape[0] != b or shape[1] != t
            or mask.shape != (b, t) or v_w.shape != (a,)
            or v_b.numel() != 1 or energy_scale.numel() != 1):
        raise ValueError("attention_tail: shape mismatch "
                         f"{tuple(qsum.shape)} {tuple(shape)} "
                         f"{tuple(mask.shape)} {tuple(v_w.shape)}")
    for x in (v_w, v_b, energy_scale, mask, memory):
        if x.device != dev:
            raise ValueError("attention_tail: tensors on different devices")
    return _launch(qsum.contiguous(), v_w.contiguous(), v_b, energy_scale,
                   mask.contiguous(), memory.contiguous(),
                   tail_plan(b, t, a, shape[2], memory.dtype))


class _AttentionTail(torch.autograd.Function):
    """The tail with its analytic backward: the softmax/tanh chain in
    closed form, fp32 throughout, ``d_e`` zeroed under the mask.  Each
    gradient comes back in its input's dtype, so ``d_memory`` stays fp32
    when ``memory`` came in fp32 (as it does even under bf16 compute: it
    is the encoder's whole gradient signal)."""

    @staticmethod
    def forward(ctx, qsum, v_w, v_b, energy_scale, mask, memory):
        attn, context = _forward(qsum, v_w, v_b, energy_scale, mask, memory)
        ctx.save_for_backward(qsum, v_w, v_b, energy_scale, mask, memory,
                              attn)
        return attn, context

    @staticmethod
    def backward(ctx, d_attn_out, d_ctx):
        qsum, v_w, v_b, energy_scale, mask, memory, attn = ctx.saved_tensors
        d_attn_out, d_ctx = d_attn_out.float(), d_ctx.float()
        th = torch.tanh(qsum.float())                        # (B, T, A)
        pre = th @ v_w.float() + v_b.float()
        d_attn = d_attn_out + torch.einsum("bd,btd->bt", d_ctx,
                                           memory.float())
        d_memory = torch.einsum("bt,bd->btd", attn, d_ctx)
        d_e = attn * (d_attn - (d_attn * attn).sum(dim=1, keepdim=True))
        d_e = d_e.masked_fill(mask, 0.0)                     # -1e9 branch
        d_scale = (d_e * pre).sum()
        d_pre = d_e * energy_scale.float()
        d_v_b = d_pre.sum()
        d_v_w = torch.einsum("bta,bt->a", th, d_pre)
        d_qsum = d_pre[..., None] * v_w.float() * (1.0 - th * th)
        return (d_qsum.to(qsum.dtype), d_v_w.to(v_w.dtype),
                d_v_b.to(v_b.dtype).reshape(v_b.shape),
                d_scale.to(energy_scale.dtype).reshape(energy_scale.shape),
                None, d_memory.to(memory.dtype))


def attention_tail(qsum: torch.Tensor, v_w: torch.Tensor, v_b: torch.Tensor,
                   energy_scale: torch.Tensor, mask: torch.Tensor,
                   memory: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same signature and returns as :func:`attention_tail_reference`,
    differentiable in ``qsum``, ``v_w``, ``v_b``, ``energy_scale`` and
    ``memory``.

    CPU tensors take the plain version; CUDA tensors launch the CUDA
    kernel (or raise).  Where no gradient is wanted (serving runs under
    ``torch.no_grad``) the autograd function is left out.
    ``attention_tail.launches`` counts launches.
    """
    if torch.is_grad_enabled() and (
            qsum.requires_grad or v_w.requires_grad or v_b.requires_grad
            or energy_scale.requires_grad or memory.requires_grad):
        return _AttentionTail.apply(qsum, v_w, v_b, energy_scale, mask,
                                    memory)
    return _forward(qsum, v_w, v_b, energy_scale, mask, memory)


attention_tail.launches = 0
