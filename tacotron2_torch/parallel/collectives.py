"""The collectives that make the port's batch reductions global.

The port's stand-in for ``tacotron2_tpu/ops/meshing.py``.  Under GSPMD
every reduction over the batch axis is global on its own (BatchNorm's
moments, the loss's denominators, the gradient psum, the gate-stop AND,
``tacotron2_tpu/parallel/mesh.py:1-18``).  In PyTorch each rank holds only
its rows, so each of those reductions is made global here, by hand.

Two autograd-aware all-reduces, which differ only in their backward:

* :func:`all_reduce_sum_grad` has a SUM backward.  Use it where each
  rank's downstream is local and only the partials differ: BatchNorm's
  moments, as in ``torch.nn.SyncBatchNorm``.  Every rank's outputs depend
  on every rank's inputs, so an input's gradient is the sum of the
  ranks' output gradients.
* :func:`all_reduce_replicated` has an identity backward.  Use it where
  every rank then computes the same replicated value, such as the loss
  from global sums: each rank's backward already holds the whole
  gradient of that value with respect to its own partial, and a SUM
  backward would multiply every gradient by the number of ranks.

The kernels need no wrapper like ``shard_over_batch``
(``tacotron2_tpu/ops/meshing.py:78-123``): each rank launches its kernels
on its own rows.  The batch-reduced scale/bias accumulator of kernel #4,
which the JAX side psums (``reduce_out=(8,)``,
``tacotron2_tpu/ops/decoder_bwd_kernel.py:252-259``), is a parameter
gradient here, summed across ranks with the others by
:func:`all_reduce_gradients`.

Every function is the identity in a single process (no group, or a group
of one).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

_local_only = False


def is_distributed() -> bool:
    """True under a process group of more than one rank, outside
    :func:`local_only`."""
    return (not _local_only and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


@contextlib.contextmanager
def local_only():
    """Within, every function here acts as in a single process: one rank
    works alone while the others wait (``train(debug_overfit=True)``)."""
    global _local_only
    before, _local_only = _local_only, True
    try:
        yield
    finally:
        _local_only = before


def data_axis_size() -> int:
    """The number of ranks; 1 without a group."""
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    """This rank; 0 without a group."""
    return dist.get_rank() if is_distributed() else 0


def _summed(x: torch.Tensor) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y)
    return y


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g)


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _summed(x)

    @staticmethod
    def backward(ctx, g):
        return g


def all_reduce_sum_grad(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, whose backward is the sum over ranks too."""
    return _SumGrad.apply(x) if is_distributed() else x


def all_reduce_replicated(x: torch.Tensor) -> torch.Tensor:
    """The sum over ranks, whose backward is the identity (the result is
    replicated: every rank goes on to compute the same value)."""
    return _Replicated.apply(x) if is_distributed() else x


def global_sums(*xs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Several scalars summed over ranks in one :func:`all_reduce_replicated`
    call; returned unchanged in a single process."""
    if not is_distributed():
        return xs
    return all_reduce_replicated(torch.stack(
        [x.float().reshape(()) for x in xs])).unbind(0)


def all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The element-wise maximum over ranks (no gradient), in x's dtype.
    Exact for integers below 2**24, which go through float32."""
    if not is_distributed():
        return x
    y = x.detach().float().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y.to(x.dtype)


def _flat(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on ``tensors`` as one flat buffer per
    dtype, and copy the result back."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def all_reduce_gradients(grads: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Sum a ``{name: gradient}`` dict over ranks, in place, in one flat
    all-reduce (the gradient psum of the JAX step); returned unchanged in a
    single process.  Every rank must hold the same names."""
    if is_distributed() and grads:
        _flat([grads[n] for n in sorted(grads)], dist.all_reduce)
    return grads


@torch.no_grad()
def broadcast_tensors(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with rank ``src``'s, in one flat
    broadcast per dtype."""
    if is_distributed() and tensors:
        _flat(tensors, lambda flat: dist.broadcast(flat, src))


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    if is_distributed():
        dist.barrier()
