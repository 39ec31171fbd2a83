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

Under tensor parallelism (``parallel/distributed.py::init_tensor_parallel``)
the ranks form a grid of ``data`` x ``model``, rank ``r`` at
``(r // tp, r % tp)`` as the JAX package's ``make_mesh`` lays its devices
out.  Every reduction above then runs over the DATA group (the ranks of
this rank's model index): model peers hold the same rows and the same
replicated values, and the parameter shards that share a name across
model indices are different tensors, which a world sum would add.  The
four model-axis ops (:func:`copy_to_model`, :func:`gather_from_model`,
:func:`split_to_model`, :func:`reduce_from_model`) run over the MODEL
group (the ranks of this rank's data index) and carry the decoder's
sharded products (``models/layers.py``).

Every function is the identity in a single process (no group, or a group
of one).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

_local_only = False


@dataclasses.dataclass(frozen=True)
class GridLayout:
    """This rank's place on the ``data`` x ``model`` grid and its two
    groups: ``data_group`` holds the ranks of its model index, ``model_group``
    those of its data index."""
    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: object
    model_group: object


_layout: Optional[GridLayout] = None


def set_grid_layout(layout: Optional[GridLayout]) -> None:
    """Install the grid (``parallel/distributed.py::init_tensor_parallel``);
    None goes back to data parallelism over every rank."""
    global _layout
    _layout = layout


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


def _grid() -> Optional[GridLayout]:
    return _layout if is_distributed() else None


def world_size() -> int:
    """The number of ranks in the whole group; 1 without a group."""
    return dist.get_world_size() if is_distributed() else 1


def world_rank() -> int:
    """This rank in the whole group; 0 without a group."""
    return dist.get_rank() if is_distributed() else 0


def data_axis_size() -> int:
    """The width of the ``data`` axis: the number of ranks, divided by the
    tensor-parallel width under a grid; 1 without a group."""
    grid = _grid()
    return grid.n_data if grid else world_size()


def rank() -> int:
    """This rank's index along the ``data`` axis (its rank without a grid);
    0 without a group.  The rank that writes files is :func:`world_rank`
    0."""
    grid = _grid()
    return grid.data_index if grid else world_rank()


def model_axis_size() -> int:
    """The tensor-parallel width; 1 without a grid."""
    grid = _grid()
    return grid.n_model if grid else 1


def model_index() -> int:
    """This rank's index along the ``model`` axis; 0 without a grid."""
    grid = _grid()
    return grid.model_index if grid else 0


def _data_group():
    """The group the batch reductions run over (None: every rank)."""
    grid = _grid()
    return grid.data_group if grid else None


def _summed(x: torch.Tensor) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=_data_group())
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
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=_data_group())
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
def all_reduce_gradients(grads: Dict[str, torch.Tensor],
                         sharded: FrozenSet[str] = frozenset()
                         ) -> Dict[str, torch.Tensor]:
    """Sum a ``{name: gradient}`` dict over the data axis, in place, in one
    flat all-reduce (the gradient psum of the JAX step); returned unchanged
    in a single process.  Every rank must hold the same names.

    Under a grid the sum runs over the ranks of this model index, whose
    shards of a tensor-parallel parameter are the same shard; then every
    model peer takes model index 0's gradients of the parameters not in
    ``sharded`` (one flat broadcast over the model group).  Each peer
    computes those on its own from the same values, and a kernel whose
    sums are not deterministic (cuDNN's fp32 convolution backward on the
    card) would otherwise let the peers' replicated state drift apart."""
    if is_distributed() and grads:
        group = _data_group()
        _flat([grads[n] for n in sorted(grads)],
              lambda flat: dist.all_reduce(flat, group=group))
        grid = _grid()
        if grid and grid.n_model > 1:
            lead = world_rank() - grid.model_index
            _flat([grads[n] for n in sorted(grads) if n not in sharded],
                  lambda flat: dist.broadcast(flat, lead,
                                              group=grid.model_group))
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


# --------------------------------------------------------------------------
# the model axis: the four autograd ops of the sharded decoder products
# --------------------------------------------------------------------------
def _model_sum(x: torch.Tensor) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=_grid().model_group)
    return y


def _model_slice(x: torch.Tensor) -> torch.Tensor:
    """This model index's contiguous part of the last axis."""
    k = x.shape[-1] // model_axis_size()
    return x[..., model_index() * k:(model_index() + 1) * k]


def gather_model_axis(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The model peers' shards concatenated along ``dim`` in model order
    (no gradient).  Written as an all-reduce of zero-padded shards, which
    gloo runs on CUDA tensors too; a shard plus zeros is exact."""
    n = model_axis_size()
    if n == 1:
        return x
    dim = dim % x.dim()
    k = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = k * n
    y = x.new_zeros(shape)
    y.narrow(dim, model_index() * k, k).copy_(x)
    dist.all_reduce(y, group=_grid().model_group)
    return y


class _CopyToModel(torch.autograd.Function):
    """Forward identity, backward the sum over the model peers: the
    replicated input of a gate-split product, whose gradient each peer
    holds only for its own gates."""
    @staticmethod
    def forward(ctx, *xs):
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = _model_sum(torch.cat([g.reshape(-1) for g in gs]))
        out, offset = [], 0
        for g in gs:
            out.append(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return tuple(out)


class _GatherFromModel(torch.autograd.Function):
    """Forward the peers' gate slices concatenated, backward this rank's
    slice of the gradient."""
    @staticmethod
    def forward(ctx, x):
        return gather_model_axis(x)

    @staticmethod
    def backward(ctx, g):
        return _model_slice(g).contiguous()


class _SplitToModel(torch.autograd.Function):
    """Forward this rank's slice of a replicated input, backward the
    peers' slice gradients concatenated."""
    @staticmethod
    def forward(ctx, x):
        return _model_slice(x).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_model_axis(g)


class _ReduceFromModel(torch.autograd.Function):
    """Forward the sum of the peers' partial products, backward the
    identity (the sum is replicated)."""
    @staticmethod
    def forward(ctx, x):
        return _model_sum(x)

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_model(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """:class:`_CopyToModel` over several inputs (one all-reduce in the
    backward)."""
    return _CopyToModel.apply(*xs)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    return _GatherFromModel.apply(x)


def split_to_model(x: torch.Tensor) -> torch.Tensor:
    return _SplitToModel.apply(x)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x)


@torch.no_grad()
def model_axis_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model peers (no gradient); ``x`` alone without a
    grid."""
    return _model_sum(x) if model_axis_size() > 1 else x
