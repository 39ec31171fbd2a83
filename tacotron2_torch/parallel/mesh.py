"""Device lists and placement for data parallelism.

Counterpart of ``tacotron2_tpu/parallel/mesh.py``.  There a ``Mesh`` over
the chips and sharding annotations let GSPMD place everything.  Here:

* :func:`make_mesh` returns a :class:`Mesh`, a list of devices along the
  ``data`` axis, for single-process replica serving
  (``infer/sharded.py``);
* :func:`shard_batch` cuts a batch to one rank's rows;
* :func:`shard_params` / :func:`shard_train_state` broadcast the model, its
  BatchNorm statistics, the Adam moments, the counters and the dropout
  generator from rank 0, so that every rank starts bit-equal.

Tensor parallelism (the JAX package's ``model`` axis, ``_tp_spec_for_path``
and ``param_shardings(tensor_parallel=True)``) is not ported: ``n_model``
above 1 raises (ROADMAP, A16-TP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .collectives import broadcast_object, broadcast_tensors

TP_LEFT_OUT = ("tensor parallelism is not ported (ROADMAP A16-TP): on the "
               "JAX side it turns the decoder kernels off for the scan "
               "path, and the port runs data parallelism only")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices along the ``data`` axis; the ``model`` axis is always 1."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": 1}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A data mesh over the first ``n_data`` of ``devices`` (default:
    every CUDA card).  The same device may stand more than once (replicas
    that share a card)."""
    if n_model != 1:
        raise NotImplementedError(f"n_model={n_model}: {TP_LEFT_OUT}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() without devices needs CUDA; "
                               "pass devices=['cpu', ...] for the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n_data = len(devices) if n_data is None else n_data
    if not 0 < n_data <= len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} exceeds "
                         f"{len(devices)} devices")
    return Mesh(tuple(devices[:n_data]))


def shard_batch(batch: Dict[str, object], rank: int, world: int
                ) -> Dict[str, object]:
    """Rows ``[rank * b, (rank + 1) * b)`` of every array of ``batch``,
    ``b = B / world``; None entries stay None."""
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = v
            continue
        n = v.shape[0]
        if n % world:
            raise ValueError(f"batch of {n} rows does not split over "
                             f"{world} ranks")
        b = n // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out


def shard_params(model: nn.Module) -> nn.Module:
    """Overwrite ``model``'s parameters and buffers with rank 0's, in
    place; returns the model.  A no-op in a single process."""
    with torch.no_grad():
        broadcast_tensors([p.data for p in model.parameters()]
                          + list(model.buffers()))
    return model


def shard_train_state(state):
    """Rank 0's train state on every rank, in place: the model, the Adam
    moments and update count, ``step``, ``loss_step`` and the dropout
    generator's state.  Returns the state."""
    shard_params(state.model)
    opt = state.opt_state
    broadcast_tensors([opt[m][n] for m in ("mu", "nu") for n in sorted(opt[m])])
    count, state.step, state.loss_step, gen = broadcast_object(
        (int(opt["count"]), state.step, state.loss_step,
         state.generator.get_state()))
    opt["count"] = count
    state.generator.set_state(gen)
    return state
