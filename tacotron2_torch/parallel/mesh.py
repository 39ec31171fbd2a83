"""Device grids and placement for data and tensor parallelism.

Counterpart of ``tacotron2_tpu/parallel/mesh.py``.  There a ``Mesh`` over
the chips and sharding annotations let GSPMD place everything.  Here:

* :func:`make_mesh` returns a :class:`Mesh`, a ``data`` x ``model`` grid
  of devices, for single-process serving (``infer/sharded.py``);
* :func:`shard_batch` cuts a batch to one data index's rows;
* :func:`tp_spec_for_name` and :func:`param_shardings` give the JAX
  package's tensor-parallel layout (``_tp_spec_for_path``) in the port's
  tensor layouts: the attention- and decoder-LSTM weights and biases split
  on the 4H gate axis (dim 0 of PyTorch's ``(4H, in)``), the decoder's
  projection and gate heads on their input axis (dim 1 of ``(out,
  in)``), everything else replicated;
* :func:`shard_params` / :func:`shard_train_state` broadcast the model,
  its BatchNorm statistics, the Adam moments, the counters and the dropout
  generator from rank 0, so that every rank starts bit-equal; with
  ``shard_train_state(tensor_parallel=True)`` each rank then keeps only
  its model index's shard of each sharded parameter and of its two
  moments (the JAX package places the moments by matching shapes, which
  gives each the layout of its parameter), and its decoder gets the
  group's model axis;
* :func:`gather_params` / :func:`gather_train_state` put the whole
  tensors back together, for a checkpoint with the layout of an unsharded
  run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, FrozenSet, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from .collectives import (broadcast_object, broadcast_tensors,
                          gather_model_axis, model_axis_size, model_index)
from .model_axis import GroupAxis

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices on a ``data`` x ``model`` grid: ``devices[d][m]``."""
    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices), "model": len(self.devices[0])}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A ``(n_data, n_model)`` grid over the first ``n_data * n_model`` of
    ``devices`` (default: every CUDA card), in the JAX package's order:
    device ``i`` at ``(i // n_model, i % n_model)``.  ``n_data`` defaults
    to as many rows as the devices fill.  The same device may stand more
    than once (replicas or shards that share a card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() without devices needs CUDA; "
                               "pass devices=['cpu', ...] for the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"mesh {n_data}x{n_model} exceeds "
                         f"{len(devices)} devices")
    return Mesh(tuple(tuple(devices[d * n_model:(d + 1) * n_model])
                      for d in range(n_data)))


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


# --------------------------------------------------------------------------
# the tensor-parallel layout
# --------------------------------------------------------------------------
def _jax_tp_spec(path) -> Spec:
    """``tacotron2_tpu/parallel/mesh.py::_tp_spec_for_path`` on a path of
    the JAX package's parameter tree, as a tuple."""
    keys = [str(k) for k in path]
    if "attn_lstm" in keys or "dec_lstm" in keys:
        if keys[-1] in ("wi", "wh"):
            return (None, "model")
        if keys[-1] in ("bi", "bh"):
            return ("model",)
    if ("proj" in keys or "gate" in keys) and keys[-1] == "w" \
            and "decoder" in keys:
        return ("model", None)
    return ()


@functools.lru_cache(maxsize=None)
def _port_specs(cfg) -> Dict[str, Spec]:
    from ..utils.weights import param_pairs
    out = {}
    for path, key, transpose in param_pairs(cfg):
        spec = _jax_tp_spec(path)
        out[key] = tuple(reversed(spec)) if transpose else spec
    return out


def tp_spec_for_name(name: str, cfg=None) -> Spec:
    """The tensor-parallel layout of the port's tensor ``name`` (a
    ``state_dict`` key): the JAX package's spec for the same tensor, read
    through the weight bridge's pairs (``utils/weights.py::param_pairs``)
    and transposed with it.  ``("model", None)`` splits dim 0, ``(None,
    "model")`` dim 1, ``()`` replicates."""
    from ..config import ModelConfig
    return _port_specs(cfg or ModelConfig()).get(name, ())


def param_shardings(model: nn.Module, tensor_parallel: bool = False
                    ) -> Dict[str, Spec]:
    """``{parameter name: spec}``: every parameter replicated, or the
    tensor-parallel layout."""
    return {n: tp_spec_for_name(n, model.cfg) if tensor_parallel else ()
            for n, _ in model.named_parameters()}


def _split_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def sharded_names(model: nn.Module) -> FrozenSet[str]:
    """The parameters a tensor-parallel model holds a shard of; empty for
    an unsharded model."""
    if not model.decoder.model_axis.sharded:
        return frozenset()
    return frozenset(n for n, s in param_shardings(model, True).items()
                     if _split_dim(s) is not None)


def shard_of(t: torch.Tensor, spec: Spec, m: int, n: int,
             name: str = "") -> torch.Tensor:
    """Model index ``m``'s contiguous part of ``t`` under ``spec`` of
    ``n`` shards (a copy; ``t`` itself where ``spec`` replicates)."""
    dim = _split_dim(spec)
    if dim is None:
        return t
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not "
                         f"split over {n} shards")
    k = size // n
    return t.narrow(dim, m * k, k).clone()


@torch.no_grad()
def _keep_shards(model: nn.Module, moments) -> None:
    """Under a grid, replace each sharded parameter (and its entry in each
    dict of ``moments``) by this rank's shard and give the decoder the
    group's model axis."""
    n = model_axis_size()
    if n == 1:
        return
    m = model_index()
    for name, spec in param_shardings(model, True).items():
        if _split_dim(spec) is None:
            continue
        p = model.get_parameter(name)
        p.data = shard_of(p.data, spec, m, n, name)
        for moment in moments:
            moment[name] = shard_of(moment[name], spec, m, n, name)
    model.decoder.model_axis = GroupAxis()


def shard_params(model: nn.Module) -> nn.Module:
    """Overwrite ``model``'s parameters and buffers with rank 0's, in
    place; returns the model.  A no-op in a single process."""
    with torch.no_grad():
        broadcast_tensors([p.data for p in model.parameters()]
                          + list(model.buffers()))
    return model


def shard_train_state(state, tensor_parallel: bool = False):
    """Rank 0's train state on every rank, in place: the model, the Adam
    moments and update count, ``step``, ``loss_step`` and the dropout
    generator's state; with ``tensor_parallel`` under a grid, this rank's
    shards of the sharded parameters and of their moments.  The state must
    hold whole tensors (a fresh or restored state).  Returns the state."""
    shard_params(state.model)
    opt = state.opt_state
    broadcast_tensors([opt[m][n] for m in ("mu", "nu") for n in sorted(opt[m])])
    count, state.step, state.loss_step, gen = broadcast_object(
        (int(opt["count"]), state.step, state.loss_step,
         state.generator.get_state()))
    opt["count"] = count
    state.generator.set_state(gen)
    if tensor_parallel:
        _keep_shards(state.model, (opt["mu"], opt["nu"]))
    return state


def _whole(model: nn.Module, tensors: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter or buffer name) with each shard put back
    together over the model group."""
    names = sharded_names(model)
    specs = param_shardings(model, True)
    return {k: gather_model_axis(v, _split_dim(specs[k])) if k in names
            else v for k, v in tensors.items()}


@torch.no_grad()
def gather_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's ``state_dict`` with each shard put back together over
    the model group (a collective: every rank of the grid calls it); the
    ``state_dict`` itself for an unsharded model."""
    return _whole(model, model.state_dict())


@torch.no_grad()
def gather_train_state(state):
    """The whole train state of a tensor-parallel run, on the CPU, in the
    layout of an unsharded one (a collective: every rank of the grid calls
    it); ``state`` itself when its model is unsharded."""
    if not sharded_names(state.model):
        return state
    from ..models.tacotron2 import Tacotron2
    from ..train.state import TrainState
    model = Tacotron2(state.model.cfg)
    model.load_state_dict(gather_params(state.model), strict=True)
    opt = state.opt_state
    whole = lambda m: {k: v.cpu() for k, v in
                       _whole(state.model, opt[m]).items()}
    return TrainState(model=model,
                      opt_state={"count": opt["count"], "mu": whole("mu"),
                                 "nu": whole("nu")},
                      step=state.step, loss_step=state.loss_step,
                      generator=state.generator)
