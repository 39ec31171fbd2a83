"""Multi-process data parallelism: joining the process group.

Counterpart of ``tacotron2_tpu/parallel/distributed.py``.  PyTorch runs one
process per card: ``torchrun --nproc_per_node N train_torch.py ...`` starts
N ranks and gives each ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.
:func:`initialize_distributed` joins them into one process group and is a
no-op in a single process; :func:`rank_device` gives each rank its card.

The backend is NCCL when every rank of a host has a card of its own, and
gloo when ranks share a card (two ranks on one card: NCCL refuses two
ranks on one device) or run on the CPU.  Under gloo the kernels still run
on the card; only the collectives go through the host.

Tensor parallelism (``--tp N``): :func:`init_tensor_parallel` lays the
ranks out on a ``data`` x ``model`` grid, rank ``r`` at ``(r // N, r % N)``
(the JAX package's ``make_mesh`` reshapes its devices the same way), and
makes the two subgroups every collective of ``parallel/collectives.py``
needs.

The JAX package's ``global_batch_from_local`` has no counterpart: PyTorch
has no global array.  Each rank keeps only its own rows, and every
reduction over the batch that the JAX package gets global from GSPMD is
made global by hand (``parallel/collectives.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from .collectives import GridLayout, set_grid_layout, world_size


def distributed_env_configured() -> bool:
    """True when a launcher (torchrun) set ``WORLD_SIZE`` above 1."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def default_backend() -> str:
    """``"nccl"`` when every rank of this host has a card of its own,
    ``"gloo"`` when ranks share a card or there is none."""
    if (torch.cuda.is_available() and dist.is_nccl_available()
            and _local_world_size() <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Join the process group if one is configured; returns whether
    distributed mode is active.

    With no arguments and ``WORLD_SIZE`` unset or 1 this does nothing.
    Otherwise the group is joined at ``init_method`` (default ``env://``,
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``); ``world_size`` and
    ``rank`` default to the environment's.  ``backend`` defaults to
    :func:`default_backend`.  A group already joined is kept."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None and world_size is None \
            and not distributed_env_configured():
        return False
    world_size = (int(os.environ.get("WORLD_SIZE", "1"))
                  if world_size is None else world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    backend = backend or default_backend()
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    print(f"[distributed] initialized: rank {rank}/{world_size}, backend "
          f"{backend}, local rank {_local_rank()} of {_local_world_size()}, "
          f"device {rank_device('cuda') if torch.cuda.is_available() else 'cpu'}",
          flush=True)
    return world_size > 1


def rank_device(device: Union[str, torch.device]) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    ``cuda:{LOCAL_RANK % device_count}``; anything else is kept."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None \
            or not torch.cuda.is_available():
        return device
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def init_tensor_parallel(tp: int) -> Optional[GridLayout]:
    """Lay the group's ranks out on a ``data`` x ``model`` grid of width
    ``tp`` along ``model`` and install it (``parallel/collectives.py``);
    ``tp`` 1 goes back to data parallelism over every rank (returns None).
    Every rank must call this with the same ``tp``: each makes every
    subgroup, in the same order, as ``dist.new_group`` requires.  Raises
    when ``tp`` does not divide the number of ranks."""
    world = world_size()
    if tp < 1 or world % tp:
        raise ValueError(f"tensor-parallel width {tp} does not divide the "
                         f"{world} ranks")
    if tp == 1:
        set_grid_layout(None)
        return None
    n_data, me = world // tp, dist.get_rank()
    d, m = divmod(me, tp)
    data_groups = [dist.new_group([dd * tp + mm for dd in range(n_data)])
                   for mm in range(tp)]
    model_groups = [dist.new_group([dd * tp + mm for mm in range(tp)])
                    for dd in range(n_data)]
    layout = GridLayout(n_data, tp, d, m, data_groups[m], model_groups[d])
    set_grid_layout(layout)
    return layout
