"""The model axis of the decoder's sharded products, with two back ends.

Under tensor parallelism the two decoder LSTMs' gate rows and the fused
heads' input columns are split over the ``model`` axis
(``parallel/mesh.py::tp_spec_for_name``).  ``models/layers.py`` runs each
sharded product as one partial product a shard and asks the decoder's
axis (``Decoder.model_axis``) for the four things that cross shards:

* ``copy_in(*xs)``: the replicated inputs of a gate-split product, one
  tuple a shard;
* ``gather_out(parts)``: the shards' gate slices, concatenated in model
  order;
* ``split_in(x)``: each shard's contiguous slice of the heads' input;
* ``reduce_out(parts)``: the sum of the shards' partial head products;

and ``shards(names, local)`` gives the weights each part multiplies by:
``local`` (the module's own tensors, which are this rank's or the lead
device's shard) first, then those of the peers the back end holds.

:class:`LocalAxis` is an unsharded decoder's: one shard, the whole
weights, and the four are identities, so an unsharded step runs the same
operations in the same order as before sharding existed.
:class:`GroupAxis` (training): the peers are ranks of the model group, and
each rank holds one shard; the four are the autograd ops of
``parallel/collectives.py``.  :class:`DeviceAxis` (serving, one process,
no gradient): the peers are devices, each holding its shards, moved there
once; inputs go to each device with ``.to`` and the results come back to
the lead device, which sums the head parts in model order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .collectives import (copy_to_model, gather_from_model,
                          reduce_from_model, split_to_model)

Parts = List[torch.Tensor]


class LocalAxis:
    """The model axis of an unsharded decoder: one shard, held here."""

    sharded = False

    @staticmethod
    def shards(names: Sequence[str], local: Tuple[torch.Tensor, ...]
               ) -> List[Tuple[torch.Tensor, ...]]:
        return [local]

    @staticmethod
    def copy_in(*xs: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        return [xs]

    @staticmethod
    def split_in(x: torch.Tensor) -> Parts:
        return [x]

    @staticmethod
    def gather_out(parts: Parts) -> torch.Tensor:
        return parts[0]

    @staticmethod
    def reduce_out(parts: Parts) -> torch.Tensor:
        return parts[0]


LOCAL = LocalAxis()


class GroupAxis:
    """The model axis of a process group: one shard on this rank."""

    sharded = True

    @staticmethod
    def shards(names: Sequence[str], local: Tuple[torch.Tensor, ...]
               ) -> List[Tuple[torch.Tensor, ...]]:
        return [local]

    @staticmethod
    def copy_in(*xs: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        return [copy_to_model(*xs)]

    @staticmethod
    def split_in(x: torch.Tensor) -> Parts:
        return [split_to_model(x)]

    @staticmethod
    def gather_out(parts: Parts) -> torch.Tensor:
        return gather_from_model(parts[0])

    @staticmethod
    def reduce_out(parts: Parts) -> torch.Tensor:
        return reduce_from_model(parts[0])


class DeviceAxis:
    """The model axis over ``devices`` in one process; ``devices[0]`` is
    the lead, where the module's own shard and everything replicated lie.
    ``peers[name]`` holds the shards of model index 1, 2, ... of each
    sharded tensor, each on its device."""

    sharded = True

    def __init__(self, devices: Sequence[torch.device],
                 peers: Dict[str, List[torch.Tensor]]):
        self.devices = [torch.device(d) for d in devices]
        self.peers = peers

    @property
    def size(self) -> int:
        return len(self.devices)

    def shards(self, names: Sequence[str], local: Tuple[torch.Tensor, ...]
               ) -> List[Tuple[torch.Tensor, ...]]:
        return [local] + [tuple(self.peers[n][i] for n in names)
                          for i in range(self.size - 1)]

    def copy_in(self, *xs: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
        return [xs] + [tuple(x.to(d) for x in xs) for d in self.devices[1:]]

    def split_in(self, x: torch.Tensor) -> Parts:
        k = x.shape[-1] // self.size
        return [x[..., m * k:(m + 1) * k].to(d)
                for m, d in enumerate(self.devices)]

    def gather_out(self, parts: Parts) -> torch.Tensor:
        lead = self.devices[0]
        return torch.cat([p.to(lead) for p in parts], dim=-1)

    def reduce_out(self, parts: Parts) -> torch.Tensor:
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(self.devices[0])
        return acc
