"""Data parallelism: the process group, its collectives and placement."""

from .collectives import (all_reduce_gradients, all_reduce_max,
                          all_reduce_replicated, all_reduce_sum_grad,
                          data_axis_size, global_sums, is_distributed, rank)
from .distributed import (distributed_env_configured, initialize_distributed,
                          rank_device)
from .mesh import Mesh, make_mesh, shard_batch, shard_params, shard_train_state

__all__ = ["make_mesh", "Mesh", "shard_batch", "shard_params",
           "shard_train_state", "initialize_distributed",
           "distributed_env_configured", "rank_device",
           "all_reduce_sum_grad", "all_reduce_replicated", "global_sums",
           "all_reduce_max", "all_reduce_gradients", "data_axis_size",
           "rank", "is_distributed"]
