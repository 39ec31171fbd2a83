"""Data and tensor parallelism: the process group and its grid, the
collectives and placement."""

from .collectives import (all_reduce_gradients, all_reduce_max,
                          all_reduce_replicated, all_reduce_sum_grad,
                          data_axis_size, global_sums, is_distributed,
                          model_axis_size, model_index, rank, world_rank,
                          world_size)
from .distributed import (distributed_env_configured, init_tensor_parallel,
                          initialize_distributed, rank_device)
from .mesh import (Mesh, gather_params, gather_train_state, make_mesh,
                   param_shardings, shard_batch, shard_params,
                   shard_train_state, tp_spec_for_name)

__all__ = ["make_mesh", "Mesh", "shard_batch", "shard_params",
           "shard_train_state", "gather_params", "gather_train_state",
           "param_shardings", "tp_spec_for_name", "initialize_distributed",
           "init_tensor_parallel", "distributed_env_configured",
           "rank_device", "all_reduce_sum_grad", "all_reduce_replicated",
           "global_sums", "all_reduce_max", "all_reduce_gradients",
           "data_axis_size", "model_axis_size", "model_index", "rank",
           "world_rank", "world_size", "is_distributed"]
