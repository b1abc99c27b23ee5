"""Multi-device training (port of ``gan_lib_tensorflow_tpu/parallel``):
the mesh over the process group ('data', 'model', 'sp'), the sharding rules
and host -> device prefetch."""

from .mesh import (Mesh, active, barrier, create_mesh, init_distributed, is_writer,
                   sharded_step)
from .prefetch import prefetch_to_device
from .sharding import (ModelShards, data_rows, gather_height, global_batch, height_rows,
                       height_shards, local_rows, shard_batch, split_height, sum_over_data,
                       sum_over_sp, tensor_parallel_spec, train_state_shardings)

__all__ = ["Mesh", "ModelShards", "active", "barrier", "create_mesh", "data_rows",
           "gather_height", "global_batch", "height_rows", "height_shards",
           "init_distributed", "is_writer", "local_rows", "prefetch_to_device",
           "shard_batch", "sharded_step", "split_height", "sum_over_data", "sum_over_sp",
           "tensor_parallel_spec", "train_state_shardings"]
