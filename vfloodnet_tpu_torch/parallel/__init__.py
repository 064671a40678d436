"""Multi-GPU (counterpart of ``vfloodnet_tpu.parallel``): the process
mesh over a ``torch.distributed`` world (``mesh``), and the feature bank
sharded on its capacity axis over the mesh's ``model`` axis, its read
(``sharded_read``: the bank read and count kernels on each shard, an
all-reduce combine) and its update (``sharded_update``)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, Mesh, close_world, init_local_world,
                   init_rank, make_mesh)
from .sharded_read import (shard_bank_state, shard_occ_bound,
                           sharded_bank_attention_read)
from .sharded_update import sharded_bank_merge_append

__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "close_world",
           "init_local_world", "init_rank", "make_mesh", "shard_bank_state",
           "shard_occ_bound", "sharded_bank_attention_read",
           "sharded_bank_merge_append"]
