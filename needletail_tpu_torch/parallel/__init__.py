"""Scale-out on ``torch.distributed``: meshes, sharded count tables,
collectives.

Counterpart of ``needletail_tpu/parallel``.  One process drives one device
(NCCL on the card, gloo on the CPU where the caller asks): each rank
frames its own byte range of the input and steps its own read shard, the
count tables merge with reduce-scatters and all-reduces on the mesh's
groups (``DeviceMesh`` dims ``("data", "table")``), and every driver
returns the whole result on every rank, bit-identical to the flat
drivers'.  Start the group with ``distributed.initialize`` and end it with
``distributed.shutdown``.
"""

from .exact import ShardedSpectrumAccumulator, sharded_count_file
from .multik import ShardedMultiKAccumulator, sharded_multi_k_count_file
from .mesh import make_mesh, mesh_shape_for
from .sharded import (
    CountState,
    HashCountState,
    init_count_state,
    make_hash_update_step,
    sharded_hash_count_file,
    sharded_spectrum,
    update_count_state,
)

__all__ = [
    "make_mesh",
    "mesh_shape_for",
    "CountState",
    "init_count_state",
    "update_count_state",
    "sharded_spectrum",
    "HashCountState",
    "make_hash_update_step",
    "sharded_hash_count_file",
    "ShardedSpectrumAccumulator",
    "sharded_count_file",
    "ShardedMultiKAccumulator",
    "sharded_multi_k_count_file",
]
