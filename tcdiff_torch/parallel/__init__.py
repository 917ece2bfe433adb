"""Data and tensor parallelism over torch.distributed (`mesh`: the group,
the (dp, tp) mesh and each rank's rows; `comm`: the collectives;
`sharding_rules`: the Megatron split of the train state over tp, imported
from its module)."""

from tcdiff_torch.parallel.comm import (  # noqa: F401
    all_gather_rows, all_reduce_grads_, all_reduce_mean, from_previous, tp_copy, tp_gather, tp_reduce, tp_slice,
)
from tcdiff_torch.parallel.mesh import (  # noqa: F401
    Mesh, Rows, draw, init_distributed, is_host0, make_mesh, shard_batch,
)
