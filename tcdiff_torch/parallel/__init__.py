"""Data parallelism over torch.distributed (`mesh`: the group, the mesh
and each rank's rows; `comm`: the collectives)."""

from tcdiff_torch.parallel.comm import all_gather_rows, all_reduce_grads_, all_reduce_mean, from_previous  # noqa: F401
from tcdiff_torch.parallel.mesh import (  # noqa: F401
    Mesh, Rows, draw, init_distributed, is_host0, make_mesh, shard_batch,
)
