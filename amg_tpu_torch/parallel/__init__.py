"""Multi-device execution (counterpart of amg_tpu/parallel/) over a mesh of
D logical shards: row-partitioned (domain) parallelism, with the
halo-exchange operators, the distributed hierarchy and the multi-process
setup; and grid (level) parallelism, with the work model, the level ->
shard plan, the owned operator storage and the grid-parallel async solve."""

from amg_tpu_torch.parallel.dist import (
    RowMesh,
    build_dist_hierarchy,
    make_row_mesh,
    pad_extended_layout,
    pad_vector,
    shard_hierarchy,
    shard_structured_hierarchy,
    shard_vector,
    unpad_vector,
)
from amg_tpu_torch.parallel.grid import (
    build_grid_owned_storage,
    device_branch_fn,
    grid_parallel_solve,
    plan_grid_levels,
)
from amg_tpu_torch.parallel.halo import (
    HaloStencilOperator,
    halo_jacobi_sweep,
    halo_stencil_matvec,
    make_halo_stencil,
)
from amg_tpu_torch.parallel.multihost import global_mesh_info, init_multihost
from amg_tpu_torch.parallel.partition import assign_levels_to_devices, compute_level_work
from amg_tpu_torch.parallel.spcomm import (
    HaloBSR,
    HaloELL,
    build_halo_bsr,
    build_halo_ell,
    comm_trace,
)

__all__ = [
    "RowMesh",
    "make_row_mesh",
    "shard_vector",
    "pad_vector",
    "unpad_vector",
    "shard_hierarchy",
    "shard_structured_hierarchy",
    "build_dist_hierarchy",
    "pad_extended_layout",
    "compute_level_work",
    "assign_levels_to_devices",
    "plan_grid_levels",
    "build_grid_owned_storage",
    "grid_parallel_solve",
    "device_branch_fn",
    "HaloELL",
    "HaloBSR",
    "build_halo_ell",
    "build_halo_bsr",
    "comm_trace",
    "HaloStencilOperator",
    "halo_stencil_matvec",
    "halo_jacobi_sweep",
    "make_halo_stencil",
    "init_multihost",
    "global_mesh_info",
]
