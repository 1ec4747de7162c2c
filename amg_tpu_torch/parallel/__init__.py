"""Row-partitioned (domain) multi-device execution (counterpart of the row
parts of amg_tpu/parallel/): a mesh of D logical shards, the halo-exchange
operators, the distributed hierarchy and the multi-process setup. The grid
(level) parallel parts come with ROADMAP queue 1 item 11b."""

from amg_tpu_torch.parallel.dist import (
    RowMesh,
    build_dist_hierarchy,
    make_row_mesh,
    pad_vector,
    shard_hierarchy,
    shard_structured_hierarchy,
    shard_vector,
    unpad_vector,
)
from amg_tpu_torch.parallel.halo import (
    HaloStencilOperator,
    halo_jacobi_sweep,
    halo_stencil_matvec,
    make_halo_stencil,
)
from amg_tpu_torch.parallel.multihost import global_mesh_info, init_multihost
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
