"""Row-partitioned (domain) execution over a mesh of D logical shards
(counterpart of amg_tpu/parallel/dist.py).

The reference's distributed substrate is hypre ParCSR row partitions; the
JAX package row-shards its operators and vectors over a 1-D device mesh.
The port's mesh (`RowMesh`) has D logical shards, D the reference's
`num_devices`, fixed apart from the number of cards: the results depend on D
(rows pad to a multiple of D, the halo pattern and its ghost slots follow
the D row blocks), and one card holds all D shards as well as D cards hold
one each. A process owns D / world_size consecutive shards; a row-sharded
vector is the process's (D / world_size, n_loc) block of rows, stored flat,
so that the cycles, smoothers and solvers run on it unchanged:

  * one process (world_size 1): the stacked block is the whole padded
    vector; the halo operators (`parallel.spcomm`, `parallel.halo`) move
    their boundary segments between shards by tensor indexing on the device,
    and dots and norms are the plain ones;
  * several processes (`parallel.multihost.init_multihost`): the halo
    exchange crosses processes through the process group (NCCL between
    cards, gloo between CPU processes), dots and norms are all-reduced and
    the replicated coarse inverse applies to the all-gathered coarse vector
    (`ReplicatedInverse`).

comm="gspmd" (the reference lets XLA insert collectives into plain sharded
ELL/BSR operators) is, in one process, the padded single-device computation,
which is what GSPMD computes; the structured hierarchy likewise
(`shard_structured_hierarchy`). Neither is ported across processes: both
raise under world_size > 1 (ROADMAP queue 1 item 11c).

Grid (level) parallelism lays its levels over the same mesh: whole shards
per level group (`parallel.grid`), or, for the extended system, each level
block padded to the shard range of its group (`pad_extended_layout`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device

# the multi-device routes that run in one process only (ROADMAP item 11c)
NOT_PORTED_ACROSS_PROCESSES = (
    "{what} runs in one process only (the padded single-device computation "
    "that GSPMD computes); across processes it is ROADMAP queue 1 item 11c"
)


@dataclass(eq=False)
class RowMesh:
    """D logical shards on `device`, spread over the processes of `group`
    (None: one process), D / world_size consecutive shards to each.
    `trace` is the open `comm_trace` log (None when none is open)."""

    n_devices: int
    device: torch.device
    group: Any = None
    rank: int = 0
    world_size: int = 1
    trace: Optional[list] = None

    @property
    def local_devices(self) -> int:
        """The shards this process owns."""
        return self.n_devices // self.world_size

    @property
    def first_shard(self) -> int:
        return self.rank * self.local_devices

    def owner(self, shard: int) -> int:
        """The rank (in the group) that owns `shard`."""
        return shard // self.local_devices

    def global_rank(self, rank: int) -> int:
        """A group rank as the global rank torch.distributed's point-to-point
        calls take."""
        return torch.distributed.get_global_rank(self.group, rank)

    def local_rows(self, n: int) -> slice:
        """This process's rows of a length-n row-sharded vector."""
        if n % self.n_devices:
            raise ValueError(f"{n} rows do not split over {self.n_devices} shards")
        per = n // self.world_size
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_vector(self, x) -> torch.Tensor:
        """This process's rows of a global vector, on the mesh's device."""
        x = torch.as_tensor(x)
        return x[self.local_rows(x.shape[0])].to(self.device)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global vector of a row-sharded one, in every process."""
        if self.world_size == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        torch.distributed.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def _sum(self, s: torch.Tensor) -> torch.Tensor:
        torch.distributed.all_reduce(s, group=self.group)
        return s

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.world_size == 1:
            return torch.dot(a, b)
        return self._sum(torch.dot(a, b))

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        if self.world_size == 1:
            return torch.linalg.norm(x)
        return torch.sqrt(self._sum(torch.dot(x, x)))

    def require_one_process(self, what: str) -> None:
        if self.world_size > 1:
            raise NotImplementedError(NOT_PORTED_ACROSS_PROCESSES.format(what=what))


def make_row_mesh(n_devices: Optional[int] = None, device=None, group=None) -> RowMesh:
    """A mesh of `n_devices` logical shards (None: one per process) on
    `device` (None: the CUDA device; raises without one). `group` is the
    process group the shards spread over; None takes the default group when
    torch.distributed is initialized, else one process. n_devices must be a
    multiple of the group's size."""
    device = resolve_device(device)
    dist = torch.distributed
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    D = world if n_devices is None else int(n_devices)
    if D < 1 or D % world:
        raise ValueError(f"a {D}-shard mesh does not split over {world} processes")
    return RowMesh(n_devices=D, device=device, group=group if world > 1 else None,
                   rank=rank, world_size=world)


def shard_vector(x, mesh: RowMesh) -> torch.Tensor:
    return mesh.shard_vector(x)


class ReplicatedInverse:
    """The dense coarse inverse, replicated in every process, applied to a
    row-sharded coarse vector: all-gather, one matmul, this process's rows
    (the reference's gathered direct coarse solve)."""

    def __init__(self, inv: torch.Tensor, mesh: RowMesh):
        self.inv = inv
        self.mesh = mesh

    @property
    def device(self) -> torch.device:
        return self.inv.device

    @property
    def dtype(self) -> torch.dtype:
        return self.inv.dtype

    def __matmul__(self, r: torch.Tensor) -> torch.Tensor:
        full = self.mesh.gather(r)
        return (self.inv @ full)[self.mesh.local_rows(full.shape[0])]


def _pad_csr(m, n_rows_pad: int, n_cols_pad: int, unit_diag_from: int = -1):
    """A host CSRMatrix padded to (n_rows_pad, n_cols_pad); with
    unit_diag_from >= 0 the rows from it on get a unit diagonal (square
    operators: the pad rows decouple and smoothers stay defined)."""
    import scipy.sparse as sp

    from amg_tpu_torch.sparse.csr import CSRMatrix

    s = m.to_scipy().tocoo()
    rows, cols, data = s.row, s.col, s.data
    if unit_diag_from >= 0 and n_rows_pad > unit_diag_from:
        d = np.arange(unit_diag_from, n_rows_pad)
        rows = np.concatenate([rows, d])
        cols = np.concatenate([cols, d])
        data = np.concatenate([data, np.ones(d.size, dtype=s.data.dtype)])
    out = sp.coo_matrix((data, (rows, cols)), shape=(n_rows_pad, n_cols_pad)).tocsr()
    return CSRMatrix.from_scipy(out)


def pad_unit(params, mesh: RowMesh) -> int:
    """The multiple every level's size pads to: D for ELL, 16 D where a
    blocked format may be chosen (covers every tile height)."""
    D = mesh.n_devices
    return D if params.device_format == "ell" else 16 * D


def _operator_converter(params, mesh: RowMesh, comm: str):
    """csr, dtype -> the device operator of a padded level matrix: the halo
    operators for comm="halo" (HaloBSR where the format is "bsr_auto", the
    cost model picks a tile and the shape divides D tiles; else HaloELL --
    the port's "auto" is ELL, PERF.md), the plain ELL / BSR of the
    single-device hierarchy for comm="gspmd"."""
    from amg_tpu_torch.convert import matrix_from_arrays
    from amg_tpu_torch.parallel.spcomm import build_halo_bsr, build_halo_ell
    from amg_tpu_torch.setup.hierarchy import _format_converter
    from amg_tpu_torch.sparse.bsr import choose_bsr_shape

    D = mesh.n_devices
    if comm == "gspmd":
        fmt = _format_converter(params)
        return lambda m, dtype: matrix_from_arrays(fmt(m), dtype, mesh.device)

    def convert(m, dtype):
        if params.device_format == "bsr_auto":
            shape, _ = choose_bsr_shape(m)
            if shape is not None and m.n_rows % (D * shape[0]) == 0 \
                    and m.n_cols % (D * shape[1]) == 0:
                return build_halo_bsr(m, mesh, bm=shape[0], bn=shape[1], dtype=dtype)
        return build_halo_ell(m, mesh, dtype=dtype)

    return convert


def build_dist_hierarchy(hh, params, mesh: RowMesh, comm: str = "gspmd"):
    """The device hierarchy of a host hierarchy with every level padded to a
    multiple of the mesh (`pad_unit`; pad rows decoupled with a unit
    diagonal), row-sharded: (Hierarchy, pad_info) with pad_info =
    (n0, padded n0) for `pad_vector` / `unpad_vector`.

    comm="halo": HaloELL / HaloBSR operators with the setup-time
    boundary-segment pattern (`parallel.spcomm`), the reference's comm-pkg
    halo exchange. comm="gspmd": plain ELL / BSR on the padded levels (one
    process only). Smoother state is built on the padded matrices; the
    coarsest level is the dense inverse of its padded matrix, replicated.
    Across processes only the Jacobi-family smoothers are ported (a block
    smoother's blocks would straddle the processes' rows)."""
    from amg_tpu_torch.setup.hierarchy import Hierarchy, Level
    from amg_tpu_torch.smooth.smoothers import (
        BLOCK_TYPES,
        make_smoother_data,
        smoother_data_from_arrays,
    )

    if comm not in ("gspmd", "halo"):
        raise ValueError(f"unknown comm {comm!r} (the port has 'halo' and 'gspmd')")
    if comm == "gspmd":
        mesh.require_one_process('comm="gspmd"')
    if mesh.world_size > 1 and params.smoother in BLOCK_TYPES:
        raise NotImplementedError(
            f"the {params.smoother.value} smoother across processes: "
            + NOT_PORTED_ACROSS_PROCESSES.format(what="a block smoother"))
    dtype = params.dtype
    convert = _operator_converter(params, mesh, comm)
    unit = pad_unit(params, mesh)
    sizes = [lv.A.n_rows for lv in hh.levels]
    psizes = [-(-n // unit) * unit for n in sizes]
    levels = []
    for k, hl in enumerate(hh.levels):
        n, np_n = sizes[k], psizes[k]
        A_pad = _pad_csr(hl.A, np_n, np_n, unit_diag_from=n)
        sm = make_smoother_data(A_pad, params.smoother, w=hl.weight,
                                block_size=params.block_size,
                                jgs_weight=params.jgs_weight)
        if mesh.world_size > 1:
            rows = mesh.local_rows(np_n)
            sm = dict(sm, scale=sm["scale"][rows], inv_wscale=sm["inv_wscale"][rows])
        nc_pad = psizes[k + 1] if k + 1 < len(sizes) else None

        def cv(mtx, rows, cols):
            return None if mtx is None else convert(_pad_csr(mtx, rows, cols), dtype)

        levels.append(Level(
            A=convert(A_pad, dtype),
            P=cv(hl.P, np_n, nc_pad),
            R=cv(hl.R, nc_pad, np_n),
            sm=smoother_data_from_arrays(sm, dtype, mesh.device),
            P_s=cv(hl.P_s, np_n, nc_pad),
            R_s=cv(hl.R_s, nc_pad, np_n),
            P_id=cv(hl.P_id, np_n, nc_pad),
            R_id=cv(hl.R_id, nc_pad, np_n),
        ))
    A_coarse = _pad_csr(hh.levels[-1].A, psizes[-1], psizes[-1], unit_diag_from=sizes[-1])
    inv = torch.from_numpy(np.linalg.inv(A_coarse.to_dense())).to(device=mesh.device,
                                                                  dtype=dtype)
    hier = Hierarchy(levels=tuple(levels), coarse_Ainv=inv)
    return shard_hierarchy(hier, mesh), (sizes[0], psizes[0])


def pad_vector(x, pad_info, mesh: RowMesh) -> torch.Tensor:
    """A global length-n vector zero-padded to the padded size, this
    process's rows of it on the mesh's device."""
    n, npad = pad_info
    x = torch.as_tensor(x)
    return mesh.shard_vector(torch.nn.functional.pad(x, (0, npad - n)))


def unpad_vector(x: torch.Tensor, pad_info, mesh: Optional[RowMesh] = None) -> torch.Tensor:
    """The first n rows of a padded row-sharded vector (gathered first when
    the mesh spans several processes)."""
    if mesh is not None:
        x = mesh.gather(x)
    return x[: pad_info[0]]


def shard_hierarchy(hier, mesh: RowMesh):
    """A generic hierarchy as the mesh's row-sharded one: the mesh attached
    (its solves reduce over it) and, across processes, the coarse inverse
    applied to the gathered coarse vector. The halo operators are built
    sharded (`build_dist_hierarchy`); plain ELL / BSR levels are the gspmd
    route, in one process only. A stencil level raises, as in the
    reference (the stencil's own halo form is `parallel.halo`)."""
    from amg_tpu_torch.parallel.spcomm import HaloBSR, HaloELL
    from amg_tpu_torch.sparse.bsr import BSRMatrix
    from amg_tpu_torch.sparse.ell import ELLMatrix

    for lv in hier.levels:
        if not isinstance(lv.A, (ELLMatrix, BSRMatrix, HaloELL, HaloBSR)):
            raise ValueError(
                "shard_hierarchy needs ELL/BSR operators on every level; build with "
                "HierarchyParams(keep_stencil_fine=False)")
        if not isinstance(lv.A, (HaloELL, HaloBSR)):
            mesh.require_one_process("the gspmd route (plain ELL/BSR levels)")
    inv = hier.coarse_Ainv
    if mesh.world_size > 1 and not isinstance(inv, ReplicatedInverse):
        inv = ReplicatedInverse(inv, mesh)
    return hier._replace(coarse_Ainv=inv, mesh=mesh)


def pad_extended_layout(level_sizes, assignment, num_devices):
    """The static layout of grid parallelism on the extended system: each
    level block placed inside the shard range of its assigned devices,
    padded so that a plain num_devices-way row split of the flat vector puts
    level k's rows exactly on assignment[k]'s shards (the reference's
    AssignProcs communicator split, src/DMEM_Setup.cpp:1638-1759). Returns
    (padded_offsets, padded_total, row_owner): padded_offsets has L + 1
    entries (block k spans [padded_offsets[k], padded_offsets[k + 1]), its
    data rows first, its padding after), row_owner[i] is the level owning
    padded row i (-1: padding)."""
    L = len(level_sizes)
    assert len(assignment) == L

    def clamp(k):
        s, e = assignment[k]
        s = min(max(s, 0), num_devices - 1)
        e = min(max(e, s + 1), num_devices)
        return s, e

    # the shard row count: every device fits its share of its levels
    need = np.zeros(num_devices, np.int64)
    for k in range(L):
        s, e = clamp(k)
        need[s:e] += -(-level_sizes[k] // (e - s))
    S = int(max(need.max(), 1))
    starts = np.zeros(L, np.int64)
    cursor = np.zeros(num_devices, np.int64)
    for k in range(L):  # levels arrive in increasing device order
        s, e = clamp(k)
        starts[k] = s * S + cursor[s]
        left = level_sizes[k]
        for d in range(s, e):
            take = min(S - cursor[d], left)
            cursor[d] += take
            left -= take
        assert left == 0, "shard size too small for assignment"
    padded_total = num_devices * S
    padded_offsets = list(starts) + [padded_total]
    for k in range(1, L):
        assert padded_offsets[k] >= padded_offsets[k - 1] + level_sizes[k - 1]
    row_owner = np.full(padded_total, -1, np.int32)
    for k in range(L):
        row_owner[padded_offsets[k]: padded_offsets[k] + level_sizes[k]] = k
    return tuple(int(o) for o in padded_offsets), padded_total, row_owner


def shard_structured_hierarchy(hier, mesh: RowMesh):
    """A structured (geometric) hierarchy on the mesh. The reference splits
    the grid arrays along the major axis and lets GSPMD insert the stencil
    halos, which computes the single-device iteration; in one process that
    is the hierarchy itself, with the mesh attached. Across processes it
    raises (ROADMAP item 11c; the explicit plane exchange is
    `parallel.halo`)."""
    mesh.require_one_process("the sharded structured hierarchy")
    return hier._replace(mesh=mesh)
