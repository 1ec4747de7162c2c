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
    their boundary segments between shards by tensor indexing on the device;
  * several processes (`parallel.multihost.init_multihost`): the halo
    exchange crosses processes through the process group (NCCL between
    cards, gloo between CPU processes or, host-staged, between processes
    that share a card), and the replicated coarse inverse applies to the
    all-gathered coarse vector (`GatheredOperator`). Every collective is a
    `RowMesh` method.

Dots and norms (`RowMesh.dot`, `norm`) sum the D shards' own dots in shard
order in any process count, so a Krylov method's iterates depend on D and
not on how many processes hold the shards.

comm="gspmd" (the reference lets XLA insert collectives into plain sharded
ELL/BSR operators) is, in one process, the padded single-device computation,
which is what GSPMD computes; across processes each operator keeps its rows
and all-gathers its operand (`RowShardedMatrix`, `row_shard`). The
structured hierarchy likewise (`shard_structured_hierarchy`): in one
process the hierarchy itself; across processes the plane halo where a
level's leading axis splits over the shards, else the gathered form
(`GatheredOperator`): a plane-split level in the global operator's own
expression (`parallel.halo.make_structured_halo`). A block smoother's
blocks stay those of the global rows, each process applying all of them to
the gathered residual (`shard_smoother`). So every route across processes
computes what one process holding the D shards computes, bit for bit, but
LOBPCG's all-reduced Gram products.

Grid (level) parallelism lays its levels over the same mesh: whole shards
per level group (`parallel.grid`), or, for the extended system, each level
block padded to the shard range of its group (`pad_extended_layout`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device

@dataclass(eq=False)
class RowMesh:
    """D logical shards on `device`, spread over the processes of `group`
    (None: one process), D / world_size consecutive shards to each.
    `trace` is the open `comm_trace` log (None when none is open).

    Every collective of the port goes through the mesh's methods: `gather`
    (all-gather), `all_reduce`, `all_to_all` and `send_recv` (one batch of
    point-to-point sends and receives). `staged`: the group's backend cannot
    take the device's tensors (gloo with processes that share one card), so
    each collective copies its operands through host buffers; the
    arithmetic stays on the device. `sent_bytes` counts the bytes this
    process has handed the backend for other processes (its all-gather part
    once per peer, an all-reduced tensor once, its all-to-all rows and
    point-to-point sends to other processes): what crosses processes, where
    `parallel.spcomm.comm_trace` counts what moves between shards."""

    n_devices: int
    device: torch.device
    group: Any = None
    rank: int = 0
    world_size: int = 1
    trace: Optional[list] = None
    staged: bool = False
    sent_bytes: int = 0

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

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The buffer a collective hands the backend: t itself (contiguous),
        or its host copy where the mesh is staged."""
        return t.detach().to("cpu", copy=True) if self.staged else t.contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor of a row-sharded one (rows concatenated in rank
        order), in every process."""
        if self.world_size == 1:
            return x
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(self.world_size)]
        torch.distributed.all_gather(parts, w, group=self.group)
        self.sent_bytes += w.numel() * w.element_size() * (self.world_size - 1)
        return torch.cat(parts).to(x.device)

    def all_reduce(self, s: torch.Tensor) -> torch.Tensor:
        """The sum of `s` over the processes (a new tensor)."""
        if self.world_size == 1:
            return s
        w = self._wire(s) if self.staged else s.clone()
        torch.distributed.all_reduce(w, group=self.group)
        self.sent_bytes += w.numel() * w.element_size()
        return w.to(s.device)

    def all_to_all(self, inp: torch.Tensor) -> torch.Tensor:
        """inp (world_size, ...) rows by destination process -> the rows each
        process sent here, by source process."""
        w = self._wire(inp)
        out = torch.empty_like(w)
        torch.distributed.all_to_all_single(out, w, group=self.group)
        self.sent_bytes += w.numel() * w.element_size() * (self.world_size - 1) \
            // self.world_size
        return out.to(inp.device)

    def send_recv(self, sends, recvs) -> None:
        """One batch of point-to-point transfers: sends [(tensor, rank, tag)]
        and recvs [(tensor to fill, rank, tag)], ranks in the group. Every
        process posts its transfers with one peer in the same order."""
        dist = torch.distributed
        ops, fill = [], []
        for t, peer, tag in sends:
            w = self._wire(t)
            self.sent_bytes += w.numel() * w.element_size()
            ops.append(dist.P2POp(dist.isend, w, self.global_rank(peer), self.group, tag))
        for t, peer, tag in recvs:
            w = torch.empty(t.shape, dtype=t.dtype) if self.staged else t
            if self.staged:
                fill.append((t, w))
            ops.append(dist.P2POp(dist.irecv, w, self.global_rank(peer), self.group, tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for t, w in fill:
            t.copy_(w)

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a . b of two row-sharded vectors: each shard's dot (one shape and
        one kernel, whatever the process count), the D of them gathered in
        shard order and summed, so that the result depends on D alone: what
        one process holding all D shards computes, bit for bit."""
        L = self.local_devices
        parts = torch.stack([torch.dot(u, v) for u, v in zip(a.view(L, -1), b.view(L, -1))])
        return self.gather(parts).sum()

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(x, x))


def make_row_mesh(n_devices: Optional[int] = None, device=None, group=None) -> RowMesh:
    """A mesh of `n_devices` logical shards (None: one per process) on
    `device` (None: the CUDA device; raises without one). `group` is the
    process group the shards spread over; None takes the default group when
    torch.distributed is initialized, else one process. n_devices must be a
    multiple of the group's size. A CUDA device in a gloo group stages the
    collectives through host buffers (`RowMesh.staged`)."""
    device = resolve_device(device)
    dist = torch.distributed
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    D = world if n_devices is None else int(n_devices)
    if D < 1 or D % world:
        raise ValueError(f"a {D}-shard mesh does not split over {world} processes")
    staged = world > 1 and device.type == "cuda" and dist.get_backend(group) == "gloo"
    return RowMesh(n_devices=D, device=device, group=group if world > 1 else None,
                   rank=rank, world_size=world, staged=staged)


def shard_vector(x, mesh: RowMesh) -> torch.Tensor:
    return mesh.shard_vector(x)


def _gather_operand(mesh: RowMesh, x: torch.Tensor, n_cols: int) -> torch.Tensor:
    """The all-gathered operand of an operator with n_cols columns; an open
    `comm_trace` logs the bytes a shard's all-gather brings in."""
    if mesh.trace is not None:
        D = mesh.n_devices
        mesh.trace.append(n_cols * (D - 1) // D * x.element_size())
    return mesh.gather(x)


@dataclass(eq=False)
class RowShardedMatrix:
    """A plain ELL / BSR operator across processes (the gspmd route): this
    process's rows of it (`local`); `@` all-gathers the operand and applies
    them, which is what GSPMD computes for the reference's P(rows)-sharded
    operators. `shape` is the global one."""

    local: Any
    mesh: RowMesh
    shape: Tuple[int, int]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return self.local @ _gather_operand(self.mesh, x, self.shape[1])


@dataclass(eq=False)
class GatheredOperator:
    """A global operator across processes in its gathered form: the operand
    all-gathered where it is row-sharded (in_rows), the whole operator
    applied in every process, this process's rows of the result kept where
    the result is row-sharded (out_rows). What GSPMD computes for an
    operator whose arrays it replicates; the replicated dense coarse
    inverse of a row-sharded hierarchy is one (the reference's gathered
    direct coarse solve), whose device and dtype the hierarchy reports."""

    op: Any
    mesh: RowMesh
    in_rows: bool = True
    out_rows: bool = True

    @property
    def shape(self):
        return self.op.shape

    @property
    def device(self) -> torch.device:
        return self.op.device

    @property
    def dtype(self) -> torch.dtype:
        return self.op.dtype

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_rows:
            x = _gather_operand(self.mesh, x, self.shape[1])
        y = self.op @ x
        return y[self.mesh.local_rows(y.shape[0])] if self.out_rows else y


def row_shard(op, mesh: RowMesh):
    """This process's part of a global plain ELL / BSR operator whose row
    count is a multiple of the mesh (a `RowShardedMatrix`); a halo
    operator (built sharded), and None, unchanged."""
    from amg_tpu_torch.parallel.spcomm import HaloBSR, HaloELL
    from amg_tpu_torch.sparse.bsr import BSRMatrix
    from amg_tpu_torch.sparse.ell import ELLMatrix

    if op is None or isinstance(op, (HaloELL, HaloBSR)):
        return op
    rows = mesh.local_rows(op.shape[0])
    if isinstance(op, ELLMatrix):
        local = ELLMatrix(cols=op.cols[rows].clone(), vals=op.vals[rows].clone(),
                          shape_cols=op.shape_cols)
    elif isinstance(op, BSRMatrix):
        if rows.start % op.bm:
            raise ValueError(f"{op.shape[0] // mesh.world_size} rows a process do not hold "
                             f"whole {op.bm}-row blocks")
        rb = slice(rows.start // op.bm, rows.stop // op.bm)
        local = BSRMatrix(block_cols=op.block_cols[rb].clone(), tiles=op.tiles[rb].clone(),
                          shape=(rows.stop - rows.start, op.shape[1]))
    else:
        raise ValueError(f"row_shard takes ELL / BSR operators, not {type(op).__name__}")
    return RowShardedMatrix(local=local, mesh=mesh, shape=tuple(op.shape))


def shard_smoother(sm, mesh: RowMesh):
    """This process's part of a level's global smoother state: its rows of
    the scales and, for a block smoother, the level's block inverses with
    its rows (`ShardedBlockInverse`: every process applies all the blocks
    of the global rows to the gathered residual, as one process does, and
    keeps its rows)."""
    from amg_tpu_torch.smooth.smoothers import ShardedBlockInverse

    rows = mesh.local_rows(sm.scale.shape[0])

    def blocks(inv):
        return None if inv is None else ShardedBlockInverse(blocks=inv, rows=rows, mesh=mesh)

    return sm._replace(scale=sm.scale[rows].clone(), inv_wscale=sm.inv_wscale[rows].clone(),
                       block_inv=blocks(sm.block_inv), block_inv_bwd=blocks(sm.block_inv_bwd))


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
    halo exchange. comm="gspmd": plain ELL / BSR on the padded levels,
    across processes each process's rows of them (`row_shard`). Smoother
    state is built on the padded matrices (a block smoother's blocks cut
    from the global rows, `shard_smoother`); the coarsest level is the dense
    inverse of its padded matrix, replicated."""
    from amg_tpu_torch.setup.hierarchy import Hierarchy, Level
    from amg_tpu_torch.smooth.smoothers import make_smoother_data, smoother_data_from_arrays

    if comm not in ("gspmd", "halo"):
        raise ValueError(f"unknown comm {comm!r} (the port has 'halo' and 'gspmd')")
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
    """A generic hierarchy (every level's row count a multiple of the mesh)
    as the mesh's row-sharded one: the mesh attached (its solves reduce over
    it) and, across processes, each process's part: plain ELL / BSR levels
    keep their rows and all-gather their operand (`row_shard`, the gspmd
    route), halo operators are built sharded (`build_dist_hierarchy`), the
    smoother state keeps its rows (`shard_smoother`) and the coarse inverse
    applies to the gathered coarse vector. A stencil level raises, as in
    the reference (the stencil's own halo form is `parallel.halo`)."""
    from amg_tpu_torch.parallel.spcomm import HaloBSR, HaloELL
    from amg_tpu_torch.sparse.bsr import BSRMatrix
    from amg_tpu_torch.sparse.ell import ELLMatrix

    for lv in hier.levels:
        if not isinstance(lv.A, (ELLMatrix, BSRMatrix, HaloELL, HaloBSR)):
            raise ValueError(
                "shard_hierarchy needs ELL/BSR operators on every level; build with "
                "HierarchyParams(keep_stencil_fine=False)")
    if mesh.world_size == 1:
        return hier._replace(mesh=mesh)
    levels = tuple(lv._replace(sm=shard_smoother(lv.sm, mesh),
                               **{f: row_shard(getattr(lv, f), mesh)
                                  for f in ("A", "P", "R", "P_s", "R_s", "P_id", "R_id")})
                   for lv in hier.levels)
    return hier._replace(levels=levels, coarse_Ainv=GatheredOperator(hier.coarse_Ainv, mesh),
                         mesh=mesh)


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


def structured_layout(A, mesh: RowMesh) -> str:
    """How a structured level spreads over the processes: "planes" where
    its leading grid axis splits over the shards and its taps reach one
    plane along it (the plane halo of `parallel.halo`), "rows" where only
    its row count does (the gathered form), else "replicated" (every
    process holds the whole level). Pure: reads its arguments only."""
    from amg_tpu_torch.setup.structured import VarStencilOperator
    from amg_tpu_torch.sparse.stencil import StencilOperator

    D = mesh.n_devices
    if isinstance(A, (StencilOperator, VarStencilOperator)) and A.grid_shape[0] % D == 0 \
            and all(abs(o[0]) <= 1 for o in A.offsets):
        return "planes"
    return "rows" if A.shape[0] % D == 0 else "replicated"


def shard_structured_operator(A, mesh: RowMesh):
    """This process's form of a structured level's operator across
    processes (`structured_layout`): the plane-halo operator in the global
    operator's expression (`parallel.halo.make_structured_halo`: its rows
    bit for bit those of one process), the gathered form, or the operator
    itself where the level is replicated."""
    from amg_tpu_torch.parallel.halo import make_structured_halo

    layout = structured_layout(A, mesh)
    if layout == "planes":
        return make_structured_halo(A, mesh)
    return GatheredOperator(A, mesh) if layout == "rows" else A


def _shard_transfer(T, mesh: RowMesh, src: str, dst: str):
    """A structured transfer between levels of layouts src -> dst: between
    two plane-split levels the slab form (one neighbour plane,
    `parallel.halo.SlabTransfer`; a Dirichlet-masked transfer keeps its
    masks' rows), else the gathered form."""
    from amg_tpu_torch.parallel.halo import SlabTransfer
    from amg_tpu_torch.setup.structured import MaskedTransfer

    if T is None:
        return None
    if src == dst == "planes":
        inner = T.inner if isinstance(T, MaskedTransfer) else T
        slab = SlabTransfer.of(inner, mesh)
        if slab is not None:
            if not isinstance(T, MaskedTransfer):
                return slab
            return MaskedTransfer(inner=slab, in_mask=mesh.shard_vector(T.in_mask),
                                  out_mask=mesh.shard_vector(T.out_mask))
    return GatheredOperator(T, mesh, in_rows=src != "replicated", out_rows=dst != "replicated")


def shard_structured_hierarchy(hier, mesh: RowMesh):
    """A structured (geometric) hierarchy on the mesh. The reference splits
    each level's grid arrays on the leading axis where it divides the
    shards, replicates them elsewhere, keeps the vectors row-sharded, and
    lets GSPMD insert the halos: the single-device iteration. In one process
    that is the hierarchy itself, with the mesh attached. Across processes
    each level takes its `structured_layout`: a plane-split level applies
    its stencil with the plane halo and its transfers to a plane-split
    neighbour level with one neighbour plane (`SlabTransfer`), a row-split
    level the gathered form, a replicated level its whole operator in
    every process; the smoother state keeps this process's rows of a split
    level, and the coarse inverse of a split coarsest level applies to the
    gathered vector. Level 0 must split (its vectors are the solve's)."""
    if mesh.world_size == 1:
        return hier._replace(mesh=mesh)
    layout = [structured_layout(lv.A, mesh) for lv in hier.levels]
    if layout[0] == "replicated":
        raise ValueError(f"level 0's {hier.levels[0].A.shape[0]} rows do not split over "
                         f"{mesh.n_devices} shards")
    levels = []
    for k, lv in enumerate(hier.levels):
        fine = layout[k]
        coarse = layout[k + 1] if k + 1 < len(layout) else None
        levels.append(lv._replace(
            A=shard_structured_operator(lv.A, mesh),
            sm=lv.sm if fine == "replicated" else shard_smoother(lv.sm, mesh),
            P=_shard_transfer(lv.P, mesh, coarse, fine),
            R=_shard_transfer(lv.R, mesh, fine, coarse),
        ))
    inv = hier.coarse_Ainv
    if layout[-1] != "replicated":
        inv = GatheredOperator(inv, mesh)
    return hier._replace(levels=tuple(levels), coarse_Ainv=inv, mesh=mesh)
