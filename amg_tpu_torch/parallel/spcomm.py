"""Sparse neighbour (halo) exchange for unstructured row-partitioned
operators (counterpart of amg_tpu/parallel/spcomm.py).

The reference computes at setup the overlap each rank needs of every other
rank's vector segment (CreateCommData_LocalRes) and its distributed SpMV
ships only those boundary entries per matvec. The pattern here is the JAX
package's, array for array:

  setup (host, numpy): each shard's referenced columns split into its own
    column block (local index) and external ghosts, deduplicated into ghost
    slots; for every (owner p -> requester d) pair the owner's send list is
    the requester's ghosts in p's block. The offsets (d - p) mod D that
    occur are the neighbour structure: few of them (banded matrices) ship
    one segment per offset class ("ppermute" mode), many ship padded
    segments to every shard ("all_to_all" mode).

  matvec: send = x_local[send_idx]; the exchange; ghost = pool[ghost_map];
    y = ELL-SpMV over [x_local | ghost].

The exchange moves the segments between the D shards of the mesh
(`parallel.dist.RowMesh`): within one process, an offset class's receive is
a roll of the gathered send segments over the shard axis and the dense mode
a transpose of the (D, D, S) segments, both plain tensor indexing on the
device; across processes, the mesh's batched point-to-point
(`RowMesh.send_recv`) carries each offset class's segments between the
processes that own its pairs, and its all-to-all the dense mode. `comm_trace` records the wire bytes of every halo matvec.

HaloELL and HaloBSR have `@`, so every cycle, smoother and solver runs on a
halo-partitioned hierarchy unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from amg_tpu_torch.parallel.dist import RowMesh
from amg_tpu_torch.utils import tracing


class comm_trace:
    """Record the wire bytes of every halo matvec on `mesh` while open (the
    reference's message volume accounting, DMEM stats):

        with comm_trace(mesh) as log:
            cycle(...)
        total_bytes, messages = sum(log), len(log)
    """

    def __init__(self, mesh: RowMesh):
        self.mesh = mesh

    def __enter__(self):
        self.mesh.trace = []
        return self.mesh.trace

    def __exit__(self, *exc):
        self.mesh.trace = None
        return False


def _build_exchange_pattern(ghost_lists, n_loc_c, D, max_ppermute_offsets):
    """The pattern math of HaloELL and HaloBSR: from each shard's sorted
    unique external column (or column-block) ids, the per-peer send lists,
    offset classes, ppermute pair lists and ghost maps. Returns (send_idx,
    ghost_map, offs, perms, S, G, wire_send, payload_send)."""
    G = max(max((g.size for g in ghost_lists), default=0), 1)
    seg_counts = np.zeros((D, D), np.int64)
    segs = [[None] * D for _ in range(D)]
    for d in range(D):
        g = ghost_lists[d]
        owner = g // n_loc_c
        for p in range(D):
            s = g[owner == p] - p * n_loc_c
            segs[p][d] = s
            seg_counts[p, d] = s.size
    pairs = np.argwhere(seg_counts > 0)
    off_of = {}
    for p, d in pairs:
        off_of.setdefault(int((d - p) % D), []).append((int(p), int(d)))
    offs = tuple(sorted(off_of))
    use_ppermute = 0 < len(offs) <= max_ppermute_offsets
    S = max(int(seg_counts.max()), 1)
    # elements each shard puts on the wire (padded segments, only for the
    # pairs it sources; the dense mode ships every off-shard segment) and
    # the true boundary payload
    payload_send = tuple(int(c) for c in seg_counts.sum(axis=1))
    if use_ppermute:
        wire = np.zeros(D, np.int64)
        for prs in off_of.values():
            for p, _ in prs:
                wire[p] += S
        wire_send = tuple(int(w) for w in wire)
        m = len(offs)
        send_idx = np.zeros((D, m, S), np.int32)
        perms = []
        for j, o in enumerate(offs):
            perms.append(tuple(off_of[o]))
            for p, d in off_of[o]:
                s = segs[p][d]
                send_idx[p, j, : s.size] = s
        perms = tuple(perms)
        ghost_map = np.zeros((D, G), np.int32)
        for d in range(D):
            owner = ghost_lists[d] // n_loc_c
            for j, o in enumerate(offs):
                msk = owner == (d - o) % D
                if msk.any():
                    ghost_map[d, np.flatnonzero(msk)] = (
                        j * S + np.arange(msk.sum())).astype(np.int32)
    else:
        wire_send = tuple(S * (D - 1) for _ in range(D))
        offs, perms = (), ()
        send_idx = np.zeros((D, D, S), np.int32)
        ghost_map = np.zeros((D, G), np.int32)
        for p in range(D):
            for d in range(D):
                s = segs[p][d]
                send_idx[p, d, : s.size] = s
        for d in range(D):
            g = ghost_lists[d]
            owner = g // n_loc_c
            pos = np.zeros(g.size, np.int64)
            for p in range(D):
                msk = owner == p
                pos[msk] = np.arange(msk.sum())
            ghost_map[d, : g.size] = (owner * S + pos).astype(np.int32)
    return send_idx, ghost_map, offs, perms, S, G, wire_send, payload_send


@dataclass(eq=False)
class HaloExchange:
    """The static exchange of one halo operator over this process's shards:
    send_idx (L, m, S) (ppermute mode) or (L, D, S) (all_to_all mode, empty
    `offsets`) and ghost_map (L, G) in the reference's layout, L the local
    shards; their flat forms index the local vector and the stacked receive
    pool. Moves whole units: scalars (HaloELL) or bn-wide column blocks
    (HaloBSR)."""

    mesh: RowMesh
    send_idx: torch.Tensor
    ghost_map: torch.Tensor
    offsets: Tuple[int, ...]
    perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    n_loc_c: int  # units of one shard's column block
    send_flat: torch.Tensor = field(init=False)
    ghost_flat: torch.Tensor = field(init=False)

    def __post_init__(self):
        L, nbuf, S = self.send_idx.shape
        dev = self.send_idx.device
        base = torch.arange(L, device=dev, dtype=torch.int32)
        self.send_flat = (self.send_idx + (base * self.n_loc_c)[:, None, None]).reshape(-1)
        self.ghost_flat = (self.ghost_map + (base * (nbuf * S))[:, None]).reshape(-1)

    @property
    def G(self) -> int:
        return self.ghost_map.shape[1]

    def ghosts(self, x: torch.Tensor) -> torch.Tensor:
        """(L, G, *tail): every local shard's ghost units of the local
        units x (L * n_loc_c, *tail)."""
        L = self.mesh.local_devices
        tail = x.shape[1:]
        segs = x.index_select(0, self.send_flat).view(*self.send_idx.shape, *tail)
        if self.mesh.world_size > 1:
            recv = self._across_processes(segs)
        elif self.offsets:
            # shard d receives the segment of shard d - o (unread where
            # (d - o, d) is not a pair of the class)
            recv = torch.stack([torch.roll(segs[:, j], o, 0)
                                for j, o in enumerate(self.offsets)], 1)
        else:
            recv = segs.transpose(0, 1)  # [dst, src]: the all_to_all
        pool = recv.reshape(-1, *tail)
        return pool.index_select(0, self.ghost_flat).view(L, self.G, *tail)

    def _across_processes(self, segs: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        L, D, W = mesh.local_devices, mesh.n_devices, mesh.world_size
        if not self.offsets:
            S, tail = segs.shape[2], segs.shape[3:]
            # rows by destination process: (W, L_src, L_dst, S, *tail)
            inp = segs.reshape(L, W, L, S, *tail).transpose(0, 1).contiguous()
            out = mesh.all_to_all(inp)
            # out[q, ps, dd] came from shard q L + ps for my shard dd
            return out.transpose(0, 2).transpose(1, 2).reshape(L, D, S, *tail)
        recv = torch.zeros_like(segs)
        me, first = mesh.rank, mesh.first_shard
        sends, recvs = [], []
        # every process walks the same global pair list, so the sends and
        # receives between two processes are posted in the same order
        for j, perm in enumerate(self.perms):
            for p, d in perm:
                src, dst = mesh.owner(p), mesh.owner(d)
                if src == me and dst == me:
                    recv[d - first, j] = segs[p - first, j]
                elif src == me:
                    sends.append((segs[p - first, j], dst, j * D + d))
                elif dst == me:
                    recvs.append((recv[d - first, j], src, j * D + d))
        mesh.send_recv(sends, recvs)
        return recv


def _exchange_of(send_idx, ghost_map, offs, perms, n_loc_c, mesh: RowMesh) -> HaloExchange:
    """The HaloExchange of a global pattern, keeping this process's shards."""
    sl = slice(mesh.first_shard, mesh.first_shard + mesh.local_devices)
    return HaloExchange(
        mesh=mesh,
        send_idx=torch.from_numpy(np.array(send_idx[sl], np.int32)).to(mesh.device),
        ghost_map=torch.from_numpy(np.array(ghost_map[sl], np.int32)).to(mesh.device),
        offsets=offs, perms=perms, n_loc_c=n_loc_c,
    )


class _HaloOperator:
    """What HaloELL and HaloBSR share: the exchange `ex` and its pattern in
    the reference's names, the mesh, `@`."""

    @property
    def mesh(self) -> RowMesh:
        return self.ex.mesh

    @property
    def send_idx(self):
        return self.ex.send_idx

    @property
    def ghost_map(self):
        return self.ex.ghost_map

    @property
    def offsets(self):
        return self.ex.offsets

    @property
    def perms(self):
        return self.ex.perms


@dataclass(eq=False)
class HaloELL(_HaloOperator):
    """Row-partitioned ELL operator with a static halo exchange.

    vals (L, n_loc, k) and flat_cols (L, n_loc, k) int32 over this process's
    L shards; flat_cols indexes the stacked [x_local | ghost] blocks of the
    shards, each n_loc_c + G long (the reference's per-shard columns, < n_loc_c
    its own column block and >= n_loc_c its ghost slots, offset by the
    shard's block). wire_send / payload_send: per shard, the elements it
    puts on the wire per matvec (padded segments) and the true boundary
    payload."""

    vals: torch.Tensor
    flat_cols: torch.Tensor
    ex: HaloExchange
    shape: Tuple[int, int]
    n_loc: int
    n_loc_c: int
    wire_send: Tuple[int, ...] = ()
    payload_send: Tuple[int, ...] = ()

    def __matmul__(self, x):
        return halo_spmv(self, x)

    def comm_bytes_per_matvec(self) -> int:
        """Mean wire bytes a shard ships per matvec: padded segments, only
        for the (source, destination) pairs the pattern ships (the
        reference's message volume)."""
        itemsize = self.vals.element_size()
        if self.wire_send:
            return int(round(sum(self.wire_send) * itemsize / len(self.wire_send)))
        return self.send_idx.shape[1] * self.send_idx.shape[2] * itemsize

    def comm_payload_bytes_per_matvec(self) -> int:
        """Mean true boundary bytes a shard ships per matvec (no segment
        padding): the lower bound of the wire volume."""
        if not self.payload_send:
            return self.comm_bytes_per_matvec()
        return int(round(sum(self.payload_send) * self.vals.element_size()
                         / len(self.payload_send)))


def halo_spmv(a: HaloELL, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x with the boundary-segment exchange."""
    tracing.count("spmv.halo_ell")
    mesh = a.mesh
    if mesh.trace is not None:
        mesh.trace.append(a.comm_bytes_per_matvec())
    L = mesh.local_devices
    ghost = a.ex.ghosts(x)
    xg = torch.cat([x.view(L, a.n_loc_c), ghost], 1).reshape(-1)
    g = xg.index_select(0, a.flat_cols.view(-1)).view(a.flat_cols.shape)
    return (a.vals * g).sum(-1).reshape(-1)


def build_halo_ell(csr, mesh: RowMesh, dtype=None, max_ppermute_offsets=None) -> HaloELL:
    """The halo operator of a host CSR matrix whose row and column counts are
    multiples of the mesh (pad first: parallel.dist._pad_csr), on the mesh's
    device in `dtype` (default float64), holding this process's shards."""
    D = mesh.n_devices
    n_rows, n_cols = csr.n_rows, csr.n_cols
    if n_rows % D or n_cols % D:
        raise ValueError(f"halo pattern needs row/col counts divisible by the mesh "
                         f"({n_rows}x{n_cols} over {D})")
    n_loc, n_loc_c = n_rows // D, n_cols // D
    dtype = torch.float64 if dtype is None else dtype
    if max_ppermute_offsets is None:
        max_ppermute_offsets = max(D // 2, 2)
    indptr, indices, data = csr.indptr, csr.indices, csr.data
    k = max(int(np.diff(indptr).max()) if n_rows else 1, 1)

    ghost_lists, per_dev = [], []
    for d in range(D):
        lo, hi = indptr[d * n_loc], indptr[(d + 1) * n_loc]
        cols_d = indices[lo:hi]
        own = (cols_d >= d * n_loc_c) & (cols_d < (d + 1) * n_loc_c)
        ghost_lists.append(np.unique(cols_d[~own]))
        per_dev.append((lo, hi, cols_d, own))
    send_idx, ghost_map, offs, perms, S, G, wire_send, payload_send = \
        _build_exchange_pattern(ghost_lists, n_loc_c, D, max_ppermute_offsets)

    L, first = mesh.local_devices, mesh.first_shard
    stride = n_loc_c + ghost_map.shape[1]  # one shard's [own | ghost] block
    # the flat columns, written in place (padded slots: the shard's column
    # 0, value 0), so the host holds one int32 and one float64 per slot
    flat = np.repeat(np.arange(L, dtype=np.int32) * stride, n_loc * k).reshape(L, n_loc, k)
    vals = np.zeros((L, n_loc, k), np.float64)
    for dl in range(L):
        d = first + dl
        lo, hi, cols_d, own = per_dev[d]
        remap = np.where(own, cols_d - d * n_loc_c,
                         n_loc_c + np.searchsorted(ghost_lists[d], cols_d))
        counts = np.diff(indptr[d * n_loc: (d + 1) * n_loc + 1])
        rows_local = np.repeat(np.arange(n_loc), counts)
        slot = np.arange(hi - lo) - np.repeat(indptr[d * n_loc: (d + 1) * n_loc] - lo, counts)
        flat[dl, rows_local, slot] = remap + dl * stride
        vals[dl, rows_local, slot] = data[lo:hi]
    return _halo_ell(flat, vals, send_idx, ghost_map, offs, perms, (n_rows, n_cols), mesh,
                     dtype, wire_send, payload_send)


def halo_ell_of(cols, vals, send_idx, ghost_map, offsets, perms, shape, mesh: RowMesh,
                dtype=torch.float64, wire_send=(), payload_send=()) -> HaloELL:
    """A HaloELL from the reference's arrays: cols / vals (L, n_loc, k) of
    this process's shards, send_idx / ghost_map of all D shards."""
    L = cols.shape[0]
    stride = shape[1] // mesh.n_devices + ghost_map.shape[1]
    flat = cols.astype(np.int64) + (np.arange(L) * stride)[:, None, None]
    return _halo_ell(flat.astype(np.int32), np.array(vals, np.float64), send_idx, ghost_map,
                     offsets, perms, shape, mesh, dtype, wire_send, payload_send)


def _halo_ell(flat, vals, send_idx, ghost_map, offsets, perms, shape, mesh: RowMesh, dtype,
              wire_send, payload_send) -> HaloELL:
    return HaloELL(
        vals=torch.from_numpy(vals).to(device=mesh.device, dtype=dtype),
        flat_cols=torch.from_numpy(flat).to(mesh.device),
        ex=_exchange_of(send_idx, ghost_map, tuple(offsets), perms, shape[1] // mesh.n_devices,
                        mesh),
        shape=tuple(shape), n_loc=vals.shape[1], n_loc_c=shape[1] // mesh.n_devices,
        wire_send=tuple(wire_send), payload_send=tuple(payload_send),
    )


@dataclass(eq=False)
class HaloBSR(_HaloOperator):
    """Block-row-partitioned blocked-ELL (BSR) operator with a halo pattern
    over bn-wide column blocks: each shipped segment element is one column
    block. flat_bc (L, nrb_loc, kb) int32 indexes the stacked [own blocks |
    ghost blocks] of the shards; tiles (L, nrb_loc, bm, kb * bn) keep a row
    block's tiles side by side, as the port's BSRMatrix does."""

    flat_bc: torch.Tensor
    tiles: torch.Tensor
    ex: HaloExchange
    shape: Tuple[int, int]
    nrb_loc: int
    ncb_loc: int
    bn: int

    @property
    def bm(self) -> int:
        return self.tiles.shape[2]

    def __matmul__(self, x):
        return halo_bsr_spmv(self, x)

    def comm_bytes_per_matvec(self) -> int:
        nbuf, S = self.send_idx.shape[1], self.send_idx.shape[2]
        return nbuf * S * self.bn * self.tiles.element_size()


def halo_bsr_spmv(a: HaloBSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the column-block exchange, then one batched tile product
    per row block."""
    tracing.count("spmv.halo_bsr")
    mesh = a.mesh
    if mesh.trace is not None:
        mesh.trace.append(a.comm_bytes_per_matvec())
    L, bn = mesh.local_devices, a.bn
    xb = x.view(L * a.ncb_loc, bn)
    ghost = a.ex.ghosts(xb)
    xg = torch.cat([xb.view(L, a.ncb_loc, bn), ghost], 1).reshape(-1, bn)
    g = xg.index_select(0, a.flat_bc.view(-1))
    nr = L * a.nrb_loc
    y = torch.bmm(a.tiles.view(nr, a.bm, -1), g.view(nr, -1, 1))
    return y.reshape(-1)


def build_halo_bsr(csr, mesh: RowMesh, bm: int = 8, bn: int = 8, dtype=None,
                   max_ppermute_offsets=None) -> HaloBSR:
    """A HaloBSR of a host CSR matrix whose row count is a multiple of D bm
    and column count a multiple of D bn (pad first)."""
    from amg_tpu_torch.sparse.bsr import bsr_arrays

    D = mesh.n_devices
    n, m = csr.shape
    if n % (D * bm) or m % (D * bn):
        raise ValueError(f"halo BSR needs n % (D*bm) == 0 and m % (D*bn) == 0 "
                         f"({n}x{m}, D={D}, bm={bm}, bn={bn})")
    dtype = torch.float64 if dtype is None else dtype
    if max_ppermute_offsets is None:
        max_ppermute_offsets = max(D // 2, 2)
    bc_np, blk_np = bsr_arrays(csr, bm=bm, bn=bn)
    nrb, kb = bc_np.shape
    nrb_loc, ncb_loc = nrb // D, (m // bn) // D
    # padded slots (zero tiles at block column 0) must not create ghost traffic
    valid = np.abs(blk_np).sum(axis=(2, 3)) > 0.0
    ghost_lists = []
    for d in range(D):
        bc_d = bc_np[d * nrb_loc: (d + 1) * nrb_loc]
        v_d = valid[d * nrb_loc: (d + 1) * nrb_loc]
        ext = bc_d[v_d & ((bc_d < d * ncb_loc) | (bc_d >= (d + 1) * ncb_loc))]
        ghost_lists.append(np.unique(ext))
    send_idx, ghost_map, offs, perms, S, G, _, _ = _build_exchange_pattern(
        ghost_lists, ncb_loc, D, max_ppermute_offsets)
    L, first = mesh.local_devices, mesh.first_shard
    bc = np.zeros((L, nrb_loc, kb), np.int64)
    for dl in range(L):
        d = first + dl
        bc_d = bc_np[d * nrb_loc: (d + 1) * nrb_loc].astype(np.int64)
        own = (bc_d >= d * ncb_loc) & (bc_d < (d + 1) * ncb_loc)
        remap = np.where(own, bc_d - d * ncb_loc,
                         ncb_loc + np.searchsorted(ghost_lists[d], bc_d))
        # invalid slots point at the shard's block 0 (zero tiles anyway)
        bc[dl] = np.where(valid[d * nrb_loc: (d + 1) * nrb_loc], remap, 0)
    blocks = blk_np.reshape(D, nrb_loc, kb, bm, bn)[first: first + L]
    return halo_bsr_of(bc, blocks, send_idx, ghost_map, offs, perms, (n, m), mesh, dtype)


def halo_bsr_of(block_cols, blocks, send_idx, ghost_map, offsets, perms, shape,
                mesh: RowMesh, dtype=torch.float64) -> HaloBSR:
    """A HaloBSR from the reference's arrays: block_cols (L, nrb_loc, kb)
    and blocks (L, nrb_loc, kb, bm, bn) of this process's shards,
    send_idx / ghost_map of all D shards."""
    L, nrb_loc, kb, bm, bn = blocks.shape
    ncb_loc = shape[1] // bn // mesh.n_devices
    G = ghost_map.shape[1]
    flat = block_cols.astype(np.int64) + (np.arange(L) * (ncb_loc + G))[:, None, None]
    tiles = np.ascontiguousarray(np.asarray(blocks, np.float64).transpose(0, 1, 3, 2, 4))
    return HaloBSR(
        flat_bc=torch.from_numpy(flat.astype(np.int32)).to(mesh.device),
        tiles=torch.from_numpy(tiles.reshape(L, nrb_loc, bm, kb * bn)).to(
            device=mesh.device, dtype=dtype),
        ex=_exchange_of(send_idx, ghost_map, tuple(offsets), perms, ncb_loc, mesh),
        shape=tuple(shape), nrb_loc=nrb_loc, ncb_loc=ncb_loc, bn=bn,
    )
