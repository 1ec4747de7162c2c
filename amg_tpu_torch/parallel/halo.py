"""Explicit halo exchange for row-sharded stencil operators (counterpart of
amg_tpu/parallel/halo.py).

The reference's finest-grid halo channel is an MPI point-to-point pattern
(finestIntra). Here the grid is slab-decomposed along its leading axis into
the mesh's D shards; each shard's matvec needs one boundary plane from each
neighbour, which the exchange moves: within one process a shift of the
stacked slabs' edge planes over the shard axis, across processes a
point-to-point send of the edge planes of each process's first and last
shard. The result is the single-device stencil matvec (the zero planes at
the global ends are the operator's zero-Dirichlet truncation). Two entry
points sum the taps in two orders:

  * `halo_stencil_matvec` / `make_halo_stencil`, the runner's halo routes
    (one-level async smoothing): the reference's halo order, interior taps
    (offset 0 on the leading axis) first, then the taps that reach up, then
    those that reach down;
  * `structured_halo_matvec` / `make_structured_halo`, the structured
    hierarchy's plane-split levels across processes
    (`parallel.dist.shard_structured_operator`): the global operator's own
    expression over the haloed slab (every tap in list order, as
    `sparse.stencil.tap_sum` sums a StencilOperator's and a
    VarStencilOperator's), so that a process computes its rows of A @ x
    bit for bit, as one process holding the whole level does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.parallel.dist import RowMesh
from amg_tpu_torch.utils import tracing


def _apply_taps(grid, coeffs, offsets, tap_ids, zshift, out_shape):
    """Sum coeff[t] * shift(grid, offset_t) over the given taps in their
    order, from zeros, for every shard at once: grid (L, nz_in, *rest) is
    the stacked slabs (with their halo planes where zshift is 1), out_shape
    (nzl, *rest) one shard's."""
    nd = len(out_shape)
    nz = out_shape[0]
    # zero padding of the non-leading grid axes by the taps' reach along
    # each (1 for the 7- and 27-point stencils; an interleaved DIA operator
    # reaches further along its component axis); F.pad lists the last axis
    # first
    reach = [0] + [max(abs(o[d]) for o in offsets) for d in range(1, nd)]
    padded = F.pad(grid, [r for d in reversed(range(1, nd)) for r in (reach[d], reach[d])])
    y = torch.zeros((grid.shape[0],) + tuple(out_shape), dtype=grid.dtype, device=grid.device)
    for t in tap_ids:
        off = offsets[t]
        idx = (slice(None), slice(zshift + off[0], zshift + off[0] + nz)) + tuple(
            slice(reach[d] + off[d], reach[d] + off[d] + out_shape[d]) for d in range(1, nd))
        y = y + coeffs[t] * padded[idx]
    return y


def _edge_planes(g: torch.Tensor, mesh: RowMesh):
    """(from_prev, from_next): each local shard's top halo (the previous
    shard's last plane) and bottom halo (the next shard's first plane),
    zero at the ends of the grid."""
    prev_last, next_first = torch.zeros_like(g[:1, :1]), torch.zeros_like(g[:1, :1])
    if mesh.world_size > 1:
        me, W = mesh.rank, mesh.world_size
        sends, recvs = [], []
        if me > 0:
            sends.append((g[0, :1], me - 1, 1))
            recvs.append((prev_last[0], me - 1, 0))
        if me < W - 1:
            sends.append((g[-1, -1:], me + 1, 0))
            recvs.append((next_first[0], me + 1, 1))
        mesh.send_recv(sends, recvs)
    from_prev = torch.cat([prev_last, g[:-1, -1:]], 0)
    from_next = torch.cat([g[1:, :1], next_first], 0)
    return from_prev, from_next


def _local_coeffs(A, mesh: RowMesh):
    """The coefficients this process's shards read: a constant stencil's
    weights, or a variable stencil's (m, *grid) planes of its rows, viewed
    (m, L, nzl, *rest)."""
    from amg_tpu_torch.setup.structured import VarStencilOperator

    gs = A.grid_shape
    D, L = mesh.n_devices, mesh.local_devices
    nzl = gs[0] // D
    if isinstance(A, VarStencilOperator):
        z0 = mesh.first_shard * nzl
        c = A.coeffs[:, z0: z0 + L * nzl].to(mesh.device)
        return c.reshape((c.shape[0], L, nzl) + tuple(gs[1:]))
    return A.weights.to(mesh.device)


def _plane_split(A, mesh: RowMesh):
    """(local shape, trace): one shard's (nzl, *rest) block of A's grid, and
    the bytes a matvec's exchange ships (the mean a shard: two planes,
    less at the ends) logged to the mesh's open comm_trace. Raises where the
    leading axis does not divide into the shards or a tap reaches further
    than one plane along it."""
    gs = A.grid_shape
    D = mesh.n_devices
    if gs[0] % D:
        raise ValueError(f"leading grid axis {gs[0]} does not divide into {D} shards")
    if any(abs(o[0]) > 1 for o in A.offsets):
        raise ValueError("the halo stencil exchanges one plane: reach 1 along the leading axis")
    plane = int(np.prod(gs[1:]))

    def trace(x):
        if mesh.trace is not None:
            mesh.trace.append(int(round(2 * (D - 1) * plane * x.element_size() / D)))

    return (gs[0] // D,) + tuple(gs[1:]), trace


def _haloed(x, mesh: RowMesh, local_shape):
    """(g, gh): this process's shards of x, (L, nzl, *rest), and the same
    with each shard's neighbour planes, (L, nzl + 2, *rest)."""
    g = x.view((mesh.local_devices,) + tuple(local_shape))
    from_prev, from_next = _edge_planes(g, mesh)
    return g, torch.cat([from_prev, g, from_next], 1)


def halo_stencil_matvec(A, mesh: RowMesh):
    """(fn, coeffs): fn(x, coeffs) = A @ x over the mesh with the explicit
    plane exchange, x this process's rows of the flat grid vector, the taps
    summed in the reference's halo order (interior, up, down).

    A is a StencilOperator (constant weights) or VarStencilOperator whose
    leading grid axis divides into the mesh's shards, with reach 1 along
    it."""
    local_shape, trace = _plane_split(A, mesh)
    offsets = A.offsets
    interior = tuple(t for t, o in enumerate(offsets) if o[0] == 0)
    up = tuple(t for t, o in enumerate(offsets) if o[0] == -1)
    dn = tuple(t for t, o in enumerate(offsets) if o[0] == +1)

    def fn(x, coeffs):
        trace(x)
        g, gh = _haloed(x, mesh, local_shape)
        y = _apply_taps(g, coeffs, offsets, interior, 0, local_shape)
        for ids in (up, dn):
            if ids:
                y = y + _apply_taps(gh, coeffs, offsets, ids, 1, local_shape)
        return y.reshape(-1)

    return fn, _local_coeffs(A, mesh)


def structured_halo_matvec(A, mesh: RowMesh):
    """(fn, coeffs): fn(x, coeffs) = A @ x over the mesh with the explicit
    plane exchange, in the global operator's own expression
    (`sparse.stencil.tap_sum`: all taps in list order from zeros) over each
    shard's haloed slab, so that each row is what the global operator
    computes for it. Same arguments as `halo_stencil_matvec`."""
    local_shape, trace = _plane_split(A, mesh)
    offsets = A.offsets
    taps = range(len(offsets))

    def fn(x, coeffs):
        trace(x)
        _, gh = _haloed(x, mesh, local_shape)
        return _apply_taps(gh, coeffs, offsets, taps, 1, local_shape).reshape(-1)

    return fn, _local_coeffs(A, mesh)


def halo_jacobi_sweep(A, mesh: RowMesh):
    """(fn, coeffs): fn(u, b, inv_wscale, coeffs) = u + inv_wscale (b - A u)
    with the plane exchange, the distributed smoother step (one exchange per
    sweep)."""
    mv, coeffs = halo_stencil_matvec(A, mesh)

    def sweep(u, b, iw, coeffs_):
        return u + iw * (b - mv(u, coeffs_))

    return sweep, coeffs


class HaloStencilOperator:
    """A stencil operator whose matvec runs the plane exchange, with `@`, so
    smoothers and solvers use it unchanged. `base` is the global
    StencilOperator or VarStencilOperator; `matvec` builds the exchange's
    (fn, coeffs) (`halo_stencil_matvec` or `structured_halo_matvec`);
    `coeffs` are this process's coefficients."""

    def __init__(self, base, mesh: RowMesh, matvec=halo_stencil_matvec):
        self.base = base
        self.mesh = mesh
        self._mv, self.coeffs = matvec(base, mesh)

    @property
    def shape(self):
        n = int(np.prod(self.base.grid_shape))
        return (n, n)

    def diagonal(self) -> torch.Tensor:
        """This process's rows of the operator's diagonal."""
        return self.mesh.shard_vector(self.base.diagonal())

    def __matmul__(self, x):
        tracing.count("spmv.halo_stencil")
        return self._mv(x, self.coeffs)


def make_halo_stencil(A, mesh: RowMesh) -> HaloStencilOperator:
    """The halo-exchanging form of a (Var)StencilOperator over the mesh in
    the reference's halo order (its leading grid axis must divide into the
    shards): the runner's halo routes."""
    return HaloStencilOperator(A, mesh)


def make_structured_halo(A, mesh: RowMesh) -> HaloStencilOperator:
    """The halo-exchanging form of a structured level's (Var)StencilOperator
    in the global operator's expression (`structured_halo_matvec`): a
    plane-split level of the structured hierarchy across processes."""
    return HaloStencilOperator(A, mesh, structured_halo_matvec)


class SlabTransfer:
    """A structured transfer (`setup.structured.StructuredProlong` or
    `StructuredRestrict`) between two levels whose leading grid axes both
    split over the processes: each process contracts its own slab of planes
    and one neighbour plane (restriction: the previous process's last fine
    plane; prolongation: the next process's first coarse plane), with its
    block of the leading axis' 1-D transfer matrix; the other axes contract
    locally. `of` builds it, or returns None where one plane does not cover
    the leading axis' coupling at the process boundaries."""

    def __init__(self, T, mesh: RowMesh, M: torch.Tensor, to_coarse: bool):
        self.T, self.mesh, self.M, self.to_coarse = T, mesh, M, to_coarse

    @classmethod
    def of(cls, T, mesh: RowMesh):
        from amg_tpu_torch.setup.structured import StructuredRestrict

        to_coarse = isinstance(T, StructuredRestrict)
        nzf, nzc = T.fine_shape[0], T.coarse_shape[0]
        W = mesh.world_size
        if nzf % W or nzc % W:
            return None
        pf, pc = nzf // W, nzc // W
        S = T.mats[0]
        if S is None:  # an identity leading axis: the slabs must align
            return cls(T, mesh, None, to_coarse) if pf == pc else None
        S_np = S.detach().cpu().numpy()
        # S with a zero row above it (the plane before the first) and a zero
        # column after it (the plane after the last)
        S_pad = np.zeros((nzf + 1, nzc + 1))
        S_pad[1:, :nzc] = S_np
        for r in range(W):  # the same test in every process
            f0, c0 = r * pf, r * pc
            if to_coarse:
                inside = np.abs(S_pad[f0: f0 + pf + 1, c0: c0 + pc]).sum()
                total = np.abs(S_pad[:, c0: c0 + pc]).sum()
            else:
                inside = np.abs(S_pad[f0 + 1: f0 + pf + 1, c0: c0 + pc + 1]).sum()
                total = np.abs(S_pad[f0 + 1: f0 + pf + 1, :]).sum()
            if inside != total:
                return None
        f0, c0 = mesh.rank * pf, mesh.rank * pc
        if to_coarse:  # (pf + 1, pc): the halo plane's row, then the slab's
            M = S_pad[f0: f0 + pf + 1, c0: c0 + pc]
        else:  # (pc + 1, pf): the slab's coarse planes, then the halo's
            M = S_pad[f0 + 1: f0 + pf + 1, c0: c0 + pc + 1].T
        return cls(T, mesh, torch.from_numpy(np.ascontiguousarray(M)).to(S), to_coarse)

    @property
    def shape(self):
        return self.T.shape

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        from amg_tpu_torch.setup.structured import _transfer_axis

        tracing.count("spmv.slab_transfer")
        W = self.mesh.world_size
        src = self.T.fine_shape if self.to_coarse else self.T.coarse_shape
        g = x.reshape((src[0] // W,) + tuple(src[1:]))
        if self.M is not None:
            # the process's slab as one shard: its neighbours' edge planes
            from_prev, from_next = _edge_planes(g.unsqueeze(0), self.mesh)
            g = torch.cat([from_prev[0], g] if self.to_coarse else [g, from_next[0]])
            g = torch.movedim(torch.tensordot(g, self.M, dims=([0], [0])), -1, 0)
        for d in range(1, g.ndim):
            if self.T.mats[d] is not None:
                g = _transfer_axis(g, self.T.mats[d], d, to_coarse=self.to_coarse)
        return g.reshape(-1)
