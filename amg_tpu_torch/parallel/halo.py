"""Explicit halo exchange for row-sharded stencil operators (counterpart of
amg_tpu/parallel/halo.py).

The reference's finest-grid halo channel is an MPI point-to-point pattern
(finestIntra). Here the grid is slab-decomposed along its leading axis into
the mesh's D shards; each shard's matvec needs one boundary plane from each
neighbour, which the exchange moves: within one process a shift of the
stacked slabs' edge planes over the shard axis, across processes a
point-to-point send of the edge planes of each process's first and last
shard. Interior taps (offset 0 on the leading axis) are summed first, then
the taps that reach up and down, over the haloed slab, in the reference's
order. The result is the single-device stencil matvec (the zero planes at
the global ends are the operator's zero-Dirichlet truncation).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.parallel.dist import RowMesh


def _apply_taps(grid, coeffs, offsets, tap_ids, zshift, out_shape):
    """Sum coeff[t] * shift(grid, offset_t) over the given taps, for every
    shard at once: grid (L, nz_in, *rest) is the stacked slabs (with their
    halo planes where zshift is 1), out_shape (nzl, *rest) one shard's."""
    nd = len(out_shape)
    nz = out_shape[0]
    # reach-1 zero padding of the non-leading grid axes (F.pad lists the
    # last axis first)
    padded = F.pad(grid, [1, 1] * (nd - 1))
    y = torch.zeros((grid.shape[0],) + tuple(out_shape), dtype=grid.dtype, device=grid.device)
    for t in tap_ids:
        off = offsets[t]
        idx = (slice(None), slice(zshift + off[0], zshift + off[0] + nz)) + tuple(
            slice(1 + off[d], 1 + off[d] + out_shape[d]) for d in range(1, nd))
        y = y + coeffs[t] * padded[idx]
    return y


def _edge_planes(g: torch.Tensor, mesh: RowMesh):
    """(from_prev, from_next): each local shard's top halo (the previous
    shard's last plane) and bottom halo (the next shard's first plane),
    zero at the ends of the grid."""
    zero = torch.zeros_like(g[:1, :1])
    prev_last, next_first = zero, zero
    if mesh.world_size > 1:
        dist = torch.distributed
        me, W = mesh.rank, mesh.world_size
        prev_last, next_first = torch.zeros_like(zero), torch.zeros_like(zero)
        ops = []
        if me > 0:
            ops += [dist.P2POp(dist.isend, g[0, :1].contiguous(), mesh.global_rank(me - 1),
                               mesh.group, 1),
                    dist.P2POp(dist.irecv, prev_last[0], mesh.global_rank(me - 1),
                               mesh.group, 0)]
        if me < W - 1:
            ops += [dist.P2POp(dist.isend, g[-1, -1:].contiguous(), mesh.global_rank(me + 1),
                               mesh.group, 0),
                    dist.P2POp(dist.irecv, next_first[0], mesh.global_rank(me + 1),
                               mesh.group, 1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
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


def halo_stencil_matvec(A, mesh: RowMesh):
    """(fn, coeffs): fn(x, coeffs) = A @ x over the mesh with the explicit
    plane exchange, x this process's rows of the flat grid vector.

    A is a StencilOperator (constant weights) or VarStencilOperator whose
    leading grid axis divides into the mesh's shards, with reach 1 along
    it."""
    gs = A.grid_shape
    D, L = mesh.n_devices, mesh.local_devices
    if gs[0] % D:
        raise ValueError(f"leading grid axis {gs[0]} does not divide into {D} shards")
    offsets = A.offsets
    if any(abs(o[0]) > 1 for o in offsets):
        raise ValueError("the halo stencil exchanges one plane: reach 1 along the leading axis")
    interior = tuple(t for t, o in enumerate(offsets) if o[0] == 0)
    up = tuple(t for t, o in enumerate(offsets) if o[0] == -1)
    dn = tuple(t for t, o in enumerate(offsets) if o[0] == +1)
    local_shape = (gs[0] // D,) + tuple(gs[1:])
    plane_bytes = int(np.prod(gs[1:]))

    def fn(x, coeffs):
        if mesh.trace is not None:
            # the mean bytes a shard ships: two planes, less at the ends
            mesh.trace.append(int(round(2 * (D - 1) * plane_bytes * x.element_size() / D)))
        g = x.view((L,) + local_shape)
        from_prev, from_next = _edge_planes(g, mesh)
        y = _apply_taps(g, coeffs, offsets, interior, 0, local_shape)
        gh = torch.cat([from_prev, g, from_next], 1)
        for ids in (up, dn):
            if ids:
                y = y + _apply_taps(gh, coeffs, offsets, ids, 1, local_shape)
        return y.reshape(-1)

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
    smoothers and solvers (the one-level async smoothing of the runner) use
    it unchanged. `base` is the global StencilOperator or
    VarStencilOperator; `coeffs` this process's coefficients."""

    def __init__(self, base, mesh: RowMesh):
        self.base = base
        self.mesh = mesh
        self._mv, self.coeffs = halo_stencil_matvec(base, mesh)

    @property
    def shape(self):
        n = int(np.prod(self.base.grid_shape))
        return (n, n)

    def diagonal(self) -> torch.Tensor:
        """This process's rows of the operator's diagonal."""
        return self.mesh.shard_vector(self.base.diagonal())

    def __matmul__(self, x):
        return self._mv(x, self.coeffs)


def make_halo_stencil(A, mesh: RowMesh) -> HaloStencilOperator:
    """The halo-exchanging form of a (Var)StencilOperator over the mesh
    (its leading grid axis must divide into the shards)."""
    return HaloStencilOperator(A, mesh)
