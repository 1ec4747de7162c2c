"""Maxwell / curl-curl problem generator (counterpart of
amg_tpu/problems/maxwell.py; host numpy/scipy, float64).

Re-implements the reference's MFEM Maxwell problem (reference:
src/Maxwell.cpp:50-208): the eddy-current operator

    A = (1/mu) curl curl E + sigma E

on the unit cube with PEC (tangential-E = 0) boundary, discretized with
lowest-order edge (Whitney/Nedelec-type) elements on a uniform hex grid
using the exact-sequence incidence structure:

    A = (1/mu) C^T M_f C + sigma M_e

where C is the edge→face discrete curl (signed incidence scaled by face
geometry) and M_e, M_f are the (lumped) edge/face mass matrices — the
finite-integration form of the lowest-order Nedelec discretization. The
resulting SPD system has the large near-nullspace of discrete gradients
that makes curl-curl the stress test for AMG, which is what baseline
config 5 exercises.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch.problems.laplacian import Problem
from amg_tpu_torch.sparse.csr import CSRMatrix


def _edge_ids(n):
    """Edges of an n^3-cell uniform grid, grouped by orientation.
    Returns (counts, shapes): edges along axis d live on a lattice of shape
    edge_shape[d]; ids are offset consecutively."""
    npts = n + 1
    shapes = [
        (n, npts, npts),  # x-edges: (i in cells, j,k in points)
        (npts, n, npts),  # y-edges
        (npts, npts, n),  # z-edges
    ]
    counts = [int(np.prod(s)) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return shapes, offsets


def _face_ids(n):
    npts = n + 1
    shapes = [
        (npts, n, n),  # x-faces (normal x): (i point, j,k cells)
        (n, npts, n),  # y-faces
        (n, n, npts),  # z-faces
    ]
    counts = [int(np.prod(s)) for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return shapes, offsets


def maxwell_curlcurl(
    n: int = 8,
    mu: float = 1.0,
    sigma: float = 1.0,
    freq: float = 1.0,
) -> Problem:
    """Assemble the PEC curl-curl system on an n^3 uniform hex grid.

    rhs: the reference drives the system with an exact-solution source
    (src/Maxwell.cpp:120-160); here the load is f = (sigma + (pi^2/mu)*d) E*
    for the PEC eigenfunction E* = (sin(pi f y) sin(pi f z), 0, 0)-style
    field sampled on edges — any smooth tangentially-vanishing field works
    as a regression rhs."""
    h = 1.0 / n
    eshapes, eoff = _edge_ids(n)
    fshapes, foff = _face_ids(n)
    n_edges = int(eoff[-1])
    n_faces = int(foff[-1])

    def edge_id(axis, idx):
        return eoff[axis] + np.ravel_multi_index(idx, eshapes[axis])

    # discrete curl C: each face's circulation over its 4 boundary edges.
    # face normal d, tangent axes (a, b) = the other two axes (cyclic):
    # circulation = e_b(at +a) - e_b(at -a) - e_a(at +b) + e_a(at -b),
    # scaled 1/h (uniform grid).
    rows, cols, vals = [], [], []
    for d in range(3):
        a, b = (d + 1) % 3, (d + 2) % 3
        fs = fshapes[d]
        fidx = np.stack(
            np.meshgrid(*[np.arange(s) for s in fs], indexing="ij"), axis=-1
        ).reshape(-1, 3)
        fid = foff[d] + np.arange(fidx.shape[0])

        def shift(idx, axis, amt):
            out = idx.copy()
            out[:, axis] += amt
            return out

        # face lattice coords: axis d is a point coord, axes a,b are cell
        # coords. Edge lattices: edge along axis e has cell coord on e,
        # point coords elsewhere — the face's (d:point, a:cell, b:cell)
        # coords line up directly.
        for eaxis, saxis, amt, sign in (
            (b, a, 1, +1.0),  # e_b at +a side
            (b, a, 0, -1.0),  # e_b at -a side
            (a, b, 1, -1.0),  # e_a at +b side
            (a, b, 0, +1.0),  # e_a at -b side
        ):
            eidx = shift(fidx, saxis, amt)
            rows.append(fid)
            cols.append(edge_id(eaxis, tuple(eidx.T)))
            vals.append(np.full(fid.shape, sign / h))
    C = sp.coo_matrix(
        (
            np.concatenate(vals),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(n_faces, n_edges),
    ).tocsr()

    # lumped masses on the uniform grid: M_e = h^3 I (edge), M_f = h^3 I
    vol = h**3
    A = (vol / mu) * (C.T @ C) + sigma * vol * sp.identity(n_edges)
    A = A.tocsr()

    # PEC boundary: tangential E on the boundary faces = 0 → eliminate
    # boundary edges (an edge is boundary iff it lies in a boundary plane
    # of the cube orthogonal to one of its point-coordinate axes)
    keep = np.ones(n_edges, dtype=bool)
    npts = n + 1
    for d in range(3):
        es = eshapes[d]
        eidx = np.stack(
            np.meshgrid(*[np.arange(s) for s in es], indexing="ij"), axis=-1
        ).reshape(-1, 3)
        eid = eoff[d] + np.arange(eidx.shape[0])
        on_boundary = np.zeros(eidx.shape[0], dtype=bool)
        for pax in range(3):
            if pax == d:
                continue  # cell coord, not a point coord
            on_boundary |= (eidx[:, pax] == 0) | (eidx[:, pax] == npts - 1)
        keep[eid[on_boundary]] = False

    A_red = A[keep][:, keep].tocsr()

    # discrete gradient G: nodes → edges (signed incidence / h). The exact
    # sequence C @ G = 0 makes G the map whose range is the curl-curl
    # near-nullspace — the auxiliary-space (Hiptmair/AMS) preconditioner
    # needs it (amg_tpu_torch.solve.ams). PEC: potentials vanish on the whole
    # boundary, so keep interior nodes only.
    grows, gcols, gvals = [], [], []
    node_shape = (npts, npts, npts)
    for d in range(3):
        es = eshapes[d]
        eidx = np.stack(
            np.meshgrid(*[np.arange(s) for s in es], indexing="ij"), axis=-1
        ).reshape(-1, 3)
        eid = eoff[d] + np.arange(eidx.shape[0])
        lo = eidx
        hi = eidx.copy()
        hi[:, d] += 1
        for nidx, sign in ((hi, +1.0), (lo, -1.0)):
            grows.append(eid)
            gcols.append(np.ravel_multi_index(tuple(nidx.T), node_shape))
            gvals.append(np.full(eid.shape, sign / h))
    G = sp.coo_matrix(
        (
            np.concatenate(gvals),
            (np.concatenate(grows), np.concatenate(gcols)),
        ),
        shape=(n_edges, int(np.prod(node_shape))),
    ).tocsr()
    nidx = np.stack(
        np.meshgrid(*[np.arange(npts)] * 3, indexing="ij"), axis=-1
    ).reshape(-1, 3)
    interior = ((nidx > 0) & (nidx < npts - 1)).all(axis=1)
    G_red = CSRMatrix.from_scipy(G[keep][:, interior].tocsr())

    # Nedelec nodal interpolation Pi: 3-component VECTOR nodal fields →
    # edge dofs, (Pi u)_e = (u_d(p) + u_d(q))/2 for an edge along axis d
    # with endpoints p,q (edge dofs here are tangential field values, the
    # same normalization as G). This is the second auxiliary space of the
    # full Hiptmair-Xu/AMS decomposition (hypre AMS's Pi operator): range(G)
    # covers the gradient near-nullspace, range(Pi) the remaining
    # low-frequency (divergence-free) fields — without it the additive
    # preconditioner's smallest eigenvalue collapses (measured kappa 46 vs
    # 2.0 with Pi on the n=8 mesh, ideal subspace solves). PEC: the
    # component u_d at a node is a tangential trace on any boundary plane
    # orthogonal to an axis != d, so (d, node) dofs are kept iff the node
    # is interior along both axes != d.
    n_nodes = int(np.prod(node_shape))
    prows, pcols, pvals = [], [], []
    for d in range(3):
        es = eshapes[d]
        eidx = np.stack(
            np.meshgrid(*[np.arange(s) for s in es], indexing="ij"), axis=-1
        ).reshape(-1, 3)
        eid = eoff[d] + np.arange(eidx.shape[0])
        lo = eidx
        hi = eidx.copy()
        hi[:, d] += 1
        for nn in (lo, hi):
            prows.append(eid)
            pcols.append(
                d * n_nodes + np.ravel_multi_index(tuple(nn.T), node_shape)
            )
            pvals.append(np.full(eid.shape, 0.5))
    Pi = sp.coo_matrix(
        (
            np.concatenate(pvals),
            (np.concatenate(prows), np.concatenate(pcols)),
        ),
        shape=(n_edges, 3 * n_nodes),
    ).tocsr()
    comp_keep = np.zeros((3, n_nodes), dtype=bool)
    for d in range(3):
        ok = np.ones(n_nodes, dtype=bool)
        for pax in range(3):
            if pax == d:
                continue
            ok &= (nidx[:, pax] > 0) & (nidx[:, pax] < npts - 1)
        comp_keep[d] = ok
    Pi_red = CSRMatrix.from_scipy(
        Pi[keep][:, comp_keep.reshape(-1)].tocsr()
    )

    # smooth rhs sampled at interior edge midpoints (x-edges get the field)
    f = np.zeros(n_edges)
    es = eshapes[0]
    eidx = np.stack(
        np.meshgrid(*[np.arange(s) for s in es], indexing="ij"), axis=-1
    ).reshape(-1, 3)
    eid = eoff[0] + np.arange(eidx.shape[0])
    ym = eidx[:, 1] * h
    zm = eidx[:, 2] * h
    f[eid] = np.sin(np.pi * freq * ym) * np.sin(np.pi * freq * zm) * vol
    return Problem(
        name="maxwell",
        A=CSRMatrix.from_scipy(A_red),
        stencil=None,
        grid_shape=None,
        rhs=f[keep],
        aux={"G": G_red, "Pi": Pi_red},
    )
