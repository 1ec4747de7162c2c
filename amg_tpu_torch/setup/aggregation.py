"""Smoothed-aggregation (SA) AMG setup, the near-nullspace-aware hierarchy
(counterpart of amg_tpu/setup/aggregation.py; host numpy/scipy, float64).

Classical coarsening reproduces constants per unknown, which elasticity's
rigid-body rotations escape; smoothed aggregation (Vanek/Mandel/Brezina)
builds the transfers from user-supplied near-nullspace candidates (the
rigid-body modes of `amg_tpu_torch.problems.elasticity.rigid_body_modes`).

Pipeline (host, setup-time, float64):
  amalgamate (block Frobenius norms for systems) -> symmetric strength ->
  greedy aggregation (3-pass VMB) -> tentative P by batched per-aggregate QR
  of the candidates (exactness: P_tent @ B_coarse == B_fine) -> damped-Jacobi
  prolongator smoothing P = (I - omega D^-1 A) P_tent -> Galerkin RAP ->
  recurse.

The aggregation pass and the QR are the reference's line for line, so the
aggregates and P_tent come out identical (numpy's QR sign convention). The
resulting HostHierarchy has the classical one's format, so
`setup.hierarchy.device_hierarchy` puts it on the device unchanged.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch.setup.hierarchy import HierarchyParams, HostHierarchy, HostLevel
from amg_tpu_torch.setup.rap import estimate_rho_dinv_a, galerkin_product
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import setup_span


def amalgamate(A: CSRMatrix, num_functions: int) -> sp.csr_matrix:
    """Condense a dof-interleaved systems matrix to its node graph, entries =
    Frobenius norms of the nf×nf blocks."""
    s = A.to_scipy().tocoo()
    nf = num_functions
    nn = -(-A.n_rows // nf)
    m = sp.coo_matrix(
        (s.data**2, (s.row // nf, s.col // nf)), shape=(nn, nn)
    ).tocsr()
    m.sum_duplicates()
    m.data = np.sqrt(m.data)
    return m


def sa_strength(C: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric SA strength: keep |a_ij| >= theta * sqrt(|a_ii a_jj|)."""
    C = C.tocsr()
    d = np.abs(C.diagonal())
    coo = C.tocoo()
    keep = np.abs(coo.data) >= theta * np.sqrt(d[coo.row] * d[coo.col])
    keep &= coo.row != coo.col
    return sp.coo_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=C.shape
    ).tocsr()


def aggregate(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """Greedy standard aggregation (Vanek-Mandel-Brezina 3-pass): returns
    agg[i] = aggregate id per node; isolated nodes (empty strength row —
    Dirichlet identity rows, disconnected dofs) stay -1 and are NOT
    represented on the coarse grid (the point smoother solves their
    diagonal rows exactly; aggregating them seeds singleton aggregates
    whose rank-deficient candidate blocks make the coarse operator
    singular)."""
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    indptr, indices = S.indptr, S.indices
    isolated = np.diff(indptr) == 0
    next_agg = 0
    # pass 1: seed aggregates from nodes whose whole neighborhood is free
    for i in range(n):
        if agg[i] != -1 or isolated[i]:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_agg
            agg[nbrs] = next_agg
            next_agg += 1
    # pass 2: attach remaining nodes to a neighboring aggregate
    unassigned = np.flatnonzero(agg == -1)
    attach = agg.copy()
    for i in unassigned:
        nbrs = indices[indptr[i] : indptr[i + 1]]
        owned = nbrs[agg[nbrs] != -1]
        if owned.size:
            attach[i] = agg[owned[0]]
    agg = attach
    # pass 3: leftover connected nodes form new aggregates with their
    # still-free neighbors (isolated nodes stay -1)
    for i in np.flatnonzero((agg == -1) & ~isolated):
        if agg[i] != -1:
            continue
        agg[i] = next_agg
        nbrs = indices[indptr[i] : indptr[i + 1]]
        free = nbrs[agg[nbrs] == -1]
        agg[free] = next_agg
        next_agg += 1
    return agg


def tentative_prolongator(
    agg: np.ndarray, B: np.ndarray, num_functions: int
) -> tuple:
    """Per-aggregate orthonormalization of the candidates: P_tent (n × nc)
    with orthonormal columns per aggregate, and B_coarse (nc × nb) such that
    P_tent @ B_coarse == B (exact candidate reproduction).

    Dofs with agg < 0 (isolated/Dirichlet nodes) get zero P rows — no
    coarse representation. Exactly-zero columns (rank-deficient aggregates:
    a 2-node aggregate cannot see the rotation about its own axis; a
    clamped singleton carries < nb independent dofs) are dropped with their
    B_coarse rows, keeping the coarse operator nonsingular — P@Bc == B
    still holds since the dropped columns are zero."""
    n, nb = B.shape
    nf = num_functions
    na = int(agg.max()) + 1
    dof_agg = np.repeat(agg, nf)[:n] if nf > 1 else agg
    kept = np.flatnonzero(dof_agg >= 0)
    # bucket dofs by aggregate, pad to the max aggregate size, batched QR
    order = kept[np.argsort(dof_agg[kept], kind="stable")]
    counts = np.bincount(dof_agg[kept], minlength=na)
    mx = int(counts.max())
    starts = np.zeros(na + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    padded = np.zeros((na, mx, nb))
    slot = np.arange(order.size) - starts[dof_agg[order]]
    padded[dof_agg[order], slot] = B[order]
    Q, R = np.linalg.qr(padded)  # batched thin QR; zero pad rows stay zero
    # rank-revealing drop: |R_jj| ~ 0 marks a candidate with no independent
    # component in this aggregate — its Q column is an arbitrary orthonormal
    # completion vector, not interpolation data. Zero it so the scatter
    # skips it, and drop its B_coarse row below.
    rdiag = np.abs(np.einsum("aii->ai", R))  # (na, nb)
    scale = np.maximum(rdiag.max(axis=1, keepdims=True), 1e-300)
    deficient = rdiag <= 1e-10 * scale
    if deficient.any():
        Q = np.where(deficient[:, None, :], 0.0, Q)
    # scatter Q back to sparse P (only real dof rows are read — the
    # orthonormal-completion rows at padding positions are never touched)
    r_idx = np.repeat(order[:, None], nb, axis=1).reshape(-1)
    agg_of = dof_agg[order]
    c_idx = (agg_of[:, None] * nb + np.arange(nb)[None, :]).reshape(-1)
    vals = Q[agg_of, slot].reshape(-1)
    P = sp.coo_matrix((vals, (r_idx, c_idx)), shape=(n, na * nb)).tocsr()
    P.eliminate_zeros()
    Bc = R.reshape(na * nb, nb)
    keep_cols = ~deficient.reshape(-1)
    # also drop columns that are empty for any other reason (e.g. aggregates
    # whose dofs were all isolated)
    keep_cols &= np.asarray(np.abs(P).sum(axis=0)).ravel() > 0.0
    if not keep_cols.all():
        P = P[:, keep_cols].tocsr()
        Bc = Bc[keep_cols]
    return CSRMatrix.from_scipy(P), Bc


def build_sa_host_hierarchy(
    A: CSRMatrix,
    params: HierarchyParams,
    B: np.ndarray | None = None,
) -> HostHierarchy:
    """Smoothed-aggregation hierarchy. `B` are the near-nullspace candidates
    (defaults to the constant vector). Drop-in alternative to
    `build_host_hierarchy` (select with params.setup_type='sa')."""
    tracing.begin_setup()
    if B is None:
        B = np.ones((A.n_rows, 1))
    B = np.asarray(B, dtype=np.float64)
    hh = HostHierarchy(params=params)
    level_A = A
    nf = max(params.num_functions, 1)
    for lvl in range(params.max_levels):
        hl = HostLevel(A=level_A)
        with setup_span("rho", lvl):
            scale = (
                level_A.l1_row_norms()
                if params.smoother
                in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI)
                else None
            )
            rho_s = estimate_rho_dinv_a(level_A, seed=params.seed, scale=scale)
        hl.weight = (
            params.smooth_weight
            if params.smooth_weight is not None
            else 1.0 / max(rho_s, 1e-12)
        )
        hh.levels.append(hl)
        if level_A.n_rows <= params.max_coarse_size or lvl == params.max_levels - 1:
            break
        with setup_span("strength", lvl):
            C = (
                amalgamate(level_A, nf)
                if nf > 1
                else level_A.to_scipy().tocsr()
            )
            S = sa_strength(C, params.sa_theta)
        with setup_span("coarsen", lvl):
            agg = aggregate(S, seed=params.seed)
        na = int(agg.max()) + 1
        if na == 0:
            break  # nothing aggregated (all-isolated level)
        with setup_span("interp", lvl):
            P_tent, Bc = tentative_prolongator(agg, B, nf)
        if P_tent.shape[1] >= level_A.n_rows:
            break  # aggregation stalled
        # after the zero-column drop the coarse blocking may be ragged; the
        # next level's amalgamation still groups by nb consecutive dofs,
        # which is only a heuristic grouping (aggregation quality, not
        # correctness)
        # prolongator smoothing: P = (I - omega * Dinv A) P_tent with the
        # diagonal scaling; omega = sa_omega / rho(Dinv A)
        with setup_span("interp", lvl):
            diag = level_A.diagonal()
            diag = np.where(diag == 0.0, 1.0, diag)
            rho_d = estimate_rho_dinv_a(level_A, seed=params.seed)
            omega = params.sa_omega / max(rho_d, 1e-12)
            As = level_A.to_scipy().tocsr()
            Pt = P_tent.to_scipy()
            P = (Pt - sp.diags(omega / diag) @ (As @ Pt)).tocsr()
            P = CSRMatrix.from_scipy(P)
            R = P.transpose()
        hl.P, hl.R = P, R
        with setup_span("rap", lvl):
            level_A = galerkin_product(R, level_A, P)
        B = Bc
        # after the first SA level the blocking is nb (candidate count)
        nf = B.shape[1]
    return hh
