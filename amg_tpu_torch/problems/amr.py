"""Locally-refined (AMR-analog) problem generators (counterpart of
amg_tpu/problems/amr.py, host numpy/scipy; the arrays equal the
reference's exactly).

The reference's AMR problems (MFEM ZZ-estimator + ThresholdRefiner loops,
reference: src/Elasticity.cpp:150-261, src/Laplacian.cpp:202-424) produce
matrices whose defining property for the solver is LOCAL REFINEMENT: element
sizes varying by orders of magnitude toward a feature, giving multiscale
diagonal entries and high condition numbers. The native equivalent here is a
graded-mesh finite-volume Laplacian: node coordinates follow a power grading
toward a corner singularity, x_i = (i/n)^gamma, so h varies by ~gamma orders
of magnitude — the same matrix character AMR produces, assembled directly
(no external mesh machinery).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch.dtypes import SETUP_DTYPE
from amg_tpu_torch.problems.laplacian import Problem
from amg_tpu_torch.sparse.csr import CSRMatrix


def _graded_coords(n: int, gamma: float) -> np.ndarray:
    """n+1 node coordinates in [0,1], graded toward 0 with exponent gamma."""
    return (np.arange(n + 1) / n) ** gamma


def laplacian_tensor(
    xs: np.ndarray, ys: np.ndarray, f=None
) -> tuple:
    """2D diffusion on an arbitrary tensor-product mesh (finite volume,
    Dirichlet), with an optional source term f(x, y) integrated over control
    volumes. Returns (Problem, rhs) — the assembly kernel behind both the
    graded mesh and the estimator-driven AMR loop below."""
    nx, ny = len(xs) - 1, len(ys) - 1
    nxi, nyi = nx - 1, ny - 1
    n = nxi * nyi
    idx = np.arange(n).reshape(nxi, nyi)
    hx, hy = np.diff(xs), np.diff(ys)
    cvx = 0.5 * (hx[:-1] + hx[1:])
    cvy = 0.5 * (hy[:-1] + hy[1:])
    rows, cols, vals = [], [], []
    diag = np.zeros((nxi, nyi))
    wx = 1.0 / hx
    c = wx[1:-1][:, None] * cvy[None, :]
    r = idx[:-1, :].reshape(-1)
    cidx = idx[1:, :].reshape(-1)
    v = -c.reshape(-1)
    rows += [r, cidx]
    cols += [cidx, r]
    vals += [v, v]
    diag[:-1, :] += c
    diag[1:, :] += c
    diag[0, :] += wx[0] * cvy
    diag[-1, :] += wx[-1] * cvy
    wy = 1.0 / hy
    c = cvx[:, None] * wy[1:-1][None, :]
    r = idx[:, :-1].reshape(-1)
    cidx = idx[:, 1:].reshape(-1)
    v = -c.reshape(-1)
    rows += [r, cidx]
    cols += [cidx, r]
    vals += [v, v]
    diag[:, :-1] += c
    diag[:, 1:] += c
    diag[:, 0] += cvx * wy[0]
    diag[:, -1] += cvx * wy[-1]
    rows.append(idx.reshape(-1))
    cols.append(idx.reshape(-1))
    vals.append(diag.reshape(-1))
    m = sp.coo_matrix(
        (
            np.concatenate(vals).astype(SETUP_DTYPE),
            (np.concatenate(rows), np.concatenate(cols)),
        ),
        shape=(n, n),
    )
    rhs = None
    if f is not None:
        X = xs[1:-1][:, None]
        Y = ys[1:-1][None, :]
        rhs = (f(X, Y) * (cvx[:, None] * cvy[None, :])).reshape(-1)
    prob = Problem(
        name="amr", A=CSRMatrix.from_scipy(m.tocsr()), stencil=None,
        grid_shape=(nxi, nyi), rhs=rhs,
    )
    return prob, (xs, ys)


def laplacian_graded(
    nx: int,
    ny: int | None = None,
    gamma: float = 2.5,
) -> Problem:
    """2D diffusion on a tensor-product graded mesh (finite volume, Dirichlet).

    gamma=1 is the uniform mesh; gamma~2.5 mimics 3-4 rounds of corner
    refinement (h_min/h_max ~ n^(1-gamma))."""
    ny = nx if ny is None else ny
    xs = _graded_coords(nx, gamma)
    ys = _graded_coords(ny, gamma)
    prob, _ = laplacian_tensor(xs, ys)
    return Problem(
        name="graded", A=prob.A, stencil=None, grid_shape=prob.grid_shape,
    )


# ---------------------------------------------------------------------------
# Estimator-driven AMR loop (the reference's ZZ-estimator + ThresholdRefiner
# pattern, reference: src/Laplacian.cpp:202-424, src/Elasticity.cpp:150-261):
# solve → recover gradients → per-interval error indicator → mark intervals
# above theta * max (ThresholdRefiner semantics) → split marked intervals
# (nested meshes by construction; tensor-product grids stay conforming, the
# MFEM-free realization of local refinement) → reassemble → repeat.
# ---------------------------------------------------------------------------


def _zz_interval_indicator(coords: np.ndarray, U: np.ndarray, axis: int):
    """ZZ-style recovery indicator per interval along one axis: face
    gradients vs their averaged (recovered) nodal gradients, summed over the
    transverse direction, scaled by the interval size."""
    if axis == 1:
        U = U.T
    h = np.diff(coords)  # (nc,)
    # pad solution with Dirichlet zeros to include boundary intervals
    Uz = np.concatenate(
        [np.zeros((1, U.shape[1])), U, np.zeros((1, U.shape[1]))], axis=0
    )
    g = np.diff(Uz, axis=0) / h[:, None]  # (nc, m) face gradients
    g_node = 0.5 * (g[:-1] + g[1:])  # recovered interior-node gradients
    jump_lo = np.zeros_like(g)
    jump_hi = np.zeros_like(g)
    jump_lo[1:] = g[1:] - g_node  # vs node at interval's low end
    jump_hi[:-1] = g[:-1] - g_node  # vs node at interval's high end
    eta2 = h[:, None] * (jump_lo**2 + jump_hi**2)
    return np.sqrt(eta2.sum(axis=1) * h)  # (nc,)


def amr_refine_loop(
    n0: int = 8,
    rounds: int = 3,
    theta: float = 0.5,
    f=None,
    max_intervals: int = 4096,
):
    """Estimator-driven adaptive refinement. Returns a list of rounds, each
    {problem, xs, ys, eta_x, eta_y, u}; meshes are NESTED (every round's
    coordinates are a superset of the previous round's).

    f defaults to a sharp off-center source (the singular-feature driver the
    reference's AMR experiments use)."""
    import scipy.sparse.linalg as spla

    if f is None:
        def f(x, y):
            return 1.0 / ((x - 0.1) ** 2 + (y - 0.1) ** 2 + 1e-3)

    xs = np.linspace(0.0, 1.0, n0 + 1)
    ys = np.linspace(0.0, 1.0, n0 + 1)
    out = []
    for _ in range(rounds + 1):
        prob, (xs, ys) = laplacian_tensor(xs, ys, f=f)
        u = spla.spsolve(prob.A.to_scipy().tocsc(), prob.rhs)
        U = u.reshape(prob.grid_shape)
        eta_x = _zz_interval_indicator(xs, U, axis=0)
        eta_y = _zz_interval_indicator(ys, U, axis=1)
        out.append({
            "problem": prob, "xs": xs, "ys": ys,
            "eta_x": eta_x, "eta_y": eta_y, "u": u,
        })
        if len(out) > rounds:
            break

        def refine(coords, eta):
            mark = eta > theta * eta.max()
            if len(coords) - 1 + mark.sum() > max_intervals:
                # cap growth: refine only the largest indicators
                keep = np.argsort(-eta)[: max_intervals - (len(coords) - 1)]
                mark = np.zeros_like(mark)
                mark[keep] = True
            mids = 0.5 * (coords[:-1] + coords[1:])[mark]
            return np.sort(np.concatenate([coords, mids]))

        xs = refine(xs, eta_x)
        ys = refine(ys, eta_y)
    return out
