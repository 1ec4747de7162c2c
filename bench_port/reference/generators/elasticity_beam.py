"""The cantilever beam in linear elasticity, frozen for the benchmark (plain
NumPy/SciPy).

MFEM example 2's beam as the async-multigrid code assembles it
(src/Elasticity.cpp:7-261): Q1 hexahedra on an nx x ny x nz grid of a
length x height x height beam, isotropic material with the last quarter
along x stiff_contrast times stiffer in lambda and mu, clamped at x = 0
(those dofs eliminated), dofs interleaved by node. The six rigid-body modes
at the node coordinates, restricted to the free dofs, are the
near-nullspace candidates of smoothed aggregation.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp


def element_matrices(h):
    """(K_lam, K_mu): the 24 x 24 Q1 element matrices of an hx x hy x hz
    box, by 2-point Gauss quadrature, dof (a, i) at a * 3 + i."""
    d, nen = 3, 8
    signs = np.array(list(itertools.product((-1.0, 1.0), repeat=d)))
    g = 1.0 / np.sqrt(3.0)
    K_lam = np.zeros((nen * d, nen * d))
    K_mu = np.zeros((nen * d, nen * d))
    detJ = np.prod(np.asarray(h) / 2.0)
    for xi in itertools.product((-g, g), repeat=d):
        xi = np.asarray(xi)
        dN = np.zeros((nen, d))
        for a in range(nen):
            for i in range(d):
                val = 0.5 * signs[a, i]
                for j in range(d):
                    if j != i:
                        val *= 0.5 * (1.0 + signs[a, j] * xi[j])
                dN[a, i] = val
        dNdx = dN * (2.0 / np.asarray(h))[None, :]
        Bdiv = dNdx.reshape(-1)
        K_lam += detJ * np.outer(Bdiv, Bdiv)
        gdot = dNdx @ dNdx.T
        for a in range(nen):
            for b in range(nen):
                for i in range(d):
                    for j in range(d):
                        K_mu[a * d + i, b * d + j] += detJ * (
                            (gdot[a, b] if i == j else 0.0) + dNdx[a, j] * dNdx[b, i])
    return K_lam, K_mu


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """(n_nodes * 3, 6): three translations, then the rotations in the
    (x, y), (x, z), (y, z) planes about the centroid."""
    nn, d = coords.shape
    B = np.zeros((nn * d, d + d * (d - 1) // 2))
    for i in range(d):
        B[i::d, i] = 1.0
    c = coords - coords.mean(axis=0)
    k = d
    for i in range(d):
        for j in range(i + 1, d):
            B[i::d, k] = -c[:, j]
            B[j::d, k] = c[:, i]
            k += 1
    return B


def generate(nx: int, ny: int, nz: int, length: float = 8.0, height: float = 1.0,
             E: float = 1.0, nu: float = 0.3, stiff_contrast: float = 50.0) -> dict:
    """{"A": CSR of the free dofs, "near_nullspace": (n, 6)}."""
    d = 3
    cells = (nx, ny, nz)
    npts = tuple(c + 1 for c in cells)
    h = (length / nx, height / ny, height / nz)
    K_lam, K_mu = element_matrices(h)
    lam0 = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu0 = E / (2 * (1 + nu))
    node_id = np.arange(int(np.prod(npts))).reshape(npts)
    corners = list(itertools.product((0, 1), repeat=d))
    cell_idx = np.stack(np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"),
                        axis=-1).reshape(-1, d)
    elem_nodes = np.stack([node_id[tuple((cell_idx + np.array(off)).T)] for off in corners],
                          axis=1)
    elem_dofs = (elem_nodes[:, :, None] * d + np.arange(d)).reshape(-1, 8 * d)
    stiff = (cell_idx[:, 0] + 0.5) / nx >= 0.75
    lam_e = np.where(stiff, stiff_contrast * lam0, lam0)
    mu_e = np.where(stiff, stiff_contrast * mu0, mu0)
    Ke = lam_e[:, None, None] * K_lam[None] + mu_e[:, None, None] * K_mu[None]
    rows = np.repeat(elem_dofs, 8 * d, axis=1).reshape(-1)
    cols = np.tile(elem_dofs, (1, 8 * d)).reshape(-1)
    n_all = node_id.size * d
    A = sp.coo_matrix((Ke.reshape(-1), (rows, cols)), shape=(n_all, n_all)).tocsr()
    free = np.ones(n_all, dtype=bool)
    clamped_nodes = node_id[0].reshape(-1)
    for i in range(d):
        free[clamped_nodes * d + i] = False
    A_free = A[free][:, free].tocsr()
    A_free.sum_duplicates()
    A_free.sort_indices()
    axes = [np.arange(p) * hh for p, hh in zip(npts, h)]
    coords = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, d)
    return {"A": A_free, "near_nullspace": rigid_body_modes(coords)[free]}
