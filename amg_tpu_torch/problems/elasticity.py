"""Linear-elasticity problem generator (counterpart of
amg_tpu/problems/elasticity.py; host numpy/scipy, float64).

Re-implements the reference's MFEM elasticity problem (reference:
src/Elasticity.cpp:7-261, parallel variant src/DMEM_BuildMatrix.cpp:442-719):
a cantilever beam, vector H1 elements, isotropic elasticity with TWO material
regions (the free-end region 50× stiffer, matching the reference's piecewise
lambda/mu with contrast), clamped at x=0, pull-down traction on the free end.

Discretization: Q1 (bi/tri-linear) elements on a structured beam grid. On a
uniform grid every element shares the same geometric stiffness, so the
element matrix splits as  K_e = lambda_e*K_lam + mu_e*K_mu  with

    K_lam[(a,i),(b,j)] = ∫ dN_a/dx_i dN_b/dx_j
    K_mu [(a,i),(b,j)] = ∫ (delta_ij grad N_a . grad N_b
                            + dN_a/dx_j dN_b/dx_i)

(the standard isotropic split), computed once by full Gauss quadrature and
scaled per element — an exact Q1 stiffness. Clamped dofs are eliminated
(SPD reduced system), like MFEM's essential-BC elimination.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch.dtypes import SETUP_DTYPE
from amg_tpu_torch.problems.laplacian import Problem
from amg_tpu_torch.sparse.csr import CSRMatrix


def _element_matrices(d: int, h):
    """(K_lam, K_mu) reference element matrices for a d-cube of size h."""
    nen = 2**d
    signs = np.array(list(itertools.product((-1.0, 1.0), repeat=d)))
    g = 1.0 / np.sqrt(3.0)
    K_lam = np.zeros((nen * d, nen * d))
    K_mu = np.zeros((nen * d, nen * d))
    detJ = np.prod(np.asarray(h) / 2.0)
    for xi in itertools.product((-g, g), repeat=d):
        xi = np.asarray(xi)
        # dN_a/dxi_i = 0.5*s_ai * prod_{j != i} 0.5*(1 + s_aj xi_j)
        dN = np.zeros((nen, d))
        for a in range(nen):
            for i in range(d):
                val = 0.5 * signs[a, i]
                for j in range(d):
                    if j != i:
                        val *= 0.5 * (1.0 + signs[a, j] * xi[j])
                dN[a, i] = val
        dNdx = dN * (2.0 / np.asarray(h))[None, :]
        # dof (a,i) index = a*d + i
        Bdiv = dNdx.reshape(-1)  # div of phi^{a,i} = dN_a/dx_i
        K_lam += detJ * np.outer(Bdiv, Bdiv)
        gdot = dNdx @ dNdx.T  # (nen, nen) grad N_a . grad N_b
        for a in range(nen):
            for b in range(nen):
                for i in range(d):
                    for j in range(d):
                        K_mu[a * d + i, b * d + j] += detJ * (
                            (gdot[a, b] if i == j else 0.0)
                            + dNdx[a, j] * dNdx[b, i]
                        )
    return K_lam, K_mu


def lame_params(E: float, nu: float):
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    return lam, mu


def elasticity_beam(
    nx: int = 16,
    ny: int = 4,
    nz: int = 0,
    length: float = 8.0,
    height: float = 1.0,
    E: float = 1.0,
    nu: float = 0.3,
    stiff_contrast: float = 50.0,
    load: float = 1.0e-2,
    bc: str = "reduce",
) -> Problem:
    """Cantilever beam elasticity system (2D plane strain if nz==0, else 3D).

    The material in the last-quarter of the beam is `stiff_contrast`× stiffer
    (the reference's two-attribute piecewise coefficients with lambda*50,
    mu*50 on the second region, src/Elasticity.cpp:100-120).

    bc="reduce"   eliminate clamped dofs (SPD reduced system, MFEM-style).
    bc="identity" keep the full node grid: clamped rows/cols zeroed with a
                  unit diagonal (same free-dof solution). The full system
                  lives on the structured node grid, so its grid_shape is
                  set to the component-interleaved logical grid
                  (nx+1, ny+1, d*(nz+1)) and the operator admits the
                  DIA-stencil device format
                  (amg_tpu_torch.setup.structured.csr_to_dia_stencil)."""
    d = 2 if nz == 0 else 3
    cells = (nx, ny) if d == 2 else (nx, ny, nz)
    npts = tuple(c + 1 for c in cells)
    h = (
        (length / nx, height / ny)
        if d == 2
        else (length / nx, height / ny, height / nz)
    )
    K_lam, K_mu = _element_matrices(d, h)
    lam0, mu0 = lame_params(E, nu)

    node_id = np.arange(int(np.prod(npts))).reshape(npts)
    nen = 2**d
    # element -> node map, ordered to match _element_matrices' sign ordering
    # (itertools.product over (-1, +1) per axis = offsets (0, 1) per axis)
    corner_offsets = list(itertools.product((0, 1), repeat=d))
    cell_idx = np.stack(
        np.meshgrid(*[np.arange(c) for c in cells], indexing="ij"), axis=-1
    ).reshape(-1, d)
    elem_nodes = np.stack(
        [
            node_id[tuple((cell_idx + np.array(off)).T)]
            for off in corner_offsets
        ],
        axis=1,
    )  # (ncells, nen)
    elem_dofs = (elem_nodes[:, :, None] * d + np.arange(d)).reshape(
        -1, nen * d
    )  # (ncells, nen*d)

    # per-element material: last quarter of the beam is stiffer
    xfrac = (cell_idx[:, 0] + 0.5) / nx
    stiff = xfrac >= 0.75
    lam_e = np.where(stiff, stiff_contrast * lam0, lam0)
    mu_e = np.where(stiff, stiff_contrast * mu0, mu0)

    # vectorized assembly
    Ke = (
        lam_e[:, None, None] * K_lam[None, :, :]
        + mu_e[:, None, None] * K_mu[None, :, :]
    )
    rows = np.repeat(elem_dofs, nen * d, axis=1).reshape(-1)
    cols = np.tile(elem_dofs, (1, nen * d)).reshape(-1)
    A = sp.coo_matrix(
        (Ke.reshape(-1), (rows, cols)),
        shape=(node_id.size * d, node_id.size * d),
    ).tocsr()

    # clamped at x=0 face: eliminate those dofs (reference fixes boundary
    # attribute 1); keep the reduced SPD system
    clamped_nodes = node_id[0].reshape(-1)
    clamped = np.zeros(node_id.size * d, dtype=bool)
    for i in range(d):
        clamped[clamped_nodes * d + i] = True
    free = ~clamped
    if bc == "identity":
        # zero clamped rows+cols, unit diagonal: x_clamped = 0 exactly and
        # the free-dof block equals the reduced system
        keep = sp.diags(free.astype(SETUP_DTYPE))
        A_id = (keep @ A @ keep + sp.diags(clamped.astype(SETUP_DTYPE))).tocsr()
        A_id.eliminate_zeros()
        f_full = np.zeros(node_id.size * d, dtype=SETUP_DTYPE)
        end_nodes = node_id[-1].reshape(-1)
        f_full[end_nodes * d + (d - 1)] = -load
        f_full[clamped] = 0.0
        axes = [np.arange(p) * hh for p, hh in zip(npts, h)]
        coords = np.stack(
            np.meshgrid(*axes, indexing="ij"), axis=-1
        ).reshape(-1, d)
        B_full = rigid_body_modes(coords)
        # keep the full rigid-body candidates: zeroing clamped rows creates
        # zero columns in the SA tentative prolongator (aggregates entirely
        # inside the clamped face) and a singular coarsest operator; the
        # identity rows keep x_clamped = 0 under smoothing regardless
        ishape = tuple(npts[:-1]) + (npts[-1] * d,)
        return Problem(
            name="elasticity",
            A=CSRMatrix.from_scipy(A_id),
            stencil=None,
            grid_shape=ishape,
            rhs=f_full,
            near_nullspace=B_full,
            num_functions=d,
        )
    A_red = CSRMatrix.from_scipy(A[free][:, free].tocsr())

    # pull-down load on the free-end face (reference's boundary force on the
    # last attribute), assembled as nodal loads on the reduced system
    f = np.zeros(node_id.size * d, dtype=SETUP_DTYPE)
    end_nodes = node_id[-1].reshape(-1)
    f[end_nodes * d + (d - 1)] = -load

    # rigid body modes (near-nullspace candidates for aggregation AMG):
    # d translations + d(d-1)/2 rotations, evaluated at the node coordinates
    # and restricted to the free dofs
    axes = [np.arange(p) * hh for p, hh in zip(npts, h)]
    coords = np.stack(
        np.meshgrid(*axes, indexing="ij"), axis=-1
    ).reshape(-1, d)
    B = rigid_body_modes(coords)
    return Problem(
        name="elasticity",
        A=A_red,
        stencil=None,
        grid_shape=None,
        rhs=f[free],
        near_nullspace=B[free],
        num_functions=d,
    )


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """Rigid body modes of a d-dimensional elastic body with nodes at
    `coords` (n_nodes, d): translations + infinitesimal rotations, as an
    (n_nodes*d, d + d(d-1)/2) dof-interleaved candidate matrix."""
    nn, d = coords.shape
    nrot = d * (d - 1) // 2
    B = np.zeros((nn * d, d + nrot), dtype=coords.dtype)
    for i in range(d):
        B[i::d, i] = 1.0  # translations
    c = coords - coords.mean(axis=0)
    k = d
    for i in range(d):
        for j in range(i + 1, d):
            # rotation in the (i, j) plane: u_i = -x_j, u_j = x_i
            B[i::d, k] = -c[:, j]
            B[j::d, k] = c[:, i]
            k += 1
    return B
