"""Stencil problem generators (counterpart of amg_tpu/problems/laplacian.py).

Each constant-coefficient generator returns the assembled host CSR matrix
and the constant `StencilOperator` (float64 weights on the CPU; the
hierarchy setup moves them to the solve device); `vardifconv_3d` returns
the CSR matrix of its grid only. Homogeneous-Dirichlet truncation at the
boundary. The arrays equal the reference's exactly.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from amg_tpu_torch.dtypes import SETUP_DTYPE
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.stencil import StencilOperator, stencil_to_csr


@dataclass
class Problem:
    """A generated linear system Ax = b."""

    name: str
    A: CSRMatrix
    stencil: Optional[StencilOperator]
    grid_shape: Optional[Tuple[int, ...]]
    rhs: Optional[np.ndarray] = None  # the problem's own right-hand side
    near_nullspace: Optional[np.ndarray] = None
    num_functions: int = 1  # interleaved dofs per grid node
    # problem-specific auxiliary operators (Maxwell's discrete gradient "G"
    # and Nedelec nodal interpolation "Pi" for the AMS preconditioner)
    aux: Optional[dict] = None

    @property
    def n(self) -> int:
        return self.A.n_rows


def _make(name, offsets, weights, grid_shape) -> Problem:
    op = StencilOperator(
        weights=torch.as_tensor(np.asarray(weights, dtype=SETUP_DTYPE)),
        offsets=tuple(tuple(o) for o in offsets),
        grid_shape=tuple(grid_shape),
    )
    return Problem(
        name=name, A=stencil_to_csr(op), stencil=op, grid_shape=tuple(grid_shape)
    )


def laplacian_2d_5pt(nx: int, ny: int | None = None) -> Problem:
    """2D 5-point Laplacian, N = nx*ny."""
    ny = nx if ny is None else ny
    offsets = [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]
    weights = [4.0, -1.0, -1.0, -1.0, -1.0]
    return _make("5pt", offsets, weights, (nx, ny))


def laplacian_3d_7pt(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    cx: float = 1.0,
    cy: float = 1.0,
    cz: float = 1.0,
) -> Problem:
    """3D 7-point anisotropic Laplacian."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    offsets = [
        (0, 0, 0),
        (-1, 0, 0),
        (1, 0, 0),
        (0, -1, 0),
        (0, 1, 0),
        (0, 0, -1),
        (0, 0, 1),
    ]
    weights = [2.0 * (cx + cy + cz), -cx, -cx, -cy, -cy, -cz, -cz]
    return _make("7pt", offsets, weights, (nx, ny, nz))


def laplacian_3d_27pt(nx: int, ny: int | None = None, nz: int | None = None) -> Problem:
    """3D 27-point Laplacian: center 26, all neighbors -1."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    offsets = [o for o in itertools.product((-1, 0, 1), repeat=3)]
    weights = [26.0 if o == (0, 0, 0) else -1.0 for o in offsets]
    return _make("27pt", offsets, weights, (nx, ny, nz))


# Discretization schemes for the convection term, mirroring the reference's
# difconv_atype knob (reference: src/BuildHypreMatrix.cpp:14-292).
DIFCONV_FORWARD = 0
DIFCONV_BACKWARD = 1
DIFCONV_UPWIND = 2
DIFCONV_CENTERED = 3


def difconv_3d(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    eps: float = 1.0,
    ax: float = 1.0,
    ay: float = 1.0,
    az: float = 1.0,
    cx: float = 1.0,
    cy: float = 1.0,
    cz: float = 1.0,
    atype: int = DIFCONV_FORWARD,
) -> Problem:
    """3D 7-point diffusion-convection
    -div(eps*c grad(u)) + a . grad(u) on the unit cube with h = 1/(n+1)
    per axis; (cx,cy,cz) are the per-axis diffusion coefficients and
    (ax,ay,az) the convection velocity — the full coefficient vocabulary
    of the reference's -cx/-cy/-cz/-ax/-ay/-az flags (reference:
    src/Laplacian.cpp:158-199 and src/DMEM_BuildMatrix.cpp:169-440
    wrapping GenerateDifConv)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    hx, hy, hz = 1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1)
    # diffusion part (scaled by h^2-normalized FD weights)
    dx, dy, dz = eps * cx / hx**2, eps * cy / hy**2, eps * cz / hz**2
    offsets = [
        (0, 0, 0),
        (-1, 0, 0),
        (1, 0, 0),
        (0, -1, 0),
        (0, 1, 0),
        (0, 0, -1),
        (0, 0, 1),
    ]
    w = np.array(
        [2 * (dx + dy + dz), -dx, -dx, -dy, -dy, -dz, -dz], dtype=SETUP_DTYPE
    )
    conv = [(ax, hx, 1, 2), (ay, hy, 3, 4), (az, hz, 5, 6)]  # (a, h, minus_idx, plus_idx)
    for a, h, im, ip in conv:
        if atype == DIFCONV_FORWARD:
            w[0] += -a / h
            w[ip] += a / h
        elif atype == DIFCONV_BACKWARD:
            w[0] += a / h
            w[im] += -a / h
        elif atype == DIFCONV_CENTERED:
            w[im] += -a / (2 * h)
            w[ip] += a / (2 * h)
        elif atype == DIFCONV_UPWIND:
            if a >= 0:
                w[0] += a / h
                w[im] += -a / h
            else:
                w[0] += -a / h
                w[ip] += a / h
        else:
            raise ValueError(f"unknown difconv atype {atype}")
    return _make(f"difconv{atype}", offsets, list(w), (nx, ny, nz))


def vardifconv_3d(
    nx: int,
    ny: int | None = None,
    nz: int | None = None,
    eps: float = 1.0,
    seed: int = 0,
) -> Problem:
    """Variable-coefficient diffusion-convection: per-cell random diffusion
    coefficient and convection field, assembled directly to CSR (no constant
    stencil). Mirrors hypre's GenerateVarDifConv usage
    (reference: src/BuildHypreMatrix.cpp:200-292)."""
    import scipy.sparse as sp

    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    shape = (nx, ny, nz)
    n = nx * ny * nz
    rng = np.random.default_rng(seed)
    # smooth-ish positive diffusion field, convection ∝ position
    kappa = eps * (1.0 + rng.random(shape))
    hx, hy, hz = 1.0 / (nx + 1), 1.0 / (ny + 1), 1.0 / (nz + 1)
    idx = np.arange(n).reshape(shape)
    rows, cols, vals = [], [], []
    diag = np.zeros(shape, dtype=SETUP_DTYPE)
    axes = [(0, hx), (1, hy), (2, hz)]
    for ax_i, h in axes:
        # harmonic-mean face coefficient between cell and +1 neighbor
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax_i] = slice(0, shape[ax_i] - 1)
        sl_hi[ax_i] = slice(1, shape[ax_i])
        k_face = (
            2.0
            * kappa[tuple(sl_lo)]
            * kappa[tuple(sl_hi)]
            / (kappa[tuple(sl_lo)] + kappa[tuple(sl_hi)])
        ) / h**2
        r = idx[tuple(sl_lo)].reshape(-1)
        c = idx[tuple(sl_hi)].reshape(-1)
        v = -k_face.reshape(-1)
        rows += [r, c]
        cols += [c, r]
        vals += [v, v]
        diag[tuple(sl_lo)] += k_face
        diag[tuple(sl_hi)] += k_face
        # boundary faces (Dirichlet): add kappa/h^2 on boundary cells
        sl_b0 = [slice(None)] * 3
        sl_b0[ax_i] = slice(0, 1)
        sl_b1 = [slice(None)] * 3
        sl_b1[ax_i] = slice(shape[ax_i] - 1, shape[ax_i])
        diag[tuple(sl_b0)] += kappa[tuple(sl_b0)] / h**2
        diag[tuple(sl_b1)] += kappa[tuple(sl_b1)] / h**2
    rows.append(idx.reshape(-1))
    cols.append(idx.reshape(-1))
    vals.append(diag.reshape(-1))
    m = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return Problem(
        name="vardifconv", A=CSRMatrix.from_scipy(m), stencil=None, grid_shape=shape
    )
