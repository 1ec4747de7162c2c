"""Stencil problem generators (counterpart of amg_tpu/problems/laplacian.py).

Each generator returns the assembled host CSR matrix and the constant
`StencilOperator` (float64 weights on the CPU; the hierarchy builder moves
them to the solve device). Homogeneous-Dirichlet truncation at the boundary.
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
