"""Constant-coefficient stencil operator (counterpart of amg_tpu/sparse/stencil.py).

The matvec is a sum of shifted slices of the zero-padded grid view; the zero
padding reproduces the homogeneous-Dirichlet truncation of the assembled
matrix. `stencil_to_csr` assembles the same operator on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.utils import tracing


@dataclass
class StencilOperator:
    """weights: (m,) tensor; offsets/grid_shape: static metadata."""

    weights: torch.Tensor
    offsets: Tuple[Tuple[int, ...], ...]
    grid_shape: Tuple[int, ...]

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.n_rows)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return stencil_matvec(self, x)

    def __matmul__(self, x):
        return stencil_matvec(self, x)

    def diagonal(self) -> torch.Tensor:
        """Constant diagonal broadcast to a full vector (center weight)."""
        center = torch.zeros((), dtype=self.weights.dtype, device=self.weights.device)
        for w_idx, off in enumerate(self.offsets):
            if all(d == 0 for d in off):
                center = self.weights[w_idx]
        return center.expand(self.n_rows).clone()


def tap_sum(grid: torch.Tensor, coeffs, offsets) -> torch.Tensor:
    """sum_t coeffs[t] * shift(grid, offset_t), zero outside the grid, the
    taps summed in list order from zeros: coeffs[t] is a scalar (a constant
    stencil's weight) or grid-shaped (a variable stencil's plane). The
    expression of every global stencil and DIA matvec of the port, as K5
    and its plain version sum (`ops.var_stencil.var_apply_plain`)."""
    ndim = grid.ndim
    reach = [max(abs(off[d]) for off in offsets) for d in range(ndim)]
    # F.pad lists (before, after) pairs from the LAST axis backwards
    pad = []
    for d in reversed(range(ndim)):
        pad += [reach[d], reach[d]]
    padded = F.pad(grid, pad)
    y = torch.zeros_like(grid)
    for t, off in enumerate(offsets):
        idx = tuple(
            slice(reach[d] + off[d], reach[d] + off[d] + grid.shape[d])
            for d in range(ndim)
        )
        y = y + coeffs[t] * padded[idx]
    return y


def stencil_matvec(a: StencilOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x via shifted-slice accumulation on the grid view."""
    tracing.count("spmv.stencil")
    return tap_sum(x.reshape(a.grid_shape), a.weights, a.offsets).reshape(x.shape)


def stencil_to_csr(a: StencilOperator):
    """Assemble the stencil into a host CSRMatrix (for setup / validation)."""
    import scipy.sparse as sp

    from amg_tpu_torch.sparse.csr import CSRMatrix

    shape = a.grid_shape
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows_all, cols_all, vals_all = [], [], []
    weights = a.weights.detach().cpu().numpy().astype(np.float64)
    for w, off in zip(weights, a.offsets):
        # rows (i) whose neighbor i+off is inside the grid
        src = tuple(slice(max(-d, 0), s - max(d, 0)) for d, s in zip(off, shape))
        dst = tuple(slice(max(d, 0), s - max(-d, 0)) for d, s in zip(off, shape))
        rows_all.append(idx[src].reshape(-1))
        cols_all.append(idx[dst].reshape(-1))
        vals_all.append(np.full(idx[src].size, w))
    m = sp.coo_matrix(
        (
            np.concatenate(vals_all),
            (np.concatenate(rows_all), np.concatenate(cols_all)),
        ),
        shape=(n, n),
    )
    return CSRMatrix.from_scipy(m)
