"""The 3-D 27-point Laplacian, frozen for the benchmark (plain NumPy/SciPy).

hypre's `GenerateLaplacian27pt` as the async-multigrid code calls it for
`-problem 27pt` (src/Laplacian.cpp:71-199): on an n x n x n grid, centre
26, all 26 neighbours -1, homogeneous Dirichlet truncation at the boundary,
rows in C order of (i, j, k). The stencil is kept beside the matrix: the
program's fine level applies it as shifted slices.
"""

from __future__ import annotations

import itertools

import numpy as np
import scipy.sparse as sp

OFFSETS = tuple(itertools.product((-1, 0, 1), repeat=3))
WEIGHTS = tuple(26.0 if o == (0, 0, 0) else -1.0 for o in OFFSETS)


def stencil_matrix(offsets, weights, shape) -> sp.csr_matrix:
    """The constant stencil assembled as a CSR matrix with sorted indices,
    zero outside the grid."""
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    rows, cols, vals = [], [], []
    for w, off in zip(weights, offsets):
        src = tuple(slice(max(-d, 0), s - max(d, 0)) for d, s in zip(off, shape))
        dst = tuple(slice(max(d, 0), s - max(-d, 0)) for d, s in zip(off, shape))
        rows.append(idx[src].reshape(-1))
        cols.append(idx[dst].reshape(-1))
        vals.append(np.full(idx[src].size, w, dtype=np.float64))
    m = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m


def generate(n: int) -> dict:
    """{"A": CSR, "stencil": {"offsets", "weights", "grid_shape"}}."""
    shape = (n, n, n)
    return {"A": stencil_matrix(OFFSETS, WEIGHTS, shape),
            "stencil": {"offsets": OFFSETS, "weights": WEIGHTS, "grid_shape": shape}}
