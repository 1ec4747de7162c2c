"""Device-side ELL (padded-row) sparse matrix (counterpart of
amg_tpu/sparse/ell.py).

Every row is padded to the same width `k`; the spmv gathers x by `cols`,
multiplies by `vals` and sums over the slot axis. Padding: col 0, val 0
(safe under the gather). `cols` stays int32 on the device: `index_select`
takes it on the CPU and on the card, and it halves the index bytes the spmv
reads. Transposes (restriction) are materialized on the host at setup.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amg_tpu_torch.dtypes import INDEX_DTYPE
from amg_tpu_torch.utils import tracing


@dataclass
class ELLMatrix:
    """cols: (n_rows, k) int32; vals: (n_rows, k); shape_cols: the operator's
    number of columns (rectangular P and R know their domain)."""

    cols: torch.Tensor
    vals: torch.Tensor
    shape_cols: int

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.shape_cols)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return ell_spmv(self, x)

    def __matmul__(self, x):
        return ell_spmv(self, x)


def ell_arrays(csr, k: int | None = None):
    """(cols, vals) float64/int32 numpy arrays of the ELL form of a host
    CSRMatrix, rows padded to width k (default: the widest row, at least 1)."""
    n = csr.n_rows
    if k is None:
        k = max(csr.max_row_nnz, 1)
    cols = np.zeros((n, k), dtype=INDEX_DTYPE)
    vals = np.zeros((n, k), dtype=np.float64)
    counts = np.diff(csr.indptr)
    if csr.nnz:
        row_ids = np.repeat(np.arange(n), counts)
        slot = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
        cols[row_ids, slot] = csr.indices
        vals[row_ids, slot] = csr.data
    return cols, vals


def ell_from_csr(csr, k: int | None = None, dtype=torch.float64, device="cpu") -> ELLMatrix:
    """Convert a host CSRMatrix to ELL on `device`, padding rows to width k."""
    cols, vals = ell_arrays(csr, k)
    return ELLMatrix(
        cols=torch.from_numpy(cols).to(device),
        vals=torch.from_numpy(vals).to(device=device, dtype=dtype),
        shape_cols=csr.n_cols,
    )


def ell_spmv(a: ELLMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: gather + multiply + reduce over the slot axis."""
    tracing.count("spmv.ell")
    g = torch.index_select(x, 0, a.cols.reshape(-1)).view(a.cols.shape)
    return (a.vals * g).sum(dim=1)
