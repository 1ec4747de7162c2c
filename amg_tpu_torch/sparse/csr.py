"""Host-side CSR matrix (numpy/scipy) used during setup.

Counterpart of amg_tpu/sparse/csr.py. SpGEMM and transpose go through the
port's native setup library (`amg_tpu_torch.native_backend`) unless
AMG_TPU_NATIVE=0 selects scipy.sparse, their plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as _sp

from amg_tpu_torch import native_backend as nb
from amg_tpu_torch.dtypes import INDEX_DTYPE, SETUP_DTYPE


@dataclass
class CSRMatrix:
    """Compressed sparse row matrix: indptr[n+1], indices[nnz], data[nnz]."""

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr()
        m.sum_duplicates()
        return CSRMatrix(
            indptr=m.indptr.astype(INDEX_DTYPE),
            indices=m.indices.astype(INDEX_DTYPE),
            data=m.data.astype(SETUP_DTYPE),
            shape=tuple(m.shape),
        )

    def to_scipy(self) -> _sp.csr_matrix:
        return _sp.csr_matrix(
            (self.data, self.indices, self.indptr), shape=self.shape, copy=False
        )

    def to_dense(self) -> np.ndarray:
        return self.to_scipy().toarray()

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def max_row_nnz(self) -> int:
        if self.n_rows == 0:
            return 0
        return int(np.max(np.diff(self.indptr)))

    def diagonal(self) -> np.ndarray:
        return self.to_scipy().diagonal()

    def l1_row_norms(self) -> np.ndarray:
        """Row-wise sum of |a_ij| — the L1-Jacobi scaling."""
        out = np.abs(self.to_scipy()).sum(axis=1)
        return np.asarray(out).reshape(-1).astype(SETUP_DTYPE)

    def transpose(self) -> "CSRMatrix":
        if nb.use_native():
            bi, bj, bv = nb.transpose(self.indptr, self.indices, self.data, self.shape)
            return CSRMatrix(indptr=bi.astype(INDEX_DTYPE), indices=bj.astype(INDEX_DTYPE),
                             data=bv, shape=(self.n_cols, self.n_rows))
        return CSRMatrix.from_scipy(self.to_scipy().T.tocsr())

    def matmul(self, other: "CSRMatrix") -> "CSRMatrix":
        if nb.use_native():
            ci, cj, cv = nb.spgemm(
                self.indptr, self.indices, self.data,
                other.indptr, other.indices, other.data,
                self.shape, other.shape,
            )
            return CSRMatrix(indptr=ci.astype(INDEX_DTYPE), indices=cj.astype(INDEX_DTYPE),
                             data=cv, shape=(self.n_rows, other.n_cols))
        return CSRMatrix.from_scipy(self.to_scipy() @ other.to_scipy())

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    def __matmul__(self, other):
        if isinstance(other, CSRMatrix):
            return self.matmul(other)
        return self.matvec(other)
