"""Host-side CSR matrix (numpy/scipy) used during setup.

Counterpart of amg_tpu/sparse/csr.py. SpGEMM and transpose go through
scipy.sparse; the reference's optional native C++ route is not part of this
package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as _sp

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

    def diagonal(self) -> np.ndarray:
        return self.to_scipy().diagonal()

    def l1_row_norms(self) -> np.ndarray:
        """Row-wise sum of |a_ij| — the L1-Jacobi scaling."""
        out = np.abs(self.to_scipy()).sum(axis=1)
        return np.asarray(out).reshape(-1).astype(SETUP_DTYPE)

    def transpose(self) -> "CSRMatrix":
        return CSRMatrix.from_scipy(self.to_scipy().T.tocsr())

    def matmul(self, other: "CSRMatrix") -> "CSRMatrix":
        return CSRMatrix.from_scipy(self.to_scipy() @ other.to_scipy())

    def matvec(self, x: np.ndarray) -> np.ndarray:
        return self.to_scipy() @ x

    def __matmul__(self, other):
        if isinstance(other, CSRMatrix):
            return self.matmul(other)
        return self.matvec(other)
