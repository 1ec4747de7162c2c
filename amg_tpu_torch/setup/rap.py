"""Galerkin triple product, smoothed transfers and the setup-time spectral
estimate (counterpart of amg_tpu/setup/rap.py).

A_c = R A P with R = P^T (SpGEMM through `CSRMatrix.matmul`: the native
library, or scipy under AMG_TPU_NATIVE=0), and the multadd smoothed
transfers P~ = (I - w S^-1 A) P, R~ = P~^T.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch.sparse.csr import CSRMatrix


def galerkin_product(R: CSRMatrix, A: CSRMatrix, P: CSRMatrix) -> CSRMatrix:
    """A_c = R A P, with exact zeros from cancellation dropped."""
    ac = R.matmul(A).matmul(P).to_scipy()
    ac.sum_duplicates()
    ac.data[np.abs(ac.data) < 1e-300] = 0.0
    ac.eliminate_zeros()
    return CSRMatrix.from_scipy(ac)


def smoothed_transfer(
    A: CSRMatrix, P: CSRMatrix, scale: np.ndarray, w: float
) -> tuple[CSRMatrix, CSRMatrix]:
    """P~ = (I - w S^-1 A) P and R~ = P~^T; `scale` is diag(A) or the L1 row
    norms, matching the smoother in use."""
    g = sp.identity(A.n_rows, format="csr") - sp.diags(w / scale) @ A.to_scipy()
    ps = (g @ P.to_scipy()).tocsr()
    return CSRMatrix.from_scipy(ps), CSRMatrix.from_scipy(ps.T.tocsr())


def estimate_rho_dinv_a(
    A: CSRMatrix, iters: int = 30, seed: int = 0, scale: np.ndarray | None = None
) -> float:
    """Spectral-radius estimate of S^-1 A by power iteration from a
    `numpy.random.default_rng(seed)` start vector. `scale` defaults to diag(A)."""
    rng = np.random.default_rng(seed)
    a = A.to_scipy()
    d = A.diagonal() if scale is None else scale
    d = np.where(d == 0.0, 1.0, d)
    x = rng.random(A.n_rows)
    lam = 1.0
    for _ in range(iters):
        x = (a @ x) / d
        nrm = np.linalg.norm(x)
        if nrm == 0.0:
            return 1.0
        lam = nrm
        x /= nrm
    return float(lam)
