"""Setup-time spectral estimate (counterpart of amg_tpu/setup/rap.py)."""

from __future__ import annotations

import numpy as np

from amg_tpu_torch.sparse.csr import CSRMatrix


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
