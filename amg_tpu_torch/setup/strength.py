"""Classical strength-of-connection graph (counterpart of
amg_tpu/setup/strength.py). Point j strongly influences i when

    -a_ij >= theta * max_{k != i} (-a_ik)        (positive-diagonal rows;
                                                  sign-flipped otherwise)

Returns a boolean CSR pattern S (same sparsity as A minus the diagonal and
weak entries).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def strength_graph(
    A_csr, theta: float = 0.25, num_functions: int = 1
) -> sp.csr_matrix:
    """num_functions > 1 enables unknown-based systems treatment: only
    same-function (same dof component, interleaved ordering) couplings can be
    strong — hypre's HYPRE_BoomerAMGSetNumFunctions behavior, required for
    elasticity-type systems (reference builds vector-valued MFEM systems,
    src/Elasticity.cpp:7-261)."""
    a = A_csr.to_scipy().tocsr()
    n = a.shape[0]
    indptr, indices, data = a.indptr, a.indices, a.data
    diag = a.diagonal()
    # orient every row so "negative off-diagonal" means "connection":
    # rows with negative diagonal are sign-flipped (hypre semantics)
    sign = np.where(diag < 0, -1.0, 1.0)
    row_ids = np.repeat(np.arange(n), np.diff(indptr))
    vals = data * sign[row_ids]
    offdiag = indices != row_ids
    if num_functions > 1:
        offdiag &= (indices % num_functions) == (row_ids % num_functions)
    conn = np.where(offdiag, -vals, -np.inf)  # candidate strengths
    # per-row max of connection strength
    maxconn = np.full(n, -np.inf)
    np.maximum.at(maxconn, row_ids, conn)
    maxconn = np.where(np.isfinite(maxconn), maxconn, 0.0)
    strong = offdiag & (conn >= theta * maxconn[row_ids]) & (conn > 0.0)
    # copy index arrays: eliminate_zeros() mutates them in place, and they
    # must not alias A's
    s = sp.csr_matrix(
        (strong.astype(np.int8), indices.copy(), indptr.copy()), shape=(n, n)
    )
    s.eliminate_zeros()
    return s
