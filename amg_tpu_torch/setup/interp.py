"""Interpolation operators: classical direct and extended+i (counterpart
of amg_tpu/setup/interp.py).

Direct interpolation (the simple classical form): for F-point i with strong
C-neighbors C_i, split off-diagonal entries by sign and scale so each sign
class preserves its row sum:

    w_ij = -(sum_neg_k a_ik / sum_neg_{j in C_i} a_ij) * a_ij / a_ii   (a_ij<0)
    w_ij = -(sum_pos_k a_ik / sum_pos_{j in C_i} a_ij) * a_ij / a_ii   (a_ij>0)

If a sign class has no strong C entry its full-row sum is folded into the
diagonal instead (hypre's convention).

Extended+i: F-point i interpolates from C_i plus the C-points of its strong
F-neighbors (distance-2 set C_i^e), with each strong F-neighbor j's connection
distributed over the C-points it shares with the extended set, and weak/
unshared mass folded into the diagonal.

Both run in the port's native library (`native/amg_setup.cpp`, the same
algorithm row for row) unless AMG_TPU_NATIVE=0 selects the Python loops
below, their plain versions.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch import native_backend as nb
from amg_tpu_torch.setup.coarsen import C_PT
from amg_tpu_torch.sparse.csr import CSRMatrix


def _coarse_map(cf: np.ndarray) -> np.ndarray:
    cmap = -np.ones(len(cf), dtype=np.int64)
    cmap[cf == C_PT] = np.arange(int((cf == C_PT).sum()))
    return cmap


def _native_interp(kind, A_csr, S, cf):
    if not nb.use_native():
        return None
    cmap = _coarse_map(cf).astype(np.int32)
    nc = int((cf == C_PT).sum())
    s = S.tocsr()
    pi, pj, pv = nb.interpolation(
        kind, A_csr.indptr, A_csr.indices, A_csr.data,
        s.indptr, s.indices, (cf == C_PT).astype(np.int8), cmap,
        A_csr.n_rows, nc,
    )
    return CSRMatrix(
        indptr=pi.astype(np.int32), indices=pj.astype(np.int32),
        data=pv, shape=(A_csr.n_rows, nc),
    )


def direct_interpolation(A_csr, S: sp.csr_matrix, cf: np.ndarray) -> CSRMatrix:
    native = _native_interp("direct", A_csr, S, cf)
    if native is not None:
        return native
    a = A_csr.to_scipy().tocsr()
    n = a.shape[0]
    cmap = _coarse_map(cf)
    nc = int((cf == C_PT).sum())
    rows, cols, vals = [], [], []
    Sset = [set(S.indices[S.indptr[i] : S.indptr[i + 1]]) for i in range(n)]
    for i in range(n):
        if cf[i] == C_PT:
            rows.append(i)
            cols.append(cmap[i])
            vals.append(1.0)
            continue
        lo, hi = a.indptr[i], a.indptr[i + 1]
        idx = a.indices[lo:hi]
        val = a.data[lo:hi]
        diag = 0.0
        sum_neg = sum_pos = 0.0
        csum_neg = csum_pos = 0.0
        centries = []
        for j, v in zip(idx, val):
            if j == i:
                diag += v
                continue
            if v < 0:
                sum_neg += v
            else:
                sum_pos += v
            if cf[j] == C_PT and j in Sset[i]:
                centries.append((j, v))
                if v < 0:
                    csum_neg += v
                else:
                    csum_pos += v
        if not centries:
            continue  # isolated F-point: empty P row (smoother-only point)
        alpha = sum_neg / csum_neg if csum_neg != 0.0 else 0.0
        beta = sum_pos / csum_pos if csum_pos != 0.0 else 0.0
        if csum_neg == 0.0:
            diag += sum_neg
        if csum_pos == 0.0:
            diag += sum_pos
        for j, v in centries:
            scale = alpha if v < 0 else beta
            w = -scale * v / diag
            rows.append(i)
            cols.append(cmap[j])
            vals.append(w)
    p = sp.coo_matrix((vals, (rows, cols)), shape=(n, nc))
    return CSRMatrix.from_scipy(p)


def extended_i_interpolation(A_csr, S: sp.csr_matrix, cf: np.ndarray) -> CSRMatrix:
    """Extended+i interpolation (hypre interp_type 6 equivalent); dispatches
    to the native library (native/amg_setup.cpp, results identical)."""
    native = _native_interp("ext+i", A_csr, S, cf)
    if native is not None:
        return native
    a = A_csr.to_scipy().tocsr()
    n = a.shape[0]
    cmap = _coarse_map(cf)
    nc = int((cf == C_PT).sum())
    Sind = [S.indices[S.indptr[i] : S.indptr[i + 1]] for i in range(n)]
    Sset = [set(si) for si in Sind]
    rows, cols, vals = [], [], []
    for i in range(n):
        if cf[i] == C_PT:
            rows.append(i)
            cols.append(cmap[i])
            vals.append(1.0)
            continue
        # build the extended C set: strong C-neighbors + C-neighbors of strong
        # F-neighbors (distance 2)
        strongC = [j for j in Sind[i] if cf[j] == C_PT]
        strongF = [j for j in Sind[i] if cf[j] != C_PT]
        ext = dict.fromkeys(strongC)
        for j in strongF:
            for k in Sind[j]:
                if cf[k] == C_PT:
                    ext.setdefault(k)
        ext = list(ext.keys())
        if not ext:
            continue
        extset = set(ext)
        w = dict.fromkeys(ext, 0.0)
        lo, hi = a.indptr[i], a.indptr[i + 1]
        diag = 0.0
        for j, v in zip(a.indices[lo:hi], a.data[lo:hi]):
            if j == i:
                diag += v
            elif j in extset:
                w[j] += v
            elif j in Sset[i] and cf[j] != C_PT:
                # strong F-neighbor: distribute a_ij over the C-points k it
                # connects to that are in the extended set, weighted by a_jk;
                # the "+i" part: j's connection back to i joins the denominator
                # and that share folds into the diagonal.
                jlo, jhi = a.indptr[j], a.indptr[j + 1]
                jidx = a.indices[jlo:jhi]
                jval = a.data[jlo:jhi]
                denom = 0.0
                back_to_i = 0.0
                shares = []
                for k, vk in zip(jidx, jval):
                    if k in extset and np.sign(vk) == -np.sign(diag if diag != 0 else 1.0):
                        denom += vk
                        shares.append((k, vk))
                    elif k == i and np.sign(vk) == -np.sign(diag if diag != 0 else 1.0):
                        denom += vk
                        back_to_i = vk
                if denom == 0.0:
                    diag += v  # nothing to distribute to: lump into diagonal
                    continue
                for k, vk in shares:
                    w[k] += v * vk / denom
                if back_to_i != 0.0:
                    diag += v * back_to_i / denom
            else:
                diag += v  # weak connection: lump into diagonal
        if diag == 0.0:
            continue
        for j in ext:
            if w[j] != 0.0:
                rows.append(i)
                cols.append(cmap[j])
                vals.append(-w[j] / diag)
    p = sp.coo_matrix((vals, (rows, cols)), shape=(n, nc))
    return CSRMatrix.from_scipy(p)


def truncate_interpolation(
    P: CSRMatrix, trunc_factor: float = 0.0, max_elmts: int = 0
) -> CSRMatrix:
    """Row-wise truncation with row-sum-preserving rescale (the reference sets
    hypre's add_trunc_factor / add_P_max_elmts, src/DMEM_Setup.cpp:589-593).
    Fully vectorized (sort-based per-row ranking)."""
    if trunc_factor <= 0.0 and max_elmts <= 0:
        return P
    n = P.n_rows
    nnz = P.nnz
    if nnz == 0:
        return P
    indptr, indices, data = P.indptr, P.indices, P.data.astype(np.float64)
    counts = np.diff(indptr)
    row_ids = np.repeat(np.arange(n), counts)
    absd = np.abs(data)
    keep = np.ones(nnz, dtype=bool)
    if trunc_factor > 0.0:
        rowmax = np.zeros(n)
        np.maximum.at(rowmax, row_ids, absd)
        keep &= absd >= trunc_factor * rowmax[row_ids]
    if max_elmts > 0:
        # rank kept entries within each row by decreasing |value|
        order = np.lexsort((-np.where(keep, absd, -1.0), row_ids))
        starts = np.zeros(nnz, dtype=np.int64)
        starts[np.cumsum(counts[:-1])] = counts[:-1] if n > 1 else []
        rank_sorted = np.arange(nnz) - np.repeat(indptr[:-1].astype(np.int64), counts)
        rank = np.empty(nnz, dtype=np.int64)
        rank[order] = rank_sorted
        keep &= rank < max_elmts
    # row-sum-preserving rescale of the kept entries
    total = np.zeros(n)
    np.add.at(total, row_ids, data)
    ksum = np.zeros(n)
    np.add.at(ksum, row_ids[keep], data[keep])
    scale = np.where(ksum != 0.0, total / np.where(ksum == 0.0, 1.0, ksum), 1.0)
    new_data = data[keep] * scale[row_ids[keep]]
    import scipy.sparse as _sp

    out = _sp.csr_matrix(
        (new_data, (row_ids[keep], indices[keep])), shape=P.shape
    )
    return CSRMatrix.from_scipy(out)
