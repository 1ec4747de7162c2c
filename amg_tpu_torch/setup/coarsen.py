"""C/F splitting: PMIS and HMIS-style coarsening (counterpart of
amg_tpu/setup/coarsen.py, with the same COARSENING keys).

PMIS (parallel modified independent set):
  measure(i) = |{j : i strongly influences j}| + rand[0,1)
  repeat: every undecided i whose measure beats all undecided neighbors in the
  symmetrized strength graph becomes C; undecided points strongly connected to
  a new C point become F. Points with no strong connections become F
  immediately (they need no coarse representation).

HMIS here = PMIS seeded by a first-pass greedy Ruge-Stueben sweep (higher
measures processed first). Deterministic under `seed`: the numpy routes draw
from `np.random.default_rng(seed)`, the native ones from the library's own
splitmix64 randoms, so the two pick different C-points in 3-D. The default
"hmis" is the native algorithm (the reference's default too); unlike the
reference it never falls back to the numpy `hmis`: a library that cannot be
built raises.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from amg_tpu_torch import native_backend as nb

F_PT = 0
C_PT = 1


def _sym_neighbors(S: sp.csr_matrix) -> sp.csr_matrix:
    return ((S + S.T) > 0).tocsr()


def pmis(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """Return cf[i] in {C_PT, F_PT}."""
    n = S.shape[0]
    rng = np.random.default_rng(seed)
    ST = S.T.tocsr()
    # measure: number of points i strongly influences (column count of S)
    meas = np.asarray(ST.sum(axis=1)).reshape(-1).astype(np.float64)
    meas += rng.random(n)
    G = _sym_neighbors(S)
    undecided = np.ones(n, dtype=bool)
    cf = np.full(n, F_PT, dtype=np.int8)
    # isolated points (no strong connections either way) → F immediately
    iso = np.asarray(G.sum(axis=1)).reshape(-1) == 0
    undecided[iso] = False
    while undecided.any():
        m = np.where(undecided, meas, -1.0)
        # i is selected iff its measure beats every undecided neighbor's
        neigh_max = np.full(n, -np.inf)
        gi, gj = G.nonzero() if G.nnz else (np.array([], int), np.array([], int))
        if G.nnz:
            vals = np.where(undecided[gj], m[gj], -np.inf)
            np.maximum.at(neigh_max, gi, vals)
        selected = undecided & (m > neigh_max)
        if not selected.any():
            # numerical tie (measure-rand collision): break by index
            idx = np.argmax(np.where(undecided, meas, -1.0))
            selected = np.zeros(n, dtype=bool)
            selected[idx] = True
        cf[selected] = C_PT
        undecided[selected] = False
        # undecided points strongly connected TO a new C point become F
        # (j depends on C ⇒ j interpolates from it)
        dep = S @ selected.astype(np.int8)  # i depends on some selected j
        newf = undecided & (np.asarray(dep).reshape(-1) > 0)
        undecided[newf] = False  # cf already F_PT
        # restrict graph to remaining undecided points
        G = G.multiply(undecided[:, None]).multiply(undecided[None, :]).tocsr()
    return cf


def _rs_first_pass(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """Greedy Ruge-Stüben first pass: process points in decreasing dynamic
    measure; chosen point → C, its dependents → F, and F-neighbors' influences
    get measure boosts. Used to seed HMIS."""
    n = S.shape[0]
    ST = S.T.tocsr()
    meas = np.asarray(ST.sum(axis=1)).reshape(-1).astype(np.float64)
    cf = np.full(n, -1, dtype=np.int8)
    iso = (np.asarray(S.sum(axis=1)).reshape(-1) + np.asarray(ST.sum(axis=1)).reshape(-1)) == 0
    cf[iso] = F_PT
    import heapq

    heap = [(-meas[i], i) for i in range(n) if cf[i] < 0]
    heapq.heapify(heap)
    Srows = S
    STrows = ST
    while heap:
        negm, i = heapq.heappop(heap)
        if cf[i] >= 0 or -negm != meas[i]:
            continue  # decided, or stale entry (fresh one is already queued)
        cf[i] = C_PT
        # points that depend on i become F; their other influences gain measure
        for j in STrows.indices[STrows.indptr[i] : STrows.indptr[i + 1]]:
            if cf[j] < 0:
                cf[j] = F_PT
                for k in Srows.indices[Srows.indptr[j] : Srows.indptr[j + 1]]:
                    if cf[k] < 0:
                        meas[k] += 1.0
                        heapq.heappush(heap, (-meas[k], k))
    cf[cf < 0] = F_PT
    return cf


def hmis(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """HMIS-style: PMIS whose random measures are biased by an RS first pass,
    giving the denser, more structured C sets of hypre's type-10 coarsening."""
    n = S.shape[0]
    rs = _rs_first_pass(S, seed)
    rng = np.random.default_rng(seed)
    ST = S.T.tocsr()
    meas = np.asarray(ST.sum(axis=1)).reshape(-1).astype(np.float64)
    meas += rng.random(n)
    meas += 2.0 * (rs == C_PT)  # RS C-points win ties in the MIS rounds
    G = _sym_neighbors(S)
    undecided = np.ones(n, dtype=bool)
    cf = np.full(n, F_PT, dtype=np.int8)
    iso = np.asarray(G.sum(axis=1)).reshape(-1) == 0
    undecided[iso] = False
    while undecided.any():
        m = np.where(undecided, meas, -1.0)
        neigh_max = np.full(n, -np.inf)
        if G.nnz:
            gi, gj = G.nonzero()
            vals = np.where(undecided[gj], m[gj], -np.inf)
            np.maximum.at(neigh_max, gi, vals)
        selected = undecided & (m > neigh_max)
        if not selected.any():
            idx = np.argmax(np.where(undecided, meas, -1.0))
            selected = np.zeros(n, dtype=bool)
            selected[idx] = True
        cf[selected] = C_PT
        undecided[selected] = False
        dep = S @ selected.astype(np.int8)
        newf = undecided & (np.asarray(dep).reshape(-1) > 0)
        undecided[newf] = False
        G = G.multiply(undecided[:, None]).multiply(undecided[None, :]).tocsr()
    return cf


def hmis_exact(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """Textbook HMIS (De Sterck/Yang/Heys 2006; hypre coarsen type 10):
    the classical RS first pass fixes its C set outright (even where two RS
    C-points are symmetric-graph neighbors — HMIS's C is deliberately not a
    strict MIS), its strong dependents become F, and PMIS then runs on the
    remaining undecided points only."""
    n = S.shape[0]
    rs = _rs_first_pass(S, seed)
    rng = np.random.default_rng(seed)
    ST = S.T.tocsr()
    meas = np.asarray(ST.sum(axis=1)).reshape(-1).astype(np.float64)
    meas += rng.random(n)
    G = _sym_neighbors(S)
    cf = np.full(n, F_PT, dtype=np.int8)
    undecided = np.ones(n, dtype=bool)
    iso = np.asarray(G.sum(axis=1)).reshape(-1) == 0
    undecided[iso] = False
    # pre-select the RS first-pass C set
    pre = rs == C_PT
    cf[pre] = C_PT
    undecided[pre] = False
    dep = S @ pre.astype(np.int8)
    undecided[np.asarray(dep).reshape(-1) > 0] = False  # F (already F_PT)
    G = G.multiply(undecided[:, None]).multiply(undecided[None, :]).tocsr()
    while undecided.any():
        m = np.where(undecided, meas, -1.0)
        neigh_max = np.full(n, -np.inf)
        if G.nnz:
            gi, gj = G.nonzero()
            vals = np.where(undecided[gj], m[gj], -np.inf)
            np.maximum.at(neigh_max, gi, vals)
        selected = undecided & (m > neigh_max)
        if not selected.any():
            idx = np.argmax(np.where(undecided, meas, -1.0))
            selected = np.zeros(n, dtype=bool)
            selected[idx] = True
        cf[selected] = C_PT
        undecided[selected] = False
        dep = S @ selected.astype(np.int8)
        undecided[undecided & (np.asarray(dep).reshape(-1) > 0)] = False
        G = G.multiply(undecided[:, None]).multiply(undecided[None, :]).tocsr()
    return cf


def pmis_native(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """PMIS via the native library (native/amg_setup.cpp): the same MIS
    properties, its own deterministic tie-breaking randoms."""
    s = S.tocsr()
    return nb.pmis(s.indptr, s.indices, s.shape[0], seed).astype(np.int8)


def hmis_native(S: sp.csr_matrix, seed: int = 0) -> np.ndarray:
    """HMIS via the native library (RS first pass + biased PMIS rounds)."""
    s = S.tocsr()
    return nb.hmis(s.indptr, s.indices, s.shape[0], seed).astype(np.int8)


COARSENING = {
    "pmis": pmis,
    "hmis": hmis_native,  # the native algorithm, always
    "hmis_py": hmis,
    "hmis_exact": hmis_exact,  # textbook HMIS (RS C set pre-selected)
    "pmis_native": pmis_native,
}
