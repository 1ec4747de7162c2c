"""The work model and the level -> device assignment of grid (level)
parallelism (counterpart of amg_tpu/parallel/partition.py, plain numpy,
copied).

Each level's work is proportional to its operator nnz (matvec and smoother
cost) plus a vector-op term, and devices are assigned to levels in
contiguous ranges sized by work fraction: the reference's ComputeWork /
AssignProcs with its communicator split (reference:
src/DMEM_Setup.cpp:1638-1846). On the port's row mesh the split is a range
of logical shards per level (`parallel.grid.plan_grid_levels`), or a block
of the padded extended system's rows
(`parallel.dist.pad_extended_layout`). The assignment decides every result
downstream, so both functions are the reference's bit for bit.
"""

from __future__ import annotations

import numpy as np


def compute_level_work(
    hh, async_mode: bool = True, imbalance: float = 0.0,
    fine_residual: bool | None = None,
    smoothed_transfers: bool = False,
) -> np.ndarray:
    """Per-level relative work (summing to 1), in flop units of what a grid
    group runs a cycle: the fine residual of its stale read (async
    local-residual mode), the restrict chain down to its level and the
    prolong chain back (2 flops per nnz each way; shared over one sweep in
    the sync model), the level's smoothing (a diagonal scale with smoothed
    transfers, else ~2 matvec-equivalents) and 5 vector ops a row.
    `imbalance` scales level k by 1 + imbalance * u_k, u from
    default_rng(0) (the reference's -imbal)."""
    if fine_residual is None:
        fine_residual = async_mode
    L = hh.num_levels
    nnz = np.array([lv.A.nnz for lv in hh.levels], dtype=np.float64)
    rows = np.array([lv.A.n_rows for lv in hh.levels], dtype=np.float64)

    def chain_op(lv):
        # multadd's chains run through the denser smoothed transfers P~ = G P
        op = lv.P_s if smoothed_transfers and lv.P_s is not None else lv.P
        return op.nnz if op is not None else 0

    p_nnz = np.array([chain_op(lv) for lv in hh.levels], dtype=np.float64)
    work = np.zeros(L)
    for k in range(L):
        chain = 4.0 * p_nnz[:k].sum()
        if not async_mode:
            chain /= max(L, 1)
        smooth_cost = 2.0 * rows[k] if smoothed_transfers else 4.0 * nnz[k]
        work[k] = chain + smooth_cost + 5.0 * rows[k]
        if fine_residual:
            work[k] += 2.0 * nnz[0]
    if imbalance != 0.0:
        rng = np.random.default_rng(0)
        work *= 1.0 + imbalance * rng.random(L)
    return work / work.sum()


def assign_levels_to_devices(
    work: np.ndarray, num_devices: int,
    policy: str = "balanced", scalar: float = 0.5,
) -> list:
    """[(dev_start, dev_end_exclusive)] per level: contiguous device ranges
    sized by work fraction, every level at least one device where there are
    as many devices as levels (reference: AssignProcs,
    src/DMEM_Setup.cpp:1638-1759).

    policy "balanced": largest-remainder apportionment of num_devices by
    work, with a floor of one device. "scalar": geometric decay, each level
    max(floor(prev * scalar), 1) devices, repaired to num_devices with the
    surplus on the coarsest level (-assign_procs_scalar). With fewer devices
    than levels, consecutive levels share one device each, split at equal
    cumulative work."""
    L = len(work)
    if num_devices >= L:
        if policy == "scalar":
            counts = np.zeros(L, dtype=int)
            cand = num_devices
            for k in range(L):
                cand = max(int(np.floor(cand * scalar)), 1)
                counts[k] = cand
            while counts.sum() > num_devices:
                big = int(np.argmax(counts))
                counts[big] -= 1
            counts[-1] += num_devices - counts.sum()
        else:
            ideal = work * num_devices
            counts = np.maximum(np.floor(ideal).astype(int), 1)
            while counts.sum() > num_devices:
                counts[np.argmax(counts)] -= 1
            order = np.argsort(-(ideal - counts))
            i = 0
            while counts.sum() < num_devices:
                counts[order[i % L]] += 1
                i += 1
        out = []
        start = 0
        for k in range(L):
            out.append((start, start + int(counts[k])))
            start += int(counts[k])
        return out
    mid = np.cumsum(work) - work / 2.0
    devs = np.minimum((mid * num_devices).astype(int), num_devices - 1)
    devs = np.maximum.accumulate(devs)  # keep level -> device monotone
    return [(int(d), int(d) + 1) for d in devs]
