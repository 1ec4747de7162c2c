#!/usr/bin/env python3
"""The size of the grid-mapped extended system's explicit AA, the port's
`solve.extended.build_sharded_extended_system` on the runner's 27-point
problem over 8 shards, counted on the host without building it:

    python3 tools/torch_ext_ell_size.py 20 30 31 [n ...]

For each side n: the level sizes, the padded row count, AA's nonzeros, its
ELL width (the widest row; the coarsest rows are nearly dense) and slots,
and the device bytes of a matvec: 12 B a slot held (float64 value, int32
column) and 16 B a slot more for the gather and the product of
`parallel.spcomm.halo_spmv`. A few seconds a side up to 36^3 on the CPU.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv) -> int:
    import numpy as np
    import scipy.sparse as sp
    import torch

    from amg_tpu_torch.parallel.dist import pad_extended_layout
    from amg_tpu_torch.parallel.partition import assign_levels_to_devices, compute_level_work
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import setup_experiment

    torch.set_num_threads(2)
    for n in map(int, argv or ["20", "30", "31"]):
        t0 = time.perf_counter()
        opts = SolverOptions(problem="27pt", n=n, solver="explicit_ext_bpx", tol=1e-8)
        hh = setup_experiment(opts, "cpu").hh
        sizes = [lv.A.n_rows for lv in hh.levels]
        assignment = assign_levels_to_devices(compute_level_work(hh), 8)
        p_off, p_total, _ = pad_extended_layout(sizes, assignment, 8)
        A0 = hh.levels[0].A.to_scipy()
        chains = [sp.identity(sizes[0], format="csr")]
        for k in range(len(sizes) - 1):
            chains.append((chains[-1] @ hh.levels[k].P.to_scipy()).tocsr())
        row_nnz = np.zeros(p_total, np.int64)
        for l in range(len(sizes)):
            left = (chains[l].T @ A0).tocsr()
            for m in range(len(sizes)):
                blk = (left @ chains[m]).tocsr()
                row_nnz[p_off[l]: p_off[l] + sizes[l]] += np.diff(blk.indptr)
        width = max(int(row_nnz.max()), 1)
        slots = p_total * width
        print(f"27pt {n}^3: levels {sizes}, {p_total} padded rows, {int(row_nnz.sum())} nonzeros, "
              f"ELL width {width}, {slots} slots: {slots * 12 / 1e9:.2f} GB held, "
              f"{slots * 28 / 1e9:.2f} GB in a matvec ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
