"""Instrumentation and output formatting (counterpart of
amg_tpu/utils/stats.py): the same report lines and the same one-line JSON
keys as the reference's drivers (-oneline_output).

A solve reports setup wall time | solve wall time | cycles | per-cycle
residual history | grid-wait stats (async) | per-level hierarchy stats;
`-print_level_stats` adds the segmented per-phase profile
(`utils/phases.py`). Kernel-level breakdowns on the card come from
torch.profiler (`chip_smoke.py`).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class SolveStats:
    problem: str = ""
    solver: str = ""
    smoother: str = ""
    n: int = 0
    nnz: int = 0
    num_levels: int = 0
    operator_complexity: float = 0.0
    setup_wtime: float = 0.0
    solve_wtime: float = 0.0
    cycles: int = 0
    rel_resnorm: float = 0.0
    history: list = field(default_factory=list)
    level_n: list = field(default_factory=list)
    level_nnz: list = field(default_factory=list)
    grid_wait: Optional[dict] = None
    phase: Optional[object] = None  # PhaseReport (print_level_stats mode)
    # relative A-norm error for zero-RHS runs (reference: e_Anorm/e0_Anorm,
    # src/DMEM_Misc.cpp:63-65)
    e_anorm_rel: Optional[float] = None
    # the final iterate, a tensor on the run's device (the port's addition;
    # neither printed nor in the one-line JSON)
    x: Optional[object] = field(default=None, repr=False)

    def convergence_factor(self) -> float:
        h = self.history
        if len(h) == 2 and self.cycles > 0:
            # no_resnorm mode records only (start, final): geometric mean
            # over the actual cycle count
            return (h[-1] / max(h[0], 1e-300)) ** (1.0 / self.cycles)
        if len(h) < 3:
            return 0.0
        return (h[-1] / h[1]) ** (1.0 / (len(h) - 2))

    def print_report(self, opts) -> None:
        if opts.oneline_output:
            print(self.oneline())
            return
        print(f"problem        : {self.problem} (n={self.n}, nnz={self.nnz})")
        print(f"solver         : {self.solver} / {self.smoother}")
        print(
            f"hierarchy      : {self.num_levels} levels, "
            f"op complexity {self.operator_complexity:.3f}"
        )
        if opts.print_level_stats:
            for k, (ln, lz) in enumerate(zip(self.level_n, self.level_nnz)):
                print(f"  level {k}: n={ln} nnz={lz}")
            if self.phase is not None:
                self.phase.print_table()
        print(f"setup wtime    : {self.setup_wtime:.4f} s")
        print(f"solve wtime    : {self.solve_wtime:.4f} s")
        print(f"cycles         : {self.cycles}")
        print(f"rel res 2-norm : {self.rel_resnorm:.6e}")
        if self.e_anorm_rel is not None:
            print(f"rel A-norm err : {self.e_anorm_rel:.6e}")
        print(f"conv factor    : {self.convergence_factor():.4f}")
        if opts.print_reshist:
            print("reshist:")
            for i, r in enumerate(self.history):
                rate = r / self.history[i - 1] if i > 0 and self.history[i - 1] else 0
                print(f"  {i}\t{r:.6e}\t{rate:.4f}")
        if self.grid_wait is not None and opts.print_grid_wait:
            gw = self.grid_wait
            print("grid-wait (per level): mean/min/max/corrections")
            for lvl in range(len(gw["mean"])):
                print(
                    f"  level {lvl}: {gw['mean'][lvl]:.2f} / "
                    f"{gw['min'][lvl]:.0f} / {gw['max'][lvl]:.0f} / "
                    f"{gw['num_correct'][lvl]}"
                )

    def oneline(self) -> str:
        return json.dumps(
            {
                "problem": self.problem,
                "solver": self.solver,
                "smoother": self.smoother,
                "n": self.n,
                "nnz": self.nnz,
                "levels": self.num_levels,
                "op_complexity": round(self.operator_complexity, 4),
                "setup_wtime": round(self.setup_wtime, 6),
                "solve_wtime": round(self.solve_wtime, 6),
                "cycles": self.cycles,
                "rel_res": self.rel_resnorm,
                "conv_factor": round(self.convergence_factor(), 5),
            }
        )


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
