"""Per-phase instrumentation: smooth / residual / restrict / prolong / coarse
(counterpart of amg_tpu/utils/phases.py).

`profile_phases` runs the production cycle (`solve.cycles.cycle_step`) with
tracing on (`utils/tracing.py`) and reads the phases from its spans
(`amg.smooth:k`, `amg.residual:k`, `amg.restrict:k`, `amg.prolong:k`,
`amg.coarse`): on the CPU a phase's time is its spans' host time; on the
card the stream time between the CUDA events each span records, read once
after the cycles, so the card is not synchronised inside a cycle. That
stream time holds the launch gaps inside the span too: where the host
launches slower than the card runs, a phase's time is partly host time.
One warm-up cycle runs first (a first call may build a kernel).
`comm_bytes` / `comm_msgs` count, per level and cycle, the halo matvecs of
a row-sharded hierarchy over the warm-up cycle (`parallel.spcomm.
comm_trace`'s log: the wire bytes a shard ships, one message per halo
matvec, as the reference counts them), each at the level of the span open
when it was sent: inside an additive correction, the correction's level;
elsewhere the innermost span's. A message under no span with a level (a
V-cycle's coarse solve) is not counted, nor, as the reference does, an
additive cycle's level-0 residual, which belongs to no correction (ROADMAP
F12); one device exchanges nothing and reports 0.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, cycle_step
from amg_tpu_torch.utils import tracing


@dataclass
class PhaseReport:
    """Per-phase wall times (s) and counts, per level (the reference's
    smooth/residual/restrict/prolong/coarse times and message counts)."""

    num_levels: int = 0
    cycles: int = 0
    smooth: list = field(default_factory=list)  # (L,) seconds
    residual: list = field(default_factory=list)
    restrict: list = field(default_factory=list)
    prolong: list = field(default_factory=list)
    coarse: float = 0.0
    vecop: float = 0.0
    comm_bytes: list = field(default_factory=list)  # (L,) per cycle
    comm_msgs: list = field(default_factory=list)

    def totals(self) -> dict:
        return {
            "smooth_wtime": float(np.sum(self.smooth)),
            "residual_wtime": float(np.sum(self.residual)),
            "restrict_wtime": float(np.sum(self.restrict)),
            "prolong_wtime": float(np.sum(self.prolong)),
            "coarse_wtime": float(self.coarse),
            "vecop_wtime": float(self.vecop),
            "comm_bytes_per_cycle": int(np.sum(self.comm_bytes)),
            "comm_msgs_per_cycle": int(np.sum(self.comm_msgs)),
        }

    def print_table(self) -> None:
        t = self.totals()
        print(
            f"per-phase wtime over {self.cycles} instrumented cycles "
            f"(s, summed over levels):"
        )
        for k in ("smooth_wtime", "residual_wtime", "restrict_wtime",
                  "prolong_wtime", "coarse_wtime", "vecop_wtime"):
            print(f"  {k:16s}: {t[k]:.6f}")
        print(
            f"  comm/cycle      : {t['comm_msgs_per_cycle']} msgs, "
            f"{t['comm_bytes_per_cycle']} bytes"
        )
        print("  per-level (smooth/residual/restrict/prolong s):")
        for k in range(self.num_levels):
            rs = self.restrict[k] if k < len(self.restrict) else 0.0
            pr = self.prolong[k] if k < len(self.prolong) else 0.0
            print(
                f"    level {k}: {self.smooth[k]:.6f} / "
                f"{self.residual[k]:.6f} / {rs:.6f} / {pr:.6f}"
            )


PHASES = ("smooth", "residual", "restrict", "prolong")


def _report(L, num_cycles) -> PhaseReport:
    return PhaseReport(
        num_levels=L, cycles=num_cycles,
        smooth=[0.0] * L, residual=[0.0] * L,
        restrict=[0.0] * L, prolong=[0.0] * L,
        comm_bytes=[0] * L, comm_msgs=[0] * L,
    )


class _LevelLog(list):
    """A comm_trace log that also keeps the spans open at each message."""

    def __init__(self):
        super().__init__()
        self.where = []

    def append(self, nbytes):
        super().append(nbytes)
        self.where.append(tracing.open_spans())


def _span_level(name: str):
    """(phase, level) of a span name `amg.<phase>[:<level>]`."""
    phase, _, lvl = name[len("amg."):].partition(":")
    return phase, (int(lvl) if lvl else None)


def _comm_level(spans: tuple, additive: bool):
    """The level a halo message counts at (None: not counted)."""
    parsed = [_span_level(s) for s in spans]
    for phase, lvl in parsed:
        if phase == "correction":
            return lvl
    if additive:
        return None
    levels = [lvl for _, lvl in parsed if lvl is not None]
    return levels[-1] if levels else None


def _warm_up(hier, cfg, rep, x0, b) -> None:
    """One cycle, counting each level's halo traffic."""
    mesh = hier.mesh
    log = _LevelLog()
    if mesh is not None:
        mesh.trace = log
    try:
        with tracing.on():
            cycle_step(hier, cfg, x0, b)
    finally:
        if mesh is not None:
            mesh.trace = None
    additive = cfg.cycle not in (CycleType.MULT, CycleType.MULT_MULTADD)
    for nbytes, spans in zip(log, log.where):
        lvl = _comm_level(spans, additive)
        if lvl is not None:
            rep.comm_bytes[lvl] += int(nbytes)
            rep.comm_msgs[lvl] += 1


def profile_phases(
    hier, cfg: CycleConfig, b, x0=None, num_cycles: int = 5
) -> PhaseReport:
    """Per-phase times of num_cycles production cycles from x0, per level,
    read from the cycle's spans."""
    L = hier.num_levels
    if x0 is None:
        x0 = torch.zeros_like(b)
    rep = _report(L, num_cycles)
    _warm_up(hier, cfg, rep, x0, b)
    cuda = b.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(b.device)
    tracing.reset(counters=False)
    with tracing.on(events=b.device if cuda else None):
        x = x0
        for _ in range(num_cycles):
            x = cycle_step(hier, cfg, x, b)
    if cuda:
        seconds = tracing.event_seconds()
    else:
        seconds = {k: t for k, (t, _) in tracing.totals().items()}
    for name, t in seconds.items():
        phase, lvl = _span_level(name)
        if phase == "coarse":
            rep.coarse += t
        elif phase in PHASES and lvl is not None:
            getattr(rep, phase)[lvl] += t
    rep._x = x  # for equivalence tests
    return rep
