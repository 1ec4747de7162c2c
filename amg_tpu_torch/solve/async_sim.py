"""Asynchronous additive AMG as a bounded-staleness state machine
(counterpart of amg_tpu/solve/async_sim.py).

Per global step k, each level ("grid group") independently
  - fires with some probability, or when its wait counter runs out;
  - reads a stale snapshot of the solution (read_type "sol") or of the
    residual ("res"), at most sim_read_delay steps old and never older than
    its last read: per row in FULL mode, per level in SEMI mode;
  - computes its additive correction (`cycles.additive_correction`) from
    that read;
and the firing corrections are added to x (under the asymmetric Chebyshev
or Richardson recurrences, or coalesced into per-level pending buffers).
Grid-wait statistics count how many global corrections landed between a
level's consecutive applies.

The reference runs this as one jitted while loop with jax.random draws.
Here it is a host loop that reads one device scalar a step (the relative
residual), with every random number from an injectable draw source
(`DrawSource`): the production source (`GeneratorDraws`) holds two explicit
torch.Generators, and a source that replays the reference's own draws makes
the port follow the reference's history step for step. The firing mask,
the permutation, SEMI mode's reads and the recurrences' scalars all live on
the host, so the host knows which levels fire without a device read; a
level that does not fire computes nothing (the reference computes every
correction and masks it: the sum is the same).

With tracing on (`utils/tracing.py`) a solve runs inside `amg.solve`, a
firing level's correction inside `amg.correction:k` (with the cycle's phase
spans), and the step's residual read inside `amg.host_read`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from amg_tpu_torch.solve.accel import _reducers
from amg_tpu_torch.solve.cycles import CycleConfig, additive_correction
from amg_tpu_torch.solve.driver import _check_device, nan_padded
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import traced


@dataclass(frozen=True)
class AsyncConfig:
    """The async execution knobs, the reference's, with its defaults
    (converge_test_type is read only by the grid-parallel solver,
    `parallel.grid.grid_parallel_solve`)."""

    read_type: str = "sol"  # "sol": r from the stale x | "res": the stale r
    # "recompute": the true residual each step | "update": r -= A (applied
    # correction), which drifts from the true residual as in the reference
    res_mode: str = "recompute"
    async_type: str = "full"  # "full": per-row staleness | "semi": per-level
    sim_read_delay: int = 4  # staleness window in global steps
    fire_prob: float = 0.5  # per-level firing probability of a step
    # > 0: a level fires when its countdown reaches 0, then redraws it
    # uniformly from [0, sim_grid_wait] (delay_levels are then ignored)
    sim_grid_wait: int = 0
    omega: float = 1.0  # scalar weight of every applied correction
    # "cheby" | "richardson": each level advances its own three-term
    # recurrence at its own firing rate (its correction scaled by
    # omega_k * delta, raw on its first fire), and the cheby_grid level also
    # carries the direction d, the total update since its last fire
    accel: str = "none"
    cheby_grid: int = 0
    cheby_mu: float = 0.0
    cheby_delta: float = 0.0
    # > 1: corrections collect in per-level pending buffers, which a level
    # sees in its own reads at once, and are published every comm_every steps
    comm_every: int = 1
    delay_levels: Tuple[int, ...] = ()  # these levels fire with delay_prob
    delay_prob: float = 0.5
    # fail_level does not fire in [fail_start, fail_start + fail_duration)
    fail_level: int = -1
    fail_start: int = 0
    fail_duration: int = 0
    # "global": stop when the summed residual meets tol | "local": each grid
    # group stops correcting once its own residual view does, and the solve
    # ends when every group has stopped
    converge_test_type: str = "global"


class GridWaitStats(NamedTuple):
    """Per-level staleness accounting, (L,) host arrays."""

    total: np.ndarray  # sum of waits
    count: np.ndarray  # number of corrections
    min: np.ndarray
    max: np.ndarray

    def summary(self):
        cnt = np.maximum(self.count, 1)
        return {
            "mean": (self.total / cnt).tolist(),
            "min": self.min.tolist(),
            "max": self.max.tolist(),
            "num_correct": self.count.tolist(),
        }


class AsyncResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_resnorm: torch.Tensor
    history: torch.Tensor  # relative residual per step, NaN-padded
    grid_wait: GridWaitStats

    def history_list(self):
        h = self.history.detach().cpu().numpy()
        return h[~np.isnan(h)].tolist()


class DrawSource(Protocol):
    """The raw random numbers of one async solve, in the reference's shapes;
    the loop makes every comparison and rounding itself. Per step the loop
    calls `step` once, then `read_scalar` (SEMI) or `read_rows` (FULL) for
    each level that fires, in level order; `wait_uniforms` once before the
    first step, in wait-counter mode only."""

    def wait_uniforms(self, L: int) -> np.ndarray:
        """(L,) uniforms in [0, 1): the initial wait counters' draws."""

    def step(self, L: int) -> Tuple[np.ndarray, np.ndarray]:
        """(L,) uniforms (the firing draws, or the wait redraws) and a
        permutation of range(L) (the apply order)."""

    def read_scalar(self, lvl: int) -> float:
        """SEMI mode: level lvl's read uniform for this step."""

    def read_rows(self, lvl: int, n: int, dtype, device) -> torch.Tensor:
        """FULL mode: level lvl's (n,) per-row read uniforms on `device`."""


class GeneratorDraws:
    """The production draw source: two torch.Generators seeded from `seed`.
    A CPU one draws each step's small values, so the host knows who fires
    without a device read; one on `device` draws FULL mode's per-row
    uniforms."""

    def __init__(self, seed: int = 0, device="cpu"):
        self._host = torch.Generator().manual_seed(seed)
        self._rows = torch.Generator(device=torch.device(device)).manual_seed(seed)

    def _uniforms(self, m):
        return torch.rand(m, generator=self._host, dtype=torch.float64).numpy()

    def wait_uniforms(self, L):
        return self._uniforms(L)

    def step(self, L):
        return self._uniforms(L), torch.randperm(L, generator=self._host).numpy()

    def read_scalar(self, lvl):
        return float(self._uniforms(1)[0])

    def read_rows(self, lvl, n, dtype, device):
        return torch.rand(n, generator=self._rows, dtype=dtype, device=device)


@traced("solve")
def async_solve(
    hier,
    cfg: CycleConfig,
    acfg: AsyncConfig,
    b,
    x0: Optional[torch.Tensor] = None,
    draws: Optional[DrawSource] = None,
    seed: int = 0,
    tol: float = 1e-8,
    max_cycles: int = 500,
    device=None,
) -> AsyncResult:
    """Solve A x = b with the asynchronous additive model on `device` (None:
    the CUDA device; raises without one; the hierarchy must live there).
    draws=None takes GeneratorDraws(seed). On a row-sharded hierarchy b and
    x0 are this process's rows (of the padded vector)."""
    device = _check_device(hier, device)
    b = torch.as_tensor(b).to(device=device, dtype=hier.dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorDraws(seed, device)
    return _async_loop(hier, cfg, acfg, b, x0, draws, tol, max_cycles)


class _Firing:
    """Who fires each step: each level's firing uniform against its
    probability (delay_levels: delay_prob), or in wait-counter mode
    (sim_grid_wait > 0) its countdown, drawn here and redrawn from the
    step's uniform on each fire; fail_level is then held off in its
    window."""

    def __init__(self, acfg: AsyncConfig, L: int, draws: DrawSource):
        self.acfg = acfg
        self.probs = np.full(L, acfg.fire_prob)
        for lvl in acfg.delay_levels:
            self.probs[lvl] = acfg.delay_prob
        self.waits = None
        if acfg.sim_grid_wait > 0:
            self.waits = np.round(draws.wait_uniforms(L) * acfg.sim_grid_wait).astype(np.int64)

    def mask(self, u: np.ndarray, k: int) -> np.ndarray:
        a = self.acfg
        if self.waits is not None:
            fire = self.waits <= 0
            redraw = np.round(u * a.sim_grid_wait).astype(np.int64)
            self.waits = np.where(fire, redraw, self.waits - 1)
        else:
            fire = u < self.probs
        if 0 <= a.fail_level < fire.shape[0] and \
                a.fail_start <= k < a.fail_start + a.fail_duration:
            fire[a.fail_level] = False
        return fire


class _WaitCounter:
    """Grid-wait accounting in apply order: a firing level's wait is the
    number of global corrections that landed since its last apply."""

    def __init__(self, L: int):
        self.stats = GridWaitStats(total=np.zeros(L), count=np.zeros(L, np.int64),
                                   min=np.full(L, np.inf), max=np.full(L, -np.inf))
        self._marks = np.zeros(L, np.int64)
        self._count = 0

    def record(self, perm, fire):
        gw = self.stats
        for p in perm:
            if fire[p]:
                wait = self._count - self._marks[p]
                gw.total[p] += wait
                gw.count[p] += 1
                gw.min[p] = min(gw.min[p], wait)
                gw.max[p] = max(gw.max[p], wait)
                self._marks[p] = self._count
                self._count += 1


class _Accel:
    """The asymmetric Chebyshev ("cheby") or Richardson ("richardson")
    recurrences, host scalars in float64: each level advances its own
    three-term recurrence at its own firing rate (its correction scaled by
    omega_k * delta, raw on its first fire), restarted every `restart`
    fires (0: never), and level cg carries the direction d, the total update
    since its last fire."""

    def __init__(self, kind: str, L: int, mu: float, delta: float, cg: int,
                 like: torch.Tensor, restart: int = 0):
        self.mu, self.delta, self.restart = mu, delta, restart
        self.cg = min(max(cg, 0), L - 1)
        self.om_rich = 2.0 / (1.0 + (1.0 - 1.0 / (mu ** 2)) ** 0.5) if kind == "richardson" \
            else None
        self.c, self.cp = np.full(L, mu), np.ones(L)  # T_1 = mu, T_0 = 1
        self.cyc = np.zeros(L, np.int64)  # per-level fires since the (re)start
        self.d_dir = torch.zeros_like(like)

    def scales(self) -> np.ndarray:
        """This step's factor of each level's correction."""
        self._c_next = 2.0 * self.mu * self.c - self.cp
        self._om = np.full(self.c.shape[0], self.om_rich) if self.om_rich is not None \
            else 2.0 * self.mu * self.c / self._c_next
        self._first = self.cyc == 0
        return np.where(self._first, 1.0, self._om * self.delta)

    def finish(self, total_c: Optional[torch.Tensor], fire: np.ndarray):
        """The step's update from its summed scaled corrections (None: none
        landed): level cg's momentum added where it fires, d updated, the
        recurrences advanced."""
        cg = self.cg
        if fire[cg] and not self._first[cg]:
            total_c = total_c + (self._om[cg] - 1.0) * self.d_dir
        if total_c is not None:
            self.d_dir = total_c if fire[cg] else self.d_dir + total_c
        adv = fire & ~self._first
        self.cp = np.where(adv, self.c, self.cp)
        self.c = np.where(adv, self._c_next, self.c)
        self.cyc = self.cyc + fire
        if self.restart > 0:
            wrap = self.cyc >= self.restart
            self.cyc = np.where(wrap, 0, self.cyc)
            self.c = np.where(wrap, self.mu, self.c)
            self.cp = np.where(wrap, 1.0, self.cp)
        return total_c


def _check_accel(acfg: AsyncConfig) -> bool:
    accel_on = acfg.accel in ("cheby", "richardson")
    if accel_on and not (acfg.cheby_mu > 1.0 and acfg.cheby_delta > 0.0):
        raise ValueError("async accel needs cheby_mu/cheby_delta from cheby_setup's bounds")
    return accel_on


def _stale_read_cols(acfg: AsyncConfig, last_read, k: int, u):
    """The stale-read columns of one level from its read uniform(s) `u`:
    per row in FULL mode (last_read and u tensors), one scalar in SEMI
    mode, in [max(k - delay, 0, last read), k]."""
    if acfg.async_type == "full":
        low = torch.clamp(last_read, min=max(k - acfg.sim_read_delay, 0))
        return torch.round(low + u * (k - low)).to(torch.int32)
    low = max(k - acfg.sim_read_delay, 0, last_read)
    return int(np.round(low + u * (k - low)))


def _gather_stale(acfg: AsyncConfig, ring, cols):
    W = acfg.sim_read_delay + 1
    if acfg.async_type == "full":
        return ring.gather(0, (cols.long() % W).unsqueeze(0)).squeeze(0)
    return ring[cols % W]


def _async_loop(hier, cfg, acfg, b, x0, draws, tol, max_cycles):
    A0 = hier.levels[0].A
    n = b.shape[0]
    # a row-sharded hierarchy: b and x are this process's rows, the norms
    # reduce over the mesh, and a level's per-row read uniforms (drawn for
    # the whole vector, equal in every process) take this process's rows
    mesh = hier.mesh
    norm = _reducers(mesh)[1]
    n_all, rows = n, slice(None)
    if mesh is not None and mesh.world_size > 1:
        n_all = n * mesh.world_size
        rows = mesh.local_rows(n_all)
    L = hier.num_levels
    W = acfg.sim_read_delay + 1  # ring depth
    full = acfg.async_type == "full"
    sol = acfg.read_type == "sol"
    update = acfg.res_mode == "update"
    E = max(int(acfg.comm_every), 1)
    accel_on = _check_accel(acfg)
    if accel_on and E != 1:
        raise ValueError("async accel does not compose with comm coalescing (comm_every > 1)")

    r0 = b - A0 @ x0
    r0norm = norm(r0)
    safe_r0 = torch.where(r0norm == 0.0, torch.ones_like(r0norm), r0norm)
    ring = (x0 if sol else r0).unsqueeze(0).repeat(W, 1)
    last_read = (torch.zeros((L, n), dtype=torch.int32, device=b.device) if full
                 else [0] * L)
    pending = torch.zeros((L, n), dtype=b.dtype, device=b.device) if E > 1 else None
    waits = _WaitCounter(L)
    accel = _Accel(acfg.accel, L, acfg.cheby_mu, acfg.cheby_delta, acfg.cheby_grid, b) \
        if accel_on else None
    firing = _Firing(acfg, L, draws)

    x, r_state = x0, r0
    relnorm = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
    hist = [1.0]
    k, rel = 0, float("inf")
    while k < max_cycles and rel > tol:
        u, perm = draws.step(L)
        fire = firing.mask(u, k)
        if accel_on:
            lvl_scale = accel.scales()

        total_c = None
        for lvl in np.flatnonzero(fire):
            lvl = int(lvl)
            u_read = (draws.read_rows(lvl, n_all, b.dtype, b.device)[rows] if full
                      else draws.read_scalar(lvl))
            col = _stale_read_cols(acfg, last_read[lvl], k, u_read)
            last_read[lvl] = col
            stale = _gather_stale(acfg, ring, col)
            if sol:
                r_stale = b - A0 @ (stale + pending[lvl] if E > 1 else stale)
            else:
                r_stale = stale - A0 @ pending[lvl] if E > 1 else stale
            c = additive_correction(hier, cfg, r_stale, lvl)
            if accel_on:
                c = c * float(lvl_scale[lvl])
            if E > 1:
                pending[lvl] += acfg.omega * c
            else:
                total_c = c if total_c is None else total_c + c

        if accel_on:
            total_c = accel.finish(total_c, fire)
            if total_c is not None:
                x = x + total_c
        elif E > 1:
            if (k + 1) % E == 0:  # publish
                total_c = pending.sum(dim=0)
                x = x + total_c
                pending.zero_()
        elif total_c is not None:
            total_c = acfg.omega * total_c
            x = x + total_c
        waits.record(perm, fire)

        if update:
            if total_c is not None:
                r_state = r_state - A0 @ total_c
            relnorm = norm(r_state) / safe_r0
            snap = x if sol else r_state
        else:
            r_true = b - A0 @ x
            relnorm = norm(r_true) / safe_r0
            snap = x if sol else r_true
        ring[(k + 1) % W].copy_(snap)
        k += 1
        rel = tracing.host_read(relnorm)  # the step's one host read
        hist.append(rel)
    return AsyncResult(x=x, iters=k, rel_resnorm=relnorm,
                       history=nan_padded(hist, max_cycles + 1, b.dtype, b.device),
                       grid_wait=waits.stats)
