"""Grid (level) parallelism over a row mesh (counterpart of
amg_tpu/parallel/grid.py).

The reference splits its ranks into per-level groups sized by a work model;
each group owns its restricted operators, runs its level's additive
correction at its own rate against stale reads, and the groups exchange
corrections through ACCUMULATE messages, ending on a done-flag lattice that
rides the residual-norm reduction (reference: AssignProcs
src/DMEM_Setup.cpp:1638-1759; DMEM_Add src/DMEM_Add.cpp:20-178;
InnerProdFlag src/DMEM_Misc.cpp:414-433). Here the groups are ranges of the
logical shards of a `parallel.dist.RowMesh`:

  * the level -> shard plan comes from the work model
    (`parallel.partition`; `plan_grid_levels`), and each shard of a group
    computes its level, scaled by 1 / (the group's size): the reference's
    redundant compute inside a group;
  * each shard owns only the operator fields its corrections read
    (`build_grid_owned_storage`): its levels' A and smoother, the transfer
    chain down to its deepest level, the coarse inverse where it owns the
    coarsest level; the fine operator is replicated, as every group holds a
    fine copy in the reference. A shard's view raises on any other field;
  * the draws are replicated: every process takes the same draws, in the
    order of `solve.async_sim`'s stream (`DrawSource`), so the solve
    reproduces `async_sim.async_solve` to roundoff; only the owners read
    and correct;
  * a superstep sums the shards' partial corrections once, in shard order
    (one all-gather across processes, then the same sum), and one fused
    (norm partial, done flag) pair per shard ends it: the reference's
    ACCUMULATE psum and InnerProdFlag. The host reads the gathered pairs,
    the step's one host read.

In one process the D shards run one after the other on the device; across
processes (`init_multihost`: NCCL between cards, gloo on the CPU) each
process runs its own shards and the two collectives cross the process
group. The order of every sum is fixed, so 2 processes of 4 shards equal 1
of 8 bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from amg_tpu_torch.parallel.partition import assign_levels_to_devices, compute_level_work
from amg_tpu_torch.solve.async_sim import (
    AsyncConfig,
    AsyncResult,
    DrawSource,
    GeneratorDraws,
    _Accel,
    _check_accel,
    _Firing,
    _gather_stale,
    _stale_read_cols,
    _WaitCounter,
)
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, additive_correction
from amg_tpu_torch.solve.driver import nan_padded


def plan_grid_levels(
    hh, num_devices: int, imbalance: float = 0.0, smoothed_transfers: bool = False,
    assign_policy: str = "balanced", assign_scalar: float = 0.5,
):
    """The work model's level -> shard plan of a host hierarchy:
    (assignment, levels_of, scale), levels_of[d] the levels shard d
    computes and scale[k] = 1 / (the size of level k's group), so that a
    level shared by a group adds up to one correction."""
    work = compute_level_work(hh, imbalance=imbalance, smoothed_transfers=smoothed_transfers)
    assignment = assign_levels_to_devices(work, num_devices, policy=assign_policy,
                                          scalar=assign_scalar)
    levels_of = [[] for _ in range(num_devices)]
    scale = np.zeros(len(assignment))
    for k, (s, e) in enumerate(assignment):
        e = max(e, s + 1)
        scale[k] = 1.0 / (e - s)
        for d in range(s, min(e, num_devices)):
            levels_of[d].append(k)
    return assignment, tuple(tuple(ls) for ls in levels_of), scale


LEVEL_FIELDS = ("A", "sm", "P", "R", "P_s", "R_s", "P_id", "R_id")


def _keep_fields(my_levels, L, cfg: CycleConfig):
    """The (level, field) keys that the shard owning `my_levels` reads in
    its corrections: the transfer chain down to its deepest level (only the
    variants cfg walks), A and the smoother at its levels (AFACx: at k + 1
    too, and the level's own R/P hop), the coarse inverse where it owns the
    coarsest level. Level 0's A is not among them: the fine operator is
    replicated."""
    owned = set(my_levels)
    if not owned:
        return set()
    if cfg.cycle == CycleType.AFACX:
        owned |= {min(k + 1, L - 1) for k in my_levels}
    deepest = max(owned)
    if cfg.cycle == CycleType.AFACJ:
        fields = ("P", "R", "P_id", "R_id")
    elif cfg.use_smoothed_transfers:
        fields = ("P", "R", "P_s", "R_s")
    else:
        fields = ("P", "R")
    keep = {(j, f) for j in range(deepest) for f in fields}
    if cfg.cycle == CycleType.AFACX:
        for k in my_levels:
            keep.add((k, "P"))
            keep.add((k, "R"))
    for k in owned:
        keep.add((k, "A"))
        keep.add((k, "sm"))
    keep.discard((0, "A"))
    if (L - 1) in owned:
        keep.add(("coarse", "Ainv"))
    return keep


class FieldNotOwned(LookupError):
    """A shard's view was asked for an operator field it does not own."""


class OwnedFields:
    """The fields a shard owns of one level (or one group of operators),
    and the fields the source does not have (None); reading any other
    raises FieldNotOwned."""

    __slots__ = ("_what", "_fields")

    def __init__(self, what: str, fields: dict):
        self._what = what
        self._fields = fields

    def __getattr__(self, name):
        try:
            return self._fields[name]
        except KeyError:
            raise FieldNotOwned(f"this shard does not own {self._what}'s {name}") from None


class OwnedView:
    """A shard's hierarchy view, what `additive_correction` reads: one
    OwnedFields a level and, where it owns the coarsest level, the coarse
    inverse."""

    def __init__(self, levels, coarse_Ainv=None, owns_coarse=False):
        self.levels = tuple(levels)
        self._coarse = coarse_Ainv
        self._owns_coarse = owns_coarse

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def coarse_Ainv(self):
        if not self._owns_coarse:
            raise FieldNotOwned("this shard does not own the coarse inverse")
        return self._coarse


def _tensors(obj) -> list:
    """The tensors an operator or smoother state holds (the leaves the
    reference packs into a shard's pool)."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for v in obj for t in _tensors(v)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    return []


def field_bytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def on_device(obj, device, memo: dict):
    """obj with its tensors on `device`: obj itself where they are there
    already (no copy), else one moved copy per object (`memo`), which every
    shard of the process shares."""
    if obj is None or all(t.device == device for t in _tensors(obj)):
        return obj
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj.to(device)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        out = type(obj)(*(on_device(v, device, memo) for v in obj))
    elif isinstance(obj, tuple):
        out = tuple(on_device(v, device, memo) for v in obj)
    elif dataclasses.is_dataclass(obj):
        out = dataclasses.replace(obj, **{f.name: on_device(getattr(obj, f.name), device, memo)
                                          for f in dataclasses.fields(obj) if f.init})
    else:
        out = obj
    memo[id(obj)] = out
    return out


class GridStorage(NamedTuple):
    """The owned operator storage of a level plan: every shard's field keys
    (those with data) and packed bytes (`keep`, `owned_bytes`: all D
    shards), the views of
    this process's shards and the replicated fine operator, on the mesh's
    device."""

    keep: tuple
    owned_bytes: tuple
    views: dict
    A0: object


def _field(hier, key):
    if key == ("coarse", "Ainv"):
        return hier.coarse_Ainv
    return getattr(hier.levels[key[0]], key[1])


def build_grid_owned_storage(hier, levels_of, cfg: CycleConfig, mesh=None) -> GridStorage:
    """Per shard exactly the fields its corrections read (`_keep_fields`;
    with smoothed MULTADD / BPX chains the raw R / P only where a level has
    no smoothed transfer). owned_bytes[d] is shard d's field bytes, the
    reference's packed pool row. The views are those of the mesh's process
    (mesh=None: every shard, on the hierarchy's device); a field goes to the
    mesh's device only where a shard of this process owns it, and the
    process's shards share it."""
    L = hier.num_levels
    D = len(levels_of)
    if mesh is None:
        device, local = hier.device, range(D)
    else:
        if mesh.n_devices != D:
            raise ValueError(f"{D} level sets for a {mesh.n_devices}-shard mesh")
        device = mesh.device
        local = range(mesh.first_shard, mesh.first_shard + mesh.local_devices)
    smoothed_chain = cfg.use_smoothed_transfers and cfg.cycle in (CycleType.MULTADD,
                                                                  CycleType.BPX)
    keeps, owned = [], []
    for d in range(D):
        keep = _keep_fields(levels_of[d], L, cfg)
        if smoothed_chain:
            # the chain takes R_s / P_s wherever a level has them
            for lvl, f in list(keep):
                if f in ("R", "P") and getattr(hier.levels[lvl], f + "_s") is not None:
                    keep.discard((lvl, f))
        # a field the hierarchy does not have holds nothing to own
        keep = frozenset(key for key in keep if _field(hier, key) is not None)
        keeps.append(keep)
        owned.append(sum(field_bytes(_field(hier, key)) for key in keep))
    memo = {}
    A0 = on_device(hier.levels[0].A, device, memo)
    views = {}
    for d in local:
        levels = []
        for k, lv in enumerate(hier.levels):
            fields = {}
            for f in LEVEL_FIELDS:
                v = getattr(lv, f)
                if k == 0 and f == "A":
                    fields[f] = A0
                elif (k, f) in keeps[d]:
                    fields[f] = on_device(v, device, memo)
                elif v is None:
                    fields[f] = None
            levels.append(OwnedFields(f"level {k}", fields))
        owns = ("coarse", "Ainv") in keeps[d]
        views[d] = OwnedView(levels, on_device(hier.coarse_Ainv, device, memo) if owns else None,
                             owns)
    return GridStorage(keep=tuple(keeps), owned_bytes=tuple(owned), views=views, A0=A0)


def _shard_sum(mesh, parts: dict, rows, like: torch.Tensor) -> torch.Tensor:
    """The sum of the partials of shards `rows` (global shard ids, in
    order), from this process's partials {shard: tensor like `like`}:
    gathered across processes (a shard without a partial sends zeros), then
    added one after the other, so that any split of the shards over
    processes gives the same bits."""
    if mesh.world_size > 1:
        local = range(mesh.first_shard, mesh.first_shard + mesh.local_devices)
        stack = torch.stack([parts[d] if d in parts else torch.zeros_like(like) for d in local])
        parts = dict(enumerate(mesh.gather(stack.reshape(-1)).view(mesh.n_devices, -1)))
    total = None
    for d in rows:
        total = parts[d] if total is None else total + parts[d]
    return total


def _gathered(mesh, stats: torch.Tensor) -> np.ndarray:
    """(D, m) host array of this process's (local_devices, m) stats: the
    step's one host read."""
    if mesh.world_size > 1:
        stats = mesh.gather(stats.reshape(-1)).view(mesh.n_devices, -1)
    return stats.detach().to("cpu", torch.float64).numpy()


def _shard_norm_partials(r: torch.Tensor, D: int) -> torch.Tensor:
    """(D,) row-range partials of ||r||^2, r zero-padded to a multiple of D."""
    r2 = r * r
    n_pad = -(-r.shape[0] // D) * D
    if n_pad > r.shape[0]:
        r2 = torch.nn.functional.pad(r2, (0, n_pad - r.shape[0]))
    return r2.view(D, -1).sum(1)


def _seq_sum(values) -> float:
    s = 0.0
    for v in values:
        s += float(v)
    return s


def grid_parallel_solve(
    hier,
    cfg: CycleConfig,
    acfg: AsyncConfig,
    levels_of: Sequence[Sequence[int]],
    level_scale,
    mesh,
    b,
    x0: Optional[torch.Tensor] = None,
    draws: Optional[DrawSource] = None,
    seed: int = 0,
    tol: float = 1e-8,
    max_cycles: int = 500,
) -> AsyncResult:
    """The asynchronous additive solve with level parallelism over `mesh`
    (a RowMesh of len(levels_of) shards; its device runs the solve): the
    semantics of `async_sim.async_solve` under the same draws, but shard d
    computes only levels_of[d]'s corrections, scaled by level_scale, from
    its owned view (`build_grid_owned_storage`).
    draws=None takes GeneratorDraws(seed); b and x0 are global vectors.

    Beyond async_solve: comm_every > 1 keeps a pending buffer per shard,
    seen in that shard's own reads, summed every comm_every-th step and
    drained at the end; converge_test_type "local" freezes a shard once its
    own residual view meets tol and ends when every shard has frozen."""
    D = len(levels_of)
    if mesh.n_devices != D:
        raise ValueError(f"{D} level sets for a {mesh.n_devices}-shard mesh")
    E = max(int(acfg.comm_every), 1)
    sol = acfg.read_type == "sol"
    update = acfg.res_mode == "update"
    full = acfg.async_type == "full"
    local_conv = acfg.converge_test_type == "local"
    accel_on = _check_accel(acfg)
    if E > 1 and not (sol and not update):
        raise ValueError("message coalescing (comm_every > 1) supports read_type 'sol' "
                         "with res_mode 'recompute'")
    if local_conv and update:
        raise ValueError("local convergence needs each shard's own residual view "
                         "(res_mode 'recompute')")
    if accel_on and (E != 1 or local_conv):
        raise ValueError("async accel needs comm_every 1 and global convergence")
    device = mesh.device
    storage = build_grid_owned_storage(hier, levels_of, cfg, mesh)
    views, A0 = storage.views, storage.A0
    local = list(range(mesh.first_shard, mesh.first_shard + mesh.local_devices))
    dtype = hier.dtype
    b = torch.as_tensor(b).to(device=device, dtype=dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorDraws(seed, device)
    n = b.shape[0]
    L = hier.num_levels
    W = acfg.sim_read_delay + 1
    scale = np.asarray(level_scale, np.float64)
    needed = {lvl for d in local for lvl in levels_of[d]}

    def norm_stats(rs, flags):
        """The fused pair of each local shard, gathered: (normsq, flags).
        rs[i] is local shard i's residual view (one tensor where they
        share it)."""
        memo = {}
        part = []
        for r, d in zip(rs, local):
            if id(r) not in memo:
                memo[id(r)] = _shard_norm_partials(r, D)
            part.append(memo[id(r)][d])
        g = _gathered(mesh, torch.stack([torch.stack(part), flags.to(dtype)], 1))
        return _seq_sum(g[:, 0]), g[:, 1]

    r0 = b - A0 @ x0
    r0sq, _ = norm_stats([r0] * len(local), torch.zeros(len(local), device=device))
    r0norm = float(np.sqrt(r0sq))
    safe_r0 = 1.0 if r0norm == 0.0 else r0norm
    ring = (x0 if sol else r0).unsqueeze(0).repeat(W, 1)
    last_read = {lvl: torch.zeros(n, dtype=torch.int32, device=device) for lvl in needed} \
        if full else [0] * L
    # each local shard's pending corrections (comm_every > 1)
    c_pend = {d: torch.zeros_like(b) for d in local} if E > 1 else None
    waits = _WaitCounter(L)
    accel = _Accel(acfg.accel, L, acfg.cheby_mu, acfg.cheby_delta, acfg.cheby_grid, b) \
        if accel_on else None
    firing = _Firing(acfg, L, draws)
    frozen = np.zeros(D, bool)  # local convergence: the shards' done flags

    x, r_state = x0, r0
    rel, nflags = float("inf"), 0.0
    hist = [1.0]
    k = 0
    while k < max_cycles and (local_conv or rel > tol) and nflags < D:
        u, perm = draws.step(L)
        fire = firing.mask(u, k)
        lvl_scale = accel.scales() if accel_on else np.ones(L)

        # replicated reads, taken in level order by every process; only the
        # owners gather theirs
        stale = {}
        for lvl in np.flatnonzero(fire):
            lvl = int(lvl)
            if full:
                u_rows = draws.read_rows(lvl, n, dtype, device)
                if lvl in needed:
                    cols = _stale_read_cols(acfg, last_read[lvl], k, u_rows)
                    last_read[lvl] = cols
                    stale[lvl] = _gather_stale(acfg, ring, cols)
            else:
                cols = _stale_read_cols(acfg, last_read[lvl], k, draws.read_scalar(lvl))
                last_read[lvl] = cols
                stale[lvl] = _gather_stale(acfg, ring, cols)

        # owner-only corrections of the shards that have not frozen
        working = [d for d in range(D) if not frozen[d]
                   and any(fire[lvl] for lvl in levels_of[d])]
        c_part = {}
        for d in local:
            if d not in working:
                continue
            c = None
            for lvl in levels_of[d]:
                if not fire[lvl]:
                    continue
                if sol:
                    s = stale[lvl] + acfg.omega * c_pend[d] if E > 1 else stale[lvl]
                    r_stale = b - A0 @ s
                else:
                    r_stale = stale[lvl]
                cl = float(lvl_scale[lvl] * scale[lvl]) * additive_correction(
                    views[d], cfg, r_stale, lvl)
                c = cl if c is None else c + cl
            c_part[d] = c
        total_c = None
        if E > 1:
            for d, c in c_part.items():
                c_pend[d] = c_pend[d] + c
            if (k + 1) % E == 0:  # publish
                total_c = acfg.omega * _shard_sum(mesh, c_pend, range(D), b)
                c_pend = {d: torch.zeros_like(b) for d in local}
        elif working:
            total_c = _shard_sum(mesh, c_part, working, b)
            if not accel_on:
                total_c = acfg.omega * total_c
        if accel_on:
            total_c = accel.finish(total_c, fire)
        if total_c is not None:
            x = x + total_c
        waits.record(perm, fire)

        # the fused (norm partial, done flag) reduction
        if update:
            if total_c is not None:
                r_state = r_state - A0 @ total_c
            rs = [r_state] * len(local)
            snap = x if sol else r_state
        elif E > 1:  # each shard's own view: x and its pending corrections
            rs = [b - A0 @ (x + acfg.omega * c_pend[d]) for d in local]
            snap = x
        else:
            rs = [b - A0 @ x] * len(local)
            snap = x if sol else rs[0]
        if local_conv:
            flags = torch.stack([
                torch.ones((), device=device) if frozen[d] else
                (torch.sqrt(torch.sum(r * r)) / safe_r0 <= tol).float()
                for r, d in zip(rs, local)])
        else:
            flags = torch.full((len(local),), float(rel <= tol), device=device)
        normsq, flag_all = norm_stats(rs, flags)
        if local_conv:
            frozen = flag_all > 0.5
        nflags = _seq_sum(flag_all)
        rel = float(np.sqrt(normsq)) / safe_r0
        ring[(k + 1) % W].copy_(snap)
        k += 1
        hist.append(rel)
    if E > 1:
        # the unpublished corrections enter the answer (the reference's drain)
        x = x + acfg.omega * _shard_sum(mesh, c_pend, range(D), b)
    return AsyncResult(x=x, iters=k, rel_resnorm=torch.tensor(rel, dtype=dtype, device=device),
                       history=nan_padded(hist, max_cycles + 1, dtype, device),
                       grid_wait=waits.stats)


def device_branch_fn(hier, cfg: CycleConfig, acfg: AsyncConfig, my_levels, b):
    """One shard's correction work a superstep, as a function of the ring
    and every level's read columns: the stale reads, their fine residuals
    and the levels' additive corrections, unscaled (the work the model of
    `compute_level_work` prices)."""
    A0 = hier.levels[0].A

    def fn(ring, cols_all):
        c = torch.zeros_like(b)
        for lvl in my_levels:
            stale = _gather_stale(acfg, ring, cols_all[lvl])
            r_stale = b - A0 @ stale if acfg.read_type == "sol" else stale
            c = c + additive_correction(hier, cfg, r_stale, lvl)
        return c

    return fn
