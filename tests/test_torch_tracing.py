"""The port's spans and counters (`amg_tpu_torch/utils/tracing.py`), on the
CPU, on the generic hierarchy of the 27-point Laplacian at 10^3:

  * with tracing on, x, the cycle count and the history of a solve are
    bit for bit those with tracing off: sync MULTADD with smoothed
    transfers, the MULT V-cycle under PCG, FULL async;
  * `spmv.*` per solve equals the count worked out from the hierarchy's
    level count: MULTADD (1 + 2 per cycle on the stencil, L(L-1) ELL
    applies a cycle on the smoothed chains) and the PCG V-cycle (1 + 5 +
    4(L-2) per iteration, the start's matvec and cycle once more);
  * `spmv.*` per cycle on the structured hierarchy (struct_solve, level 0
    fused or not) and on the DIA hierarchy (MULT and PCG);
  * in a CPU profiler trace of a traced solve every aten op falls inside
    `amg.solve`, and the phase spans nest inside `amg.cycle` (PCG: inside
    `amg.precond`, within `amg.iteration` but the start's; async: inside
    `amg.correction:k`);
  * with tracing off no span enters `record_function`;
  * every level has its set-up spans, whose sum does not exceed the build's
    wall time;
  * `profile_phases` runs the production MULT_MULTADD cycle and names its
    inner additive cycles' levels in the whole hierarchy.
"""

import time

import numpy as np
import pytest
import torch

from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, cycle_step
from amg_tpu_torch.solve.driver import solve
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.phases import profile_phases

torch.set_num_threads(1)

MULTADD = CycleConfig(cycle=CycleType.MULTADD, use_smoothed_transfers=True)
PHASES = ("smooth", "residual", "restrict", "prolong", "coarse")
CLASSICAL_PHASES = ("rho", "strength", "coarsen", "interp", "ideal", "transfers", "rap")


@pytest.fixture(scope="module")
def h10():
    prob = laplacian_3d_27pt(10)
    t0 = time.perf_counter()
    hh, hier = build_hierarchy(prob.A, HierarchyParams(max_coarse_size=20),
                               fine_stencil=prob.stencil, device="cpu")
    wall = time.perf_counter() - t0
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    return hh, hier, b, wall, tracing.last_setup()


def _run(kind, hier, b):
    """(x, iters, history) of one solve of `kind`."""
    if kind == "multadd":
        res = solve(hier, MULTADD, b, tol=1e-8, max_cycles=60, device="cpu")
    elif kind == "pcg":
        res = solve(hier, CycleConfig(), b, tol=1e-8, max_cycles=60, outer="pcg",
                    device="cpu")
    else:
        acfg = AsyncConfig(async_type="full", sim_read_delay=4)
        res = async_solve(hier, MULTADD, acfg, b, seed=5, tol=1e-6, max_cycles=400,
                          device="cpu")
    return res.x, int(res.iters), res.history


@pytest.mark.parametrize("kind", ["multadd", "pcg", "async_full"])
def test_tracing_moves_no_bit(h10, kind):
    _, hier, b, _, _ = h10
    x0, it0, h0 = _run(kind, hier, b)
    with tracing.on():
        x1, it1, h1 = _run(kind, hier, b)
    assert it0 == it1 > 0
    assert torch.equal(x0, x1)
    assert torch.equal(torch.nan_to_num(h0, nan=-1.0), torch.nan_to_num(h1, nan=-1.0))
    assert not tracing.enabled()


def _spmv_delta(before, after):
    """The `spmv.*` counters that moved between two readings, by how much."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if k.startswith("spmv.") and v != before.get(k, 0)}


def test_spmv_per_multadd_cycle(h10):
    _, hier, b, _, _ = h10
    L = hier.num_levels
    assert L >= 3
    before = tracing.counters()
    _, iters, _ = _run("multadd", hier, b)
    after = tracing.counters()
    got = _spmv_delta(before, after)
    # the start's residual; per cycle the cycle's residual and the stop
    # test's on the stencil, and k hops down and k back up for level k
    assert got == {"spmv.stencil": 1 + 2 * iters, "spmv.ell": iters * L * (L - 1)}
    assert after["host_read"] - before.get("host_read", 0) == iters


def test_spmv_per_pcg_iteration(h10):
    _, hier, b, _, _ = h10
    L = hier.num_levels
    before = tracing.counters()
    _, iters, _ = _run("pcg", hier, b)
    after = tracing.counters()
    got = _spmv_delta(before, after)
    # a V(1,1) cycle from zero: level 0's pre-sweep, residual and post-sweep
    # on the stencil, R_0 and P_0; levels 1..L-2 a residual, R, P and the
    # post-sweep (their zero-guess pre-sweep applies nothing); plus the
    # matvec: 1 + 5 + 4 (L - 2) a PCG iteration, the start's once more
    assert got == {"spmv.stencil": (iters + 1) * 4,
                   "spmv.ell": (iters + 1) * (2 + 4 * (L - 2))}
    assert sum(got.values()) == (iters + 1) * (1 + 5 + 4 * (L - 2))
    # the stop test reads once before each iteration and once to stop
    assert after["host_read"] - before.get("host_read", 0) == iters + 1


def test_spmv_per_structured_cycle(monkeypatch):
    """The structured path counts each product it computes, fused or not:
    K1/K2 and K3/K4 in `spmv.stencil_kernel` and `spmv.transfer`."""
    import amg_tpu_torch.solve.struct_cycle as tsc
    from amg_tpu_torch.setup.structured import build_structured_hierarchy

    prob = laplacian_3d_27pt(20)
    _, hier = build_structured_hierarchy(prob.stencil, coarse_op="const", max_coarse_size=200,
                                         device="cpu")
    b = torch.from_numpy(np.random.default_rng(2).random(prob.n))
    L = hier.num_levels
    assert L >= 3
    for fuse_min_side in (96, 16):  # level 0 unfused, then through K3/K4
        monkeypatch.setattr(tsc, "_FUSE_MIN_SIDE", fuse_min_side)
        before = tracing.counters()
        res = tsc.struct_solve(hier, CycleConfig(), b, tol=0.0, max_cycles=4, device="cpu")
        got = _spmv_delta(before, tracing.counters())
        C = int(res.iters)
        assert C == 4
        # the start's pre-sweep with its norm; per cycle level 0's residual,
        # post-sweep and the next pre-sweep with its norm, R and P; each
        # coarse level's zero-guess visit as K3 and K4, a product with A and
        # a transfer each
        assert got == {"spmv.stencil_kernel": 1 + C * (3 + 2 * (L - 2)),
                       "spmv.transfer": C * (2 + 2 * (L - 2))}, fuse_min_side


@pytest.mark.parametrize("outer", [None, "pcg"], ids=["mult", "pcg"])
def test_spmv_per_dia_cycle(outer):
    """The DIA hierarchy counts each K5 product, its smoother sweeps
    included: a zero-guess sweep launches K5 on u = 0."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.structured import build_dia_structured_hierarchy

    prob = elasticity_beam(nx=16, ny=7, nz=7, bc="identity")
    _, hier = build_dia_structured_hierarchy(prob.A, (17, 8, 8), num_functions=3,
                                             device="cpu")
    b = torch.from_numpy(np.random.default_rng(3).random(prob.A.shape[0]))
    L = hier.num_levels
    assert L >= 3
    before = tracing.counters()
    res = solve(hier, CycleConfig(), b, tol=0.0, max_cycles=3, outer=outer, device="cpu")
    got = _spmv_delta(before, tracing.counters())
    C = int(res.iters)
    assert C == 3
    # a V(1,1) cycle: each level above the coarsest a pre-sweep, a residual
    # and a post-sweep on K5, R and P; MULT: the stop test's residual a
    # cycle and the start's once; PCG: the matvec an iteration, the start's
    # matvec and cycle once more
    if outer is None:
        assert got == {"spmv.dia": 1 + C * (3 * (L - 1) + 1),
                       "spmv.transfer": C * 2 * (L - 1)}
    else:
        assert got == {"spmv.dia": (C + 1) * (3 * (L - 1) + 1),
                       "spmv.transfer": (C + 1) * 2 * (L - 1)}


def _profiled(kind, hier, b):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.on():
            _run(kind, hier, b)
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


def _inside(ev, outers):
    return any(s <= ev[1] and ev[2] <= e for _, s, e in outers)


@pytest.mark.parametrize("kind", ["multadd", "pcg", "async_full"])
def test_spans_hold_every_op_and_nest(h10, kind):
    _, hier, b, _, _ = h10
    evs = _profiled(kind, hier, b)
    solves = [e for e in evs if e[0] == "amg.solve"]
    assert len(solves) == 1
    ops = [e for e in evs if e[0].startswith("aten::")]
    assert ops and all(_inside(e, solves) for e in ops)
    phases = [e for e in evs if e[0].startswith("amg.")
              and e[0][4:].split(":")[0] in PHASES]
    assert phases
    # a driver cycle, a PCG preconditioner, an async level's correction
    outer = {"multadd": "amg.cycle", "pcg": "amg.precond",
             "async_full": "amg.correction:"}[kind]
    outers = [e for e in evs if e[0].startswith(outer)]
    assert outers and all(_inside(e, outers) for e in phases)
    names = {e[0] for e in evs}
    assert "amg.host_read" in names
    if kind == "pcg":
        assert {"amg.iteration", "amg.matvec"} <= names
        iterations = [e for e in evs if e[0] == "amg.iteration"]
        # all but the start's preconditioner run inside an iteration
        assert sum(not _inside(e, iterations) for e in outers) == 1
    L = hier.num_levels
    if kind == "multadd":
        # level k's chains belong to restrict:k / prolong:k
        assert {f"amg.restrict:{k}" for k in range(1, L)} <= names
        assert {f"amg.prolong:{k}" for k in range(1, L)} <= names


def test_no_record_function_with_tracing_off(h10, monkeypatch):
    _, hier, b, _, _ = h10

    def refuse(*a, **kw):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not tracing.enabled()
    assert tracing.span("cycle") is tracing.span("restrict", 3)  # the shared no-op
    for kind in ("multadd", "pcg", "async_full"):
        _run(kind, hier, b)
    with pytest.raises(AssertionError):
        with tracing.on():
            _run("multadd", hier, b)


def test_every_level_has_its_setup_spans(h10):
    hh, _, _, wall, setup = h10
    L = hh.num_levels
    for k in range(L - 1):
        for phase in CLASSICAL_PHASES:
            assert setup[f"amg.setup.{phase}:{k}"] > 0.0, (phase, k)
    assert setup[f"amg.setup.rho:{L - 1}"] > 0.0
    assert f"amg.setup.strength:{L - 1}" not in setup
    assert setup["amg.setup.device"] > 0.0
    assert sum(setup.values()) <= wall


def test_setup_spans_sa_and_cheby():
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.solve.driver import cheby_setup

    prob = elasticity_beam(8, 2, 2)
    hh, hier = build_hierarchy(prob.A, HierarchyParams(setup_type="sa", num_functions=3,
                                                       max_coarse_size=20),
                               near_nullspace=prob.near_nullspace, device="cpu")
    cheby_setup(hier, CycleConfig(), num_iters=5, device="cpu")
    setup = tracing.last_setup()
    assert hh.num_levels >= 2
    for phase in ("rho", "strength", "coarsen", "interp", "rap"):
        assert setup[f"amg.setup.{phase}:0"] > 0.0
    assert setup["amg.setup.device"] > 0.0 and setup["amg.setup.cheby"] > 0.0
    assert not any(".ideal" in k or ".transfers" in k for k in setup)


def test_profile_phases_runs_the_production_mult_multadd(h10):
    _, hier, b, _, _ = h10
    cfg = CycleConfig(cycle=CycleType.MULT_MULTADD, coarsest_mult_level=1)
    rep = profile_phases(hier, cfg, b, num_cycles=2)
    x = torch.zeros_like(b)
    for _ in range(2):
        x = cycle_step(hier, cfg, x, b)
    assert torch.equal(rep._x, x)
    L = hier.num_levels
    # the inner multadd cycles run on the levels below 1: their chains name
    # levels 2..L-1 of the whole hierarchy
    assert all(rep.restrict[k] > 0 and rep.prolong[k] > 0 for k in range(2, L))
    assert rep.smooth[0] > 0 and rep.coarse > 0


def test_recorder_totals_levels_and_reset():
    tracing.reset()
    with tracing.on():
        with tracing.span("cycle"):
            with tracing.levels_from(2):
                with tracing.span("smooth", 1):
                    assert tracing.open_spans() == ("amg.cycle", "amg.smooth:3")
        assert tracing.host_read(torch.tensor(2.5)) == 2.5
    assert tracing.open_spans() == ()
    tot = tracing.totals()
    assert set(tot) == {"amg.cycle", "amg.smooth:3", "amg.host_read"}
    assert all(c == 1 and t >= 0.0 for t, c in tot.values())
    assert tracing.counter("host_read") == 1
    tracing.count("spmv.ell", 3)
    tracing.reset(counters=False)
    assert tracing.totals() == {} and tracing.counter("spmv.ell") == 3
    tracing.reset()
    assert tracing.counters() == {}


def test_struct_solve_spans(monkeypatch):
    """The structured path: tracing moves no bit, and the fused kernels'
    phases (K3 in restrict:k, K4 in prolong:k) nest inside amg.cycle."""
    import amg_tpu_torch.solve.struct_cycle as tsc
    from amg_tpu_torch.setup.structured import build_structured_hierarchy

    monkeypatch.setattr(tsc, "_FUSE_MIN_SIDE", 16)
    prob = laplacian_3d_27pt(20)
    _, hier = build_structured_hierarchy(prob.stencil, coarse_op="const", max_coarse_size=200,
                                         device="cpu")
    b = torch.from_numpy(np.random.default_rng(2).random(prob.n))
    want = tsc.struct_solve(hier, CycleConfig(), b, tol=1e-6, max_cycles=30, device="cpu")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.on():
            got = tsc.struct_solve(hier, CycleConfig(), b, tol=1e-6, max_cycles=30,
                                   device="cpu")
    assert got.iters == want.iters > 0 and torch.equal(got.x, want.x)
    evs = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    names = {e[0] for e in evs}
    assert {"amg.solve", "amg.cycle", "amg.host_read", "amg.smooth:0", "amg.restrict:0",
            "amg.prolong:0", "amg.coarse"} <= names
    phases = [e for e in evs if e[0].startswith(("amg.restrict:", "amg.prolong:"))]
    cycles = [e for e in evs if e[0] == "amg.cycle"]
    assert phases and all(_inside(e, cycles) for e in phases)
