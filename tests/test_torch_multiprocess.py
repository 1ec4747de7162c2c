"""The port's row-partitioned path across processes: 2 gloo processes x 4
shards against 1 process x 8 shards (tests/torch_mp_worker.py in both).

The worker runs golden config7's halo V-cycles through the port's runner,
each exchange mode of the halo operators and the halo stencil, and the
sharded AMS-PCG; the exchange and the coarse solve move values without
arithmetic, so the 2-process V-cycle run equals the 1-process one to 1e-14
(its norms are all-reduced in another order), and the PCG, whose dots are
all-reduced too, to 1e-10. The grid-parallel async solves gather the
shards' partials and sum them in shard order in every process, so 2
processes x 4 shards equal 1 x 8 bit for bit. Every other route (the
worker's `route_cases`, one test each) runs in both rounds, and the
one-process round also runs its options on one device: 1 x 8 is held
against that single-device iteration (what GSPMD computes), 2 x 4 against
1 x 8, with the same count and x to 1e-14 where only the all-reduced norms
differ and 1e-10 where a Krylov method's dots do; those bands stand,
though the mesh's dots and norms now sum the shards' dots in shard order
in any process count and the block smoothers apply the whole level's
blocks in each process, which makes every route but LOBPCG's all-reduced
Gram products bit-equal on the CPU. The structured hierarchy is held to
that: each plane-split level computes its rows as the global operator
does, and its routes' x is exact across processes. Spawns real processes
(one round of each, shared by the tests): the collectives cross process
memory."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn_round(nproc: int):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, WORKER, str(pid), str(nproc), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              text=True)
             for pid in range(nproc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append(out)
    return procs, outs


def _results(nproc: int):
    procs, outs = _spawn_round(nproc)
    if any(p.returncode != 0 for p in procs):
        # one retry: the process group's rendezvous can time out on a loaded
        # host
        procs, outs = _spawn_round(nproc)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"
    results = []
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert lines, f"no RESULT line:\n{out[-2000:]}"
        results.append(json.loads(lines[0][len("RESULT "):]))
    return sorted(results, key=lambda r: r["pid"])


@pytest.fixture(scope="module")
def rounds():
    (one,) = _results(1)
    return one, _results(2)


def test_two_processes_equal_one(rounds):
    one, two = rounds
    with open(os.path.join(REPO, "tests", "golden", "config7_halo_dist_mult.json")) as f:
        g = json.load(f)
    assert one["cycles"] == g["cycles"] and one["level_n"] == g["level_n"]
    for r in two:
        assert r["cycles"] == one["cycles"] and r["level_n"] == one["level_n"]
        np.testing.assert_allclose(r["history"], one["history"], rtol=1e-14, atol=0)
        np.testing.assert_allclose(r["x"], one["x"], rtol=0,
                                   atol=1e-14 * np.abs(one["x"]).max())
        for mode, y in one["y"].items():
            np.testing.assert_allclose(r["y"][mode], y, rtol=0,
                                       atol=1e-14 * np.abs(y).max(), err_msg=mode)
        assert r["ams_iters"] == one["ams_iters"]
        np.testing.assert_allclose(r["ams_x"], one["ams_x"], rtol=0,
                                   atol=1e-10 * np.abs(one["ams_x"]).max())


def test_the_grid_solve_on_two_processes_equals_one(rounds):
    one, two = rounds
    assert one["grid"]["views"] == list(range(8))
    assert [r["grid"]["views"] for r in two] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for name in ("semi", "full coalesced local"):
        want = one["grid"][name]
        assert want["history"][-1] <= 2e-8
        for r in two:
            assert r["grid"][name] == want, name


def _close(got, want, band, what):
    assert got["cycles"] == want["cycles"], what
    np.testing.assert_allclose(got["x"], want["x"], rtol=0,
                               atol=band * np.abs(want["x"]).max(), err_msg=what)


def _route(rounds, name, band, single_band=None, history_band=None):
    """The route's 1 x 8 run against its single-device run (single_band,
    None: not compared) and each process's 2 x 4 run against 1 x 8: the
    count, x within `band`, the history within history_band (default
    band)."""
    one, two = rounds
    r1 = one["routes"][name]
    if single_band is not None:
        _close(r1, r1["single"], single_band, name + " 1 x 8 against one device")
    hb = max(band if history_band is None else history_band, 1e-14)
    for r in two:
        _close(r["routes"][name], r1, band, name + " 2 x 4 against 1 x 8")
        # the relative residuals: the residual's roundoff over ||r0|| where
        # they fall below 1, relative where they grow
        np.testing.assert_allclose(r["routes"][name]["history"], r1["history"], rtol=hb,
                                   atol=hb, err_msg=name)
    return r1


def test_gspmd_across_processes(rounds):
    """(a) config7's options with comm "gspmd": the golden's cycles and
    history (the reference's halo run computes the same iteration), one
    device's x, and 2 x 4 equal to 1 x 8 (the operand all-gathered)."""
    r1 = _route(rounds, "gspmd", 1e-14, single_band=1e-12)
    with open(os.path.join(REPO, "tests", "golden", "config7_halo_dist_mult.json")) as f:
        g = json.load(f)
    assert r1["cycles"] == g["cycles"]
    np.testing.assert_allclose(r1["history"], g["history"], rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("kind", ["full", "semi"])
def test_async_additive_on_the_row_mesh_across_processes(rounds, kind):
    """(b) async_multadd -no_grid_parallel on the row mesh: the same steps
    as one device under the same generators (FULL's per-row draws taken for
    the whole vector, each process its rows)."""
    r1 = _route(rounds, f"async {kind}", 1e-14, single_band=1e-12)
    assert r1["history"][-1] <= 1e-8


def test_mixed_precision_on_the_row_mesh_across_processes(rounds):
    """(c) -mixed_precision on the row mesh (mixed_solve's norms reduced
    over the mesh)."""
    _route(rounds, "mixed", 1e-14, single_band=1e-12)


@pytest.mark.parametrize("method,band", [("power", 1e-14), ("lobpcg", 1e-10),
                                         ("lanczos", 1e-10)])
def test_chebyshev_bounds_across_processes(rounds, method, band):
    """(d) the Chebyshev solver after cheby_setup by each estimator: each
    process's rows of the one global start draw, the dots reduced over the
    mesh (LOBPCG's Gram products all-reduced, its QR on the gathered
    block): the single-device bounds and count."""
    one, two = rounds
    r1 = _route(rounds, f"cheby {method}", band, single_band=1e-12)
    np.testing.assert_allclose(r1["bounds"], r1["single"]["bounds"], rtol=1e-12)
    for r in two:
        np.testing.assert_allclose(r["routes"][f"cheby {method}"]["bounds"], r1["bounds"],
                                   rtol=1e-12)


@pytest.mark.parametrize("name", ["async_smooth stencil", "async_smooth csr"])
def test_async_smoothing_across_processes(rounds, name):
    """(e) one-level async smoothing over 8 shards (the plane exchange of
    the 7-point 16^3 stencil, a HaloELL of vardifconv 8^3): the blocks of
    the global rows, their residual norms all-reduced."""
    _route(rounds, name, 1e-14, single_band=1e-12)


def test_the_grid_mapped_extended_system_across_processes(rounds):
    """(f) the reference worker's grid-mapped extended system (5-point
    16^2): 2 x 4 equal to 1 x 8 (U row-sharded, the chains reading the whole
    fine vector); 1 x 8 against the unsharded explicit system, whose
    power-bound start vectors are shorter: the count within one and x
    within the solution's accuracy."""
    one, _ = rounds
    r1 = _route(rounds, "extended", 1e-14)
    s = r1["single"]
    assert abs(r1["cycles"] - s["cycles"]) <= 1
    assert r1["history"][-1] <= 1e-8 and s["history"][-1] <= 1e-8
    np.testing.assert_allclose(r1["x"], s["x"], rtol=0, atol=1e-6 * np.abs(s["x"]).max())


@pytest.mark.parametrize("smoother", ["hybrid_jgs", "gs"])
def test_block_smoothers_across_processes(rounds, smoother):
    """(g) config4's beam (PCG) with the block smoothers: the blocks cut
    from the global rows, the one at the process boundary applied whole in
    both processes."""
    _route(rounds, f"block {smoother}", 1e-10, single_band=1e-9)


def _history_move(got, want) -> float:
    """max |got - want| / (1 + |want|) over the common iterations: the
    measure of assert_allclose(rtol=atol=band)."""
    k = min(len(got), len(want))
    got, want = np.asarray(got[:k]), np.asarray(want[:k])
    return float(np.max(np.abs(got - want) / (1.0 + np.abs(want))))


def _dia_history_band(name):
    """Twice the largest move of the reference's own PCG history on the
    case's beam when one entry of b moves by one ulp
    (`tools/torch_dia_history_reference.json`, written by
    tools/torch_dia_history_reference.py)."""
    with open(os.path.join(REPO, "tools", "torch_dia_history_reference.json")) as f:
        return 2 * json.load(f)["cases"][name]["history_move"]


@pytest.mark.parametrize("name,single_band", [
    pytest.param("structured", 0.0, id="structured"),
    pytest.param("structured f32", 0.0, id="structured f32"),
    pytest.param("structured dia", 1e-9, id="structured dia"),
    pytest.param("structured dia mixed", None, id="structured dia mixed")])
def test_the_structured_hierarchy_across_processes(rounds, name, single_band):
    """(h) -hierarchy structured -num_devices 8, 2 x 4 against 1 x 8: the
    same count and x exactly (band 0.0), the history within `_route`'s
    floor. The plane-split levels apply their operators in the global
    operators' own expression (`parallel.halo.make_structured_halo`: every
    tap in list order), the slab transfers contract as the global ones do,
    the dots and norms sum the 8 shards' dots in shard order
    (`RowMesh.dot`), so 2 x 4 computes what 1 x 8 does bit for bit. On the
    27-point 16^3 grid (MULT, float64 and float32): the plane halo on the
    plane-split levels and their slab transfers, the gathered form below;
    1 x 8 is the single-device iteration itself (x exact). On the
    identity-BC elasticity beam (DIA levels under PCG, float64 and under
    -mixed_precision: float32 levels, the float64 outer operator
    plane-split too): the plane halo of an operator reaching 5 along its
    component axis, whose masked transfer to the replicated coarse level
    takes the gathered form.

    1 x 8 against one device differs in the dots' summation order alone
    (the plain DIA form and K5's plain version both sum the diagonals in
    list order), as the reference's mesh does against its one device. PCG
    on this beam moves its history under any change of rounding, and so
    does the reference's: 1 x 8's history is held to one device's within
    twice the largest move of the reference's own history when one entry
    of b moves by one ulp (tools/torch_dia_history_reference.json, ROADMAP
    F17; float64: the reference 5.6e-6, 1 x 8 4.0e-6). Under
    -mixed_precision one float64 ulp does not reach the reference's
    double-single b; one float32 ulp, the cycles' precision, moves its
    history 7.1e-2 and its count from 97 to 108 and 113. There 1 x 8 takes
    76 iterations and one device 77, their histories 2.4e-2 apart: the
    count within one and x within the solution's accuracy."""
    r1 = _route(rounds, name, 0.0, single_band=single_band)
    if name.startswith("structured dia"):
        s = r1["single"]
        assert _history_move(r1["history"], s["history"]) <= _dia_history_band(name), name
        if single_band is None:
            assert abs(r1["cycles"] - s["cycles"]) <= 1
            np.testing.assert_allclose(r1["x"], s["x"], rtol=0,
                                       atol=1e-9 * np.abs(s["x"]).max())
