"""The port's segmented per-phase profile and the CLI driver, on the CPU.

  * `profile_phases` computes the production cycle's iterates: its x after
    a few cycles equals `cycle_step` iterated, to 1e-12, for MULT and for
    each additive cycle (multadd with smoothed transfers, afacx, afacj,
    bpx), on the generic hierarchy of the 27-point Laplacian at 10^3;
  * on a hierarchy of the JAX package carried across, it equals the
    reference's `PhaseReport._x` on the same input (1e-12);
  * `main([... "-num_runs", "2", "-print_level_stats", "-device", "cpu"])`
    prints each run's report with the phase table and the aggregate block;
  * the iteration sweep (`-max_num_iters`) runs each count of the sweep
    (with `-no_resnorm`, exactly that many cycles);
  * `python -m amg_tpu_torch.utils.cli -device cpu -problem 5pt -n 32
    -oneline_output` prints golden config1's 16 cycles.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, cycle_step
from amg_tpu_torch.utils import cli
from amg_tpu_torch.utils.phases import profile_phases

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLES = {
    "mult": CycleConfig(),
    "multadd": CycleConfig(cycle=CycleType.MULTADD, use_smoothed_transfers=True),
    "afacx": CycleConfig(cycle=CycleType.AFACX),
    "afacj": CycleConfig(cycle=CycleType.AFACJ),
    "bpx": CycleConfig(cycle=CycleType.BPX),
}


@pytest.fixture(scope="module")
def h10():
    prob = laplacian_3d_27pt(10)
    _, hier = build_hierarchy(prob.A, HierarchyParams(max_coarse_size=20),
                              fine_stencil=prob.stencil, device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    return hier, b


@pytest.mark.parametrize("name", list(CYCLES))
def test_the_segmented_cycle_is_the_production_cycle(h10, name):
    hier, b = h10
    assert hier.num_levels >= 3
    cfg = CYCLES[name]
    x0 = torch.from_numpy(np.random.default_rng(1).random(b.shape[0]))
    rep = profile_phases(hier, cfg, b, x0, num_cycles=3)
    x = x0
    for _ in range(3):
        x = cycle_step(hier, cfg, x, b)
    np.testing.assert_allclose(rep._x.numpy(), x.numpy(), rtol=1e-12, atol=1e-14)
    t = rep.totals()
    assert rep.cycles == 3 and rep.num_levels == hier.num_levels
    assert t["smooth_wtime"] > 0 and t["prolong_wtime"] > 0 and t["coarse_wtime"] > 0
    assert t["comm_bytes_per_cycle"] == 0 and t["comm_msgs_per_cycle"] == 0


@pytest.mark.parametrize("name", ["mult", "multadd"])
def test_the_segmented_cycle_equals_the_reference_s(name):
    import jax.numpy as jnp

    from amg_tpu.problems import laplacian_3d_27pt as r_27pt
    from amg_tpu.setup import hierarchy as rhi
    from amg_tpu.solve.cycles import CycleConfig as RCfg
    from amg_tpu.solve.cycles import CycleType as RType
    from amg_tpu.utils.phases import profile_phases as r_profile
    from torch_parity import port_hierarchy

    prob = r_27pt(8)
    hh, jh = rhi.build_hierarchy(prob.A, rhi.HierarchyParams(max_coarse_size=20),
                                 fine_stencil=prob.stencil)
    th = port_hierarchy(jh, host=hh)
    b = np.random.default_rng(0).random(prob.n)
    rcfg = RCfg(cycle=RType(name), use_smoothed_transfers=(name == "multadd"))
    want = r_profile(jh, rcfg, jnp.asarray(b), num_cycles=2)
    got = profile_phases(th, CYCLES[name], torch.from_numpy(b), num_cycles=2)
    np.testing.assert_allclose(got._x.numpy(), np.asarray(want._x), rtol=1e-12, atol=1e-14)
    assert got.num_levels == want.num_levels


def test_main_aggregates_runs_with_the_phase_table(capsys):
    assert cli.main(["-problem", "27pt", "-n", "10", "-num_runs", "2", "-print_level_stats",
                     "-device", "cpu", "-max_coarse", "20"]) == 0
    out = capsys.readouterr().out
    assert out.count("per-phase wtime over 5 instrumented cycles") == 2
    assert out.count("cycles         : ") == 3  # two reports and the aggregate
    assert "=== aggregate over 2 runs (mean/min/max) ===" in out
    agg = out.split("=== aggregate over 2 runs (mean/min/max) ===")[1]
    for key in ("solve wtime", "setup wtime", "cycles", "rel res 2-norm"):
        assert key in agg
    cyc = [float(v) for v in agg.split("cycles         : ")[1].split("\n")[0].split(" / ")]
    assert cyc[0] == cyc[1] == cyc[2] > 0


def test_main_sweeps_the_iteration_count(capsys):
    assert cli.main(["-problem", "5pt", "-n", "16", "-no_resnorm", "-start_num_iters", "2",
                     "-incr_num_iters", "3", "-max_num_iters", "8", "-oneline_output",
                     "-warmup", "-device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    heads = [ln for ln in lines if ln.startswith("=== num_cycles = ")]
    assert heads == ["=== num_cycles = 2 ===", "=== num_cycles = 5 ===",
                     "=== num_cycles = 8 ==="]
    runs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [r["cycles"] for r in runs] == [2, 5, 8]
    rel = [r["rel_res"] for r in runs]
    assert rel[0] > rel[1] > rel[2]


def test_the_cli_module_runs_golden_config1():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    code = ("import sys, runpy\n"
            "sys.argv = ['cli', '-device', 'cpu', '-problem', '5pt', '-n', '32', "
            "'-oneline_output']\n"
            "try:\n"
            "    runpy.run_module('amg_tpu_torch.utils.cli', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'amg_tpu'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(ROOT, "tests", "golden", "config1_5pt_mult.json")) as f:
        g = json.load(f)
    assert line["cycles"] == g["cycles"] == 16 and line["n"] == 1024
    assert line["rel_res"] <= 1e-8
