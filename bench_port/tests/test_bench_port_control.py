"""`correct` comes out false for the control and under each fault a
one-chip solve can have, with the rest of a run driven on the CPU at a tiny
size (the look for a card skipped)."""

import types

import pytest
import torch

from bench_port import harness
from bench_small import CELLS, run_small, small_files

BENCH = harness.load_benchmark()


def broken(cell, solve=None, setup=None):
    """The cell's files with its entry wrapped: solve(x, n) alters the
    answer where it is produced, setup(state) the set-up's result."""
    f = small_files(BENCH, cell)
    real = harness.load_module("entries", f["traffic"]["entry"])

    def _setup(*a):
        state = real.setup(*a)
        return setup(state) if setup else state

    def _solve(state, b, draw_seed):
        x, iters, rel = real.solve(state, b, draw_seed)
        return (solve(x.clone()) if solve else x), iters, rel

    f["entry"] = types.SimpleNamespace(setup=_setup, solve=_solve)
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert run_small(cell)[0]["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_one_precision_below_fails(cell):
    result, _ = run_small(cell, control=True)
    assert result["correct"] is False
    # float32's level-0 product fails on every cell; at this tiny size the
    # float32 residual may stay under its limit (at the cells' sizes it does
    # not, PERF.md)
    checks = result["checks"]
    assert checks["a0_rel_err"]["value"] > checks["a0_rel_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_fails(cell, monkeypatch):
    """Once set-up is done, every step returns its state unchanged: the
    cycle (and the preconditioner built on it) and the async corrections."""
    from amg_tpu_torch.solve import async_sim, driver

    def freeze(state):
        monkeypatch.setattr(driver, "cycle_step", lambda hier, cfg, x, b: x)
        monkeypatch.setattr(async_sim, "additive_correction",
                            lambda hier, cfg, r, lvl: torch.zeros_like(r))
        return state

    result, _ = run_small(cell, seconds=0.0, files=broken(cell, setup=freeze))
    assert result["correct"] is False and result["failed"] == result["attempted"]


def _half_left_out(x):
    x[x.shape[0] // 2:] = 0.0
    return x


def _altered(x):
    x[x.shape[0] // 3] += 1e-3 * x.abs().max()
    return x


@pytest.mark.parametrize("fault", [_half_left_out, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_fails(cell, fault):
    result, _ = run_small(cell, files=broken(cell, solve=fault))
    assert result["correct"] is False
    assert result["checks"]["true_rel_res_max"]["value"] > result["checks"]["true_rel_res_max"]["limit"]


def _operator_scaled(state):
    A0 = state.hier.levels[0].A
    vals = A0.weights if hasattr(A0, "weights") else A0.vals
    vals.mul_(1.0 + 1e-6)
    return state


@pytest.mark.parametrize("cell", CELLS)
def test_level0_operator_altered_fails(cell):
    result, _ = run_small(cell, files=broken(cell, setup=_operator_scaled))
    assert result["correct"] is False
    assert result["checks"]["a0_rel_err"]["value"] > result["checks"]["a0_rel_err"]["limit"]
