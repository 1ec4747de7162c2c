"""The result line and the stderr lines of a run, driven on the CPU at a
tiny size (the look for a card skipped)."""

import json

import pytest

from bench_port import harness
from bench_small import CELLS, run_small

LAST_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_line(cell):
    result, lines = run_small(cell)
    assert list(result) == LAST_KEYS  # "checks" comes last
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    m = result["metrics"]
    # off the card no memory peak is reported; the rest are there
    want = {"solves_per_s", "setup_s"} | ({"solve_ms_p95"} if "async" not in cell else set())
    assert set(m) == want and all(v["value"] > 0 for v in m.values())
    assert lines == [f"check {k}: {c['value']!r} limit {c['limit']!r}"
                     for k, c in result["checks"].items()]
    json.dumps(result)


def test_traced_line_has_trace_keys():
    result, _ = run_small("beam_sa.pcg", traced=True)
    assert list(result) == LAST_KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # off the card the device metrics find nothing to read and are left out
    assert set(result["metrics"]) == {"cycles_per_solve"}


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    assert harness.main(["--workload", "beam_sa.pcg", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
