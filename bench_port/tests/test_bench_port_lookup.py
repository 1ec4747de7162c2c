"""The harness finds every cell's files, and any new file, by its name."""

import json

import pytest

from bench_port import harness

BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_finds_its_files(cell):
    f = harness.cell_files(BENCH, cell)
    w = f["workload"]
    assert f["config"]["name"] == w["config"] and cell == f"{w['config']}.{w['traffic']}"
    assert harness.load_module("entries", f["traffic"]["entry"]).solve
    assert harness.load_module("reference/generators", f["config"]["generator"]).generate
    assert set(f["limits"]) == {"true_rel_res_max", "a0_rel_err"}


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_metrics_follow_their_workloads_lists():
    e2e = [m["name"] for m in harness.metrics_for(BENCH, "beam_sa.pcg", False)]
    assert e2e == ["solves_per_s", "solve_ms_p95", "peak_mem_gib", "setup_s"]
    per = [m["name"] for m in harness.metrics_for(BENCH, "beam_sa.pcg", True)]
    assert "fine_stencil_roofline" not in per and "ell_spmv_roofline" in per
    # a metric with no workloads list is reported by every cell, later ones too
    per = [m["name"] for m in harness.metrics_for(BENCH, "lap27_96.async_full", True)]
    assert per == ["cycles_per_solve", "device_ms_per_cycle", "device_idle_share"]


def test_a_new_cell_is_found_by_name(tmp_path, monkeypatch):
    """A cell added as files and an entry, with no edit of the harness."""
    for d in ("configs", "traffic", "limits", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "generator": "laplacian_27pt", "args": {"n": 4}, "dtype": "float64"}))
    (tmp_path / "traffic" / "burst.json").write_text(json.dumps({"entry": "solve"}))
    (tmp_path / "limits" / "tiny.burst.json").write_text(json.dumps({"a0_rel_err": 0}))
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(run):\n    return 42.0\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "CHECKOUT", tmp_path)
    bench = {"configs": [{"name": "tiny", "file": "configs/tiny.json"}],
             "workloads": [{"name": "tiny.burst", "config": "tiny", "traffic": "burst"}],
             "end_to_end": [{"name": "new.metric", "workloads": ["tiny.burst"]}]}
    f = harness.cell_files(bench, "tiny.burst")
    assert f["config"]["args"] == {"n": 4} and f["traffic"]["entry"] == "solve"
    assert f["limits"] == {"a0_rel_err": 0}
    assert [m["name"] for m in harness.metrics_for(bench, "tiny.burst", False)] == ["new.metric"]
    assert harness.load_module("metrics", "new.metric").read(None) == 42.0


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        harness.cell_files(BENCH, "no_such.cell")
    with pytest.raises(KeyError):
        harness.load_module("metrics", "no_such_metric")
