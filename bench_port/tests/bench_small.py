"""Tiny versions of the cells, for the CPU. A cell's files are found from
its name, <config>.<traffic>, so the async cell that waits outside
BENCHMARK.json (PERF.md, Open questions) is driven too."""

import json

from bench_port import harness

SMALL_ARGS = {"lap27_96": {"n": 8}, "beam_sa": {"nx": 8, "ny": 2, "nz": 2}}
CELLS = ("lap27_96.async_full", "beam_sa.pcg", "lap27_96.sync_multadd")


def small_files(bench, cell):
    """The cell's own files with the grid cut to a tiny size."""
    config_name, traffic = cell.split(".", 1)
    entry = next(c for c in bench["configs"] if c["name"] == config_name)
    with open(harness.CHECKOUT / entry["file"]) as f:
        config = json.load(f)
    return {"config": dict(config, args=SMALL_ARGS[config_name]),
            "traffic": harness.load_json("traffic", f"{traffic}.json"),
            "limits": harness.load_json("limits", f"{cell}.json")}


def run_small(cell, seed=2**31 + 7, seconds=0.3, traced=False, **kw):
    bench = harness.load_benchmark()
    kw.setdefault("files", small_files(bench, cell))
    return harness.run_cell(bench, cell, seed, seconds, traced, "cpu", **kw)
