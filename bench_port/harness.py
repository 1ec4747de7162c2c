"""The benchmark's run of one cell: inputs, set-up, warm-up, the measured
window, the traced solves, the metrics and the check of the outputs.

Everything that belongs to one cell is found by name:

  BENCHMARK.json                     the cell: its configuration and traffic
  bench_port/configs/<config>.json   (the file BENCHMARK.json names) sizes,
                                     generator, hierarchy, dtype
  bench_port/reference/generators/<generator>.py   the inputs
  bench_port/traffic/<traffic>.json  the load and the solver entry
  bench_port/entries/<entry>.py      setup() and solve() of the program
  bench_port/metrics/<metric>.py     read(run) of one metric
  bench_port/limits/<cell>.json      the limit of each number compared

An entry's setup(inputs, config, traffic, device, dtype) returns a state
with the program's host hierarchy `hh` and device hierarchy `hier`;
solve(state, b, draw_seed) returns (x, cycles, the solver's relative
residual) of one right-hand side.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, List, Optional

import numpy as np
import torch

from bench_port import load, trace
from bench_port.reference import check

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
DTYPES = {"float64": torch.float64, "float32": torch.float32}
# the control: the nearest precision below the configuration's
CONTROL = {"float64": "float32"}
FORBIDDEN = ("jax", "jaxlib", "flax", "amg_tpu")
TRACE_INDEX = 10**6  # solve indices of the traced solves, apart from the window's


@dataclass
class Solve:
    index: int
    seconds: float
    iters: int
    rel: float
    ok: bool


@dataclass
class Run:
    """What the metric readers read."""

    cell: str
    device: torch.device
    kind: str
    dtype: torch.dtype
    seed: int
    state: Any
    solves: List[Solve]
    window_s: float
    setup_s: float
    memory_peak_bytes: int
    trace: Optional[trace.Trace] = None

    def probe(self, n: int) -> torch.Tensor:
        """A vector of length n drawn from the run's seed, on the device."""
        return load.probe(n, self.seed, self.device, self.dtype)


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(*parts) -> dict:
    with open(ROOT.joinpath(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """bench_port/<kind>/<name>.py as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path.relative_to(CHECKOUT)}")
    mod_name = f"bench_port.{kind.replace('/', '.')}.{name}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, cell: str) -> dict:
    """The workload entry, the configuration, the traffic and the limits of
    a cell, each loaded from its own file."""
    w = _by_name(bench["workloads"], cell, "workload")
    c = _by_name(bench["configs"], w["config"], "config")
    with open(CHECKOUT / c["file"]) as f:
        config = json.load(f)
    return {"workload": w, "config": config,
            "traffic": load_json("traffic", f"{w['traffic']}.json"),
            "limits": load_json("limits", f"{cell}.json")}


def metrics_for(bench: dict, cell: str, traced: bool) -> list:
    """The metrics a cell reports: per_layer with a trace, else end_to_end;
    a metric with a `workloads` list only in those cells."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def make_inputs(config: dict) -> dict:
    return load_module("reference/generators", config["generator"]).generate(**config["args"])


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the benchmark must not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Reservoir:
    """k solves drawn uniformly from the window's, by a generator seeded
    from the run's seed (Algorithm R); holds their x where they lie."""

    def __init__(self, k: int, seed: int):
        self.k, self.kept = k, {}
        self.rng = np.random.default_rng(load.mix(seed, 0, "sample"))

    def offer(self, i: int, x) -> None:
        if i < self.k:
            self.kept[i] = x
            return
        j = int(self.rng.integers(0, i + 1))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[i] = x


def run_solve(entry, state, traffic, n, seed, index, device, dtype):
    """(Solve, x) of solve `index`: b made and synchronised first, then timed
    from the entry's call until x is back, synchronised."""
    b = load.rhs(n, seed, index, device, dtype)
    trace.sync(device)
    t0 = time.perf_counter()
    x, iters, rel = entry.solve(state, b, load.mix(seed, index, "draws"))
    trace.sync(device)
    dt = time.perf_counter() - t0
    ok = math.isfinite(rel) and rel <= traffic["tol"]
    return Solve(index, dt, iters, rel, ok), x


def run_cell(bench: dict, cell: str, seed: int, seconds: float, traced: bool,
             device, control: bool = False, files: Optional[dict] = None,
             chips: int = 1):
    """One run of a cell: (result dict, lines of the numbers compared).
    `files` replaces the cell's files (a test's small sizes or broken entry)."""
    device = torch.device(device)
    f = files or cell_files(bench, cell)
    config, traffic, limits = f["config"], f["traffic"], f["limits"]
    load.check(traffic)
    dtype_name = CONTROL[config["dtype"]] if control else config["dtype"]
    dtype = DTYPES[dtype_name]
    entry = f.get("entry") or load_module("entries", traffic["entry"])
    t_in = time.perf_counter()
    inputs = make_inputs(config)
    A = inputs["A"]
    n = A.shape[0]
    log(f"{cell}: inputs {time.perf_counter() - t_in:.2f} s ({n} rows, {A.nnz} nonzeros)")
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"

    # set-up: the program's, and one warm-up solve of the cell's shapes
    trace.sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    state = entry.setup(inputs, config, traffic, device, dtype)
    run_solve(entry, state, traffic, n, seed, -1, device, dtype)
    setup_s = time.perf_counter() - t0
    log(f"{cell}: set-up and warm-up {setup_s:.2f} s")

    # the window: a closed loop of one client
    sample = Reservoir(int(traffic["sample_solves"]), seed)
    solves = []
    start = time.perf_counter()
    while True:
        s, x = run_solve(entry, state, traffic, n, seed, len(solves), device, dtype)
        solves.append(s)
        sample.offer(s.index, x)
        del x
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    per = sorted(s.seconds / max(s.iters, 1) * 1e3 for s in solves)
    log(f"{cell}: window {window_s:.2f} s, {len(solves)} solves, "
        f"{sum(s.iters for s in solves)} cycles; ms a cycle min {per[0]:.4f} median "
        f"{per[len(per) // 2]:.4f} max {per[-1]:.4f}; peak {peak} B")

    run = Run(cell=cell, device=device, kind=kind, dtype=dtype, seed=seed, state=state,
              solves=solves, window_s=window_s, setup_s=setup_s, memory_peak_bytes=peak)
    if traced:
        def traced_solves():
            done = [run_solve(entry, state, traffic, n, seed, TRACE_INDEX + j, device, dtype)[0]
                    for j in range(int(traffic["trace_solves"]))]
            return len(done), sum(s.iters for s in done)

        t_tr = time.perf_counter()
        run.trace = trace.trace_solves(traced_solves, device)
        log(f"{cell}: traced {run.trace.solves} solves in {run.trace.window_s:.2f} s, "
            f"reduced in {time.perf_counter() - t_tr - run.trace.window_s:.2f} s")
    metrics = {}
    for m in metrics_for(bench, cell, traced):
        v = load_module("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the outputs judged, to the host; then the program's state is freed
    # before the reference runs
    v = run.probe(n)
    y = (state.hier.levels[0].A @ v).double().cpu().numpy()
    v = v.double().cpu().numpy()
    outs = {i: x.double().cpu().numpy() for i, x in sorted(sample.kept.items())}
    del state, run.state, sample
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    pairs = [(load.rhs(n, seed, i, device).cpu().numpy(), x) for i, x in outs.items()]
    numbers = check.readings(A, pairs, (v, y))
    log(f"{cell}: reference check of solves {sorted(outs)} in "
        f"{time.perf_counter() - t_ref:.2f} s")
    correct = check.judge(numbers, limits)
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}

    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": chips,
                  "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(solves),
              "failed": sum(not s.ok for s in solves), "metrics": metrics,
              "device": device_rec}
    if run.trace is not None:
        device_rec.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv) -> int:
    args = parse(argv)
    bench = load_benchmark()
    chips = int(_by_name(bench["workloads"], args.workload, "workload")["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                             device, chips=chips)
    bad = forbidden_modules()
    if bad:
        print(f"loaded modules the benchmark must not load: {bad}", file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
