"""What the port's spans and counters (`amg_tpu_torch/utils/tracing.py`) cost
a cell of the benchmark: host ms per cycle with tracing off and on, in one
process, and the cost of one span site and one counter with tracing off.

    python3 tools/torch_tracing_cost.py --workload lap27_96.sync_multadd \
        [--rounds 4] [--solves 3] [--seed 7] [--device cuda] [--args '{"n": 8}']

Sets the cell up through its benchmark entry (`bench_port/entries/`), makes
one warm-up solve, then `rounds` rounds of `solves` solves with tracing
off and then on (no profiler: the on cost is the recorder's own), each
solve synchronised and timed on the host clock. The off cost of the
instrumentation is the span sites and counter adds a cycle makes (counted
with tracing on) times their measured cost with tracing off. Prints one
JSON line, with the set-up's seconds by phase (`amg.setup.*`, summed over
the levels); `--args` replaces the generator's arguments (a small size for
a rehearsal on the CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, CHECKOUT)

import torch  # noqa: E402

from amg_tpu_torch.utils import tracing  # noqa: E402
from bench_port import harness, load, trace  # noqa: E402


def site_cost_ns(reps: int = 200000) -> dict:
    """ns per span site (tracing off) and per counter add, less an empty
    loop's."""
    span, count = tracing.span, tracing.count

    def loop(body):
        t0 = time.perf_counter_ns()
        body(reps)
        return (time.perf_counter_ns() - t0) / reps

    def empty(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with span("restrict", 3):
                pass

    def counts(n):
        for _ in range(n):
            count("spmv.ell")

    base = min(loop(empty) for _ in range(3))
    return {"span_off_ns": min(loop(spans) for _ in range(3)) - base,
            "count_ns": min(loop(counts) for _ in range(3)) - base}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--solves", type=int, default=3)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--args", default=None, help="JSON generator arguments")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    bench = harness.load_benchmark()
    f = harness.cell_files(bench, a.workload)
    config, traffic = f["config"], f["traffic"]
    if a.args:
        config = dict(config, args=json.loads(a.args))
    dtype = harness.DTYPES[config["dtype"]]
    entry = harness.load_module("entries", traffic["entry"])
    inputs = harness.make_inputs(config)
    n = inputs["A"].shape[0]
    state = entry.setup(inputs, config, traffic, device, dtype)
    setup = {}
    for name, sec in tracing.last_setup().items():
        phase = name.split(":")[0][len("amg.setup."):]
        setup[phase] = setup.get(phase, 0.0) + sec

    def solve(i):
        b = load.rhs(n, a.seed, i, device, dtype)
        trace.sync(device)
        t0 = time.perf_counter()
        iters = entry.solve(state, b, load.mix(a.seed, i, "draws"))[1]
        trace.sync(device)
        return time.perf_counter() - t0, iters

    solve(-1)
    per = {"off": [], "on": []}
    sites = counts = cycles_on = 0
    i = 0
    for _ in range(a.rounds):
        for mode in ("off", "on"):
            s = c = 0
            before = tracing.counters()
            tracing.reset(counters=False)
            with tracing.on() if mode == "on" else contextlib.nullcontext():
                for _ in range(a.solves):
                    dt, it = solve(i)
                    i += 1
                    s, c = s + dt, c + it
            per[mode].append(s / c * 1e3)
            if mode == "on":
                sites += sum(k for _, k in tracing.totals().values())
                after = tracing.counters()
                counts += sum(v - before.get(k, 0) for k, v in after.items())
                cycles_on += c
    cost = site_cost_ns()
    sites_pc, counts_pc = sites / cycles_on, counts / cycles_on
    off_ms = statistics.median(per["off"])
    off_cost_ms = (sites_pc * cost["span_off_ns"] + counts_pc * cost["count_ns"]) / 1e6
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({
        "workload": a.workload, "device": kind, "rounds": a.rounds, "solves": a.solves,
        "host_ms_per_cycle_off": per["off"], "host_ms_per_cycle_on": per["on"],
        "median_off": off_ms, "median_on": statistics.median(per["on"]),
        "span_sites_per_cycle": sites_pc, "counter_adds_per_cycle": counts_pc, **cost,
        "off_cost_ms_per_cycle": off_cost_ms, "off_cost_share": off_cost_ms / off_ms,
        "setup_s_by_phase": setup,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
