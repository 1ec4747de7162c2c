"""The readings that a cell's limits are set from: the numbers the check
compares, for many seeds, in one process (the set-up once).

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 [--control]

Per seed it makes as many solves as a run samples (the traffic's
sample_solves, solve indices 0, 1, ...) and prints one JSON line with the
numbers of `reference/check.py`. With --control the program runs one
precision below the configuration's: its readings must fail the limits.
Benchmark runs never call this.
"""

import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(bench, cell, seeds, device, control=False, files=None):
    """[(seed, numbers, failed solves, seconds)] for each seed."""
    from bench_port import harness, load
    from bench_port.reference import check

    f = files or harness.cell_files(bench, cell)
    config, traffic = f["config"], f["traffic"]
    dtype = harness.DTYPES[harness.CONTROL[config["dtype"]] if control else config["dtype"]]
    entry = f.get("entry") or harness.load_module("entries", traffic["entry"])
    inputs = harness.make_inputs(config)
    A = inputs["A"]
    n = A.shape[0]
    state = entry.setup(inputs, config, traffic, device, dtype)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        pairs, failed = [], 0
        for i in range(int(traffic["sample_solves"])):
            s, x = harness.run_solve(entry, state, traffic, n, seed, i, device, dtype)
            failed += not s.ok
            pairs.append((load.rhs(n, seed, i, device).cpu().numpy(),
                          x.double().cpu().numpy()))
        v = load.probe(n, seed, device, dtype)
        y = (state.hier.levels[0].A @ v).double().cpu().numpy()
        nums = check.readings(A, pairs, (v.double().cpu().numpy(), y))
        out.append((seed, nums, failed, time.perf_counter() - t0))
    return out


def main(argv) -> int:
    import argparse

    import torch

    from bench_port import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = harness.load_benchmark()
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, nums, failed, secs in readings(bench, args.workload, seeds, device, args.control):
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "failed": failed, "seconds": secs, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, CHECKOUT)
    sys.exit(main(sys.argv[1:]))
