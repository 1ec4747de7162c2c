"""Run one cell of BENCHMARK.json on the CUDA card and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It fails, printing no result, without the
card(s) the cell asks for, and without the program (`amg_tpu_torch`).
"""

import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # build and kernel caches at fixed paths inside the checkout, set before
    # torch is imported
    cache = os.path.join(CHECKOUT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    sys.path.insert(0, CHECKOUT)
    from bench_port import harness

    sys.exit(harness.main(sys.argv[1:]))
