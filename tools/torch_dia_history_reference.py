#!/usr/bin/env python3
"""How far the JAX package's own PCG history on the identity-BC elasticity
beam 15x4x4 (`-hierarchy structured`: DIA levels) moves when one entry of b
moves by one ulp, for the history bands of the "structured dia" cases of
`tests/test_torch_multiprocess.py`; writes
`tools/torch_dia_history_reference.json`.

    JAX_PLATFORMS=cpu python3 tools/torch_dia_history_reference.py [--out PATH]

For each case it runs the reference's own `run_experiment` on the CPU on
one device: once as it is, then once for each of b's largest entries with
the b its solver receives moved up at that entry by one ulp (the solver is
wrapped; the method of golden config8's band, ROADMAP F9). The float64 case
moves one float64 ulp at each of its 8 largest entries. The -mixed_precision
case runs double-single PCG around float32 cycles, whose b keeps about 48
bits, so one float64 ulp leaves its run unchanged (recorded); it moves one
float32 ulp, the cycles' precision, at its 2 largest entries. It records
every run's count and history and the largest move of the history as the
test measures one history against another, |h' - h| / (1 + |h|) over
their common iterations. About two minutes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tools", "torch_dia_history_reference.json")

BEAM = {"problem": "elasticity", "nx": 15, "ny": 4, "nz": 4, "elast_bc": "identity",
        "hierarchy": "structured"}
# name: (SolverOptions keywords, the ulp's float type, entries moved); the
# worker's cases, on one device
CASES = {
    "structured dia": (BEAM, "float64", 8),
    "structured dia mixed": (dict(BEAM, mixed_precision=True), "float32", 2),
}


def _moved(b, i, ulp):
    """b with its entry i moved up by one ulp of the float type `ulp`."""
    import jax.numpy as jnp
    import numpy as np

    bp = np.array(b, dtype=np.float64)
    bp[i] = bp[i] + float(np.spacing(getattr(np, ulp)(abs(bp[i]))))
    return jnp.asarray(bp, dtype=b.dtype)


def run(kw: dict, move=None) -> dict:
    """The reference's run_experiment of the case; with `move` = (i, ulp)
    its solver's b moved at entry i by one ulp (`amg_tpu.solve.solve` and
    `amg_tpu.solve.mixed.mixed_pcg` wrapped, which the runner imports when
    it runs). Records b's entries by magnitude, largest first."""
    import numpy as np

    import amg_tpu.solve as rsolve
    import amg_tpu.solve.mixed as rmixed
    from amg_tpu.utils.config import SolverOptions
    from amg_tpu.utils.runner import run_experiment

    saved = rsolve.solve, rmixed.mixed_pcg
    order = []

    def take(b):
        order.extend(np.argsort(-np.abs(np.asarray(b)), kind="stable").tolist())
        return b if move is None else _moved(b, *move)

    rsolve.solve = lambda hier, cfg, b, *a, **k: saved[0](hier, cfg, take(b), *a, **k)
    rmixed.mixed_pcg = lambda hier, op, cfg, b, *a, **k: saved[1](hier, op, cfg, take(b),
                                                                  *a, **k)
    try:
        st = run_experiment(SolverOptions(**kw))
    finally:
        rsolve.solve, rmixed.mixed_pcg = saved
    h = np.asarray(st.history, dtype=np.float64)
    return {"cycles": int(st.cycles), "history": h[~np.isnan(h)].tolist(),
            "rel_res": float(st.rel_resnorm), "order": order}


def _move(a, b) -> float:
    """max |a - b| / (1 + |b|) over the common iterations."""
    import numpy as np

    k = min(len(a), len(b))
    a, b = np.asarray(a[:k]), np.asarray(b[:k])
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    import amg_tpu  # noqa: F401  (x64 on before any JAX work)
    import numpy as np

    out = {"beam": BEAM, "cases": {}}
    for name, (kw, ulp, entries) in CASES.items():
        t0 = time.perf_counter()
        base = run(kw)
        order = base.pop("order")
        rec = {"options": kw, "ulp": ulp, "run": base, "moved": []}
        if ulp != "float64":  # one float64 ulp at the largest entry, for the record
            m = run(kw, (order[0], "float64"))
            rec["float64_ulp_move"] = _move(m["history"], base["history"])
        for i in order[:entries]:
            m = run(kw, (i, ulp))
            m.pop("order")
            rec["moved"].append(dict(m, entry=i, move=_move(m["history"], base["history"])))
        rec["history_move"] = max(m["move"] for m in rec["moved"])
        out["cases"][name] = rec
        moves = ", ".join(f"{m['move']:.3e}" for m in rec["moved"])
        print(f"{name}: {base['cycles']} iterations (moved by one {ulp} ulp: "
              f"{[m['cycles'] for m in rec['moved']]}), history moves {moves}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
