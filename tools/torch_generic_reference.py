#!/usr/bin/env python3
"""The JAX package's own results on the generic (algebraic) AMG path at the
sizes `chip_smoke.py`'s generic phase solves, for the constants it holds the
port to (`GENERIC_REF` there).

    JAX_PLATFORMS=cpu python3 tools/torch_generic_reference.py [--only 48]

Runs the reference on the CPU in float64 (its native setup library must
load): `build_hierarchy` of the 27-point Laplacian with the default
HierarchyParams (native HMIS, ext+i, p_max_elmts 4, the stencil kept on level
0) and `solve` from x0 = 0 with b = default_rng(0).random(n):
  * 96^3: MULT V(1,1) L1-Jacobi to tol 1e-8 (level_n, level_nnz, the ELL
    widths, cycles, the history);
  * 48^3: MULT V(1,1) hybrid JGS to 1e-8 (the README quickstart); Jacobi
    V(1,1) with accel="cheby" after cheby_setup(num_iters=20) to 1e-8
    (golden config2's configuration); PCG over an L1-Jacobi V(1,1) to 1e-8.
Prints one JSON object. The 96^3 run takes about a minute and a few GB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, choices=(48, 96), default=None)
    args = ap.parse_args()

    import jax.numpy as jnp
    import numpy as np

    from amg_tpu import native_backend
    from amg_tpu.problems import laplacian_3d_27pt
    from amg_tpu.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu.smooth import SmootherType
    from amg_tpu.solve import CycleConfig, solve
    from amg_tpu.solve.driver import cheby_setup

    if not native_backend.available():
        print("the reference's native setup library did not load", file=sys.stderr)
        return 1
    out = {}

    def run(n, smoother, **kw):
        prob = laplacian_3d_27pt(n)
        t0 = time.perf_counter()
        hh, hier = build_hierarchy(prob.A, HierarchyParams(smoother=smoother),
                                   fine_stencil=prob.stencil)
        setup_s = time.perf_counter() - t0
        cfg = CycleConfig(smoother=smoother)
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        if kw.get("accel") == "cheby":
            kw["cheby_coeffs"] = cheby_setup(hier, cfg, num_iters=20)
        t0 = time.perf_counter()
        res = solve(hier, cfg, b, tol=1e-8, **kw)
        solve_s = time.perf_counter() - t0
        st = hh.stats()
        h = np.asarray(res.history)
        return {
            "level_n": st["n"], "level_nnz": st["nnz"],
            "ell_widths": [lv.A.max_row_nnz for lv in hh.levels],
            "iters": int(res.iters), "rel_res": float(res.rel_resnorm),
            "history": h[~np.isnan(h)].tolist(),
            "setup_s": setup_s, "solve_s": solve_s,
        }

    if args.only in (None, 48):
        out["48 hybrid_jgs"] = run(48, SmootherType.HYBRID_JGS)
        out["48 jacobi cheby"] = run(48, SmootherType.JACOBI, accel="cheby")
        out["48 l1_jacobi pcg"] = run(48, SmootherType.L1_JACOBI, outer="pcg")
    if args.only in (None, 96):
        out["96 l1_jacobi"] = run(96, SmootherType.L1_JACOBI)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
