#!/usr/bin/env python3
"""The JAX package's own results on the elasticity and Maxwell
preconditioners, for the gates `chip_smoke.py`'s phases (a)-(e) hold the
port to; writes `tools/torch_elasticity_reference.json`.

    JAX_PLATFORMS=cpu python3 tools/torch_elasticity_reference.py \
        [--only jgs|sa|ams|mixed] [--out PATH]

Runs the reference on the CPU in float64 (its native setup library must
load for the generic hierarchy), through the calls `chip_smoke.py` makes:
  * jgs: the JAX bench's elasticity solve (`bench.py::aux_dia_elasticity`):
    elasticity_beam(144, 18, 18, bc="identity"),
    build_dia_structured_hierarchy(smoother=HYBRID_JGS) in float32, MULT
    V(2,2) hybrid JGS under mixed_pcg(tol=1e-5, max_cycles=60) against the
    double-single operator pair, b = rhs / |rhs|: level shapes, iterations,
    history;
  * sa: golden config8's recipe at full size, elasticity_beam(144, 18, 18)
    (bc "reduce", the rigid-body modes as candidates): setup_type "sa",
    num_functions 3, max_coarse_size 64, MULT V(1,1) L1-Jacobi under
    solve(outer="pcg") to 1e-8 within 200 iterations, float64, b = rhs /
    |rhs|: level_n, level_nnz, iterations, history, the true residual of
    x; and the same on a float32 hierarchy to 1e-4 (it does not converge);
  * ams: golden config5's recipe at maxwell_curlcurl(n=40): build_ams with
    the default params and Pi, solve_ams_pcg to 1e-8 within 200, b =
    default_rng(0).random(n): the node and Pi hierarchies' level_n,
    iterations, history; and ams_async_additive_solve on
    maxwell_curlcurl(n=8) (fire_prob 0.8, sim_read_delay 2, omega "auto",
    PRNGKey(0), tol 1e-8 within 600 steps, b = rhs / |rhs|): its omega (the
    same estimate_cycle_eigs call, repeated by tests/torch_parity.py), steps,
    history and every draw it consumed (per step: Lg firing and Lg column
    uniforms, `JaxAMSDraws`);
  * mixed: mixed_solve on the 27-point Laplacian at 96^3, the default
    HierarchyParams with dtype float32 (the stencil kept on level 0), the
    float64 stencil as the outer operator, MULT V(1,1) L1-Jacobi, tol 1e-8
    within 200 cycles, b = default_rng(0).random(n): level_n, cycles,
    history.
Each part merges its entry into the JSON. About 5 min (jgs), 2 (sa), 3
(ams) and 2 (mixed) on an 8-core CPU, a few GB each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
OUT = os.path.join(ROOT, "tools", "torch_elasticity_reference.json")
BEAM = (144, 18, 18)
MAXWELL_N, ASYNC_N, MIXED_N = 40, 8, 96


def hist(res):
    import numpy as np

    h = np.asarray(res.history, dtype=np.float64)
    return h[~np.isnan(h)].tolist()


def run_jgs():
    import jax.numpy as jnp
    import numpy as np

    from amg_tpu.problems.elasticity import elasticity_beam
    from amg_tpu.setup.structured import build_dia_structured_hierarchy, csr_to_dia_stencil
    from amg_tpu.smooth import SmootherType
    from amg_tpu.solve import CycleConfig, CycleType
    from amg_tpu.solve.mixed import mixed_pcg

    prob = elasticity_beam(*BEAM, bc="identity")
    t0 = time.perf_counter()
    hh, hier = build_dia_structured_hierarchy(
        prob.A, tuple(c + 1 for c in BEAM), num_functions=3, dtype=jnp.float32,
        smoother=SmootherType.HYBRID_JGS)
    setup_s = time.perf_counter() - t0
    pair = csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float32, return_lo=True)
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.HYBRID_JGS,
                      num_pre_sweeps=2, num_post_sweeps=2)
    b = jnp.asarray(np.asarray(prob.rhs) / np.linalg.norm(prob.rhs), dtype=jnp.float32)
    t0 = time.perf_counter()
    res = mixed_pcg(hier, pair, cfg, b, tol=1e-5, max_cycles=60)
    st = hh.stats()
    return {"n": prob.n, "level_n": st["n"], "level_nnz": st["nnz"],
            "iters": int(res.iters), "rel_res": float(res.rel_resnorm), "history": hist(res),
            "setup_s": setup_s, "solve_s": time.perf_counter() - t0}


def run_sa():
    import jax.numpy as jnp
    import numpy as np

    from amg_tpu.problems.elasticity import elasticity_beam
    from amg_tpu.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu.solve import CycleConfig, solve

    prob = elasticity_beam(*BEAM)
    params = HierarchyParams(num_functions=3, setup_type="sa")
    t0 = time.perf_counter()
    hh, hier = build_hierarchy(prob.A, params, near_nullspace=prob.near_nullspace)
    setup_s = time.perf_counter() - t0
    b = jnp.asarray(np.asarray(prob.rhs) / np.linalg.norm(prob.rhs))
    t0 = time.perf_counter()
    res = solve(hier, CycleConfig(), b, tol=1e-8, max_cycles=200, outer="pcg")
    solve_s = time.perf_counter() - t0
    x = np.asarray(res.x)
    st = hh.stats()
    # the same recipe on a float32 hierarchy: plain float32 PCG does not
    # converge on this beam (kappa * eps_f32 > 1)
    _, h32 = build_hierarchy(prob.A, dataclasses.replace(params, dtype=jnp.float32),
                             near_nullspace=prob.near_nullspace)
    r32 = solve(h32, CycleConfig(), b.astype(jnp.float32), tol=1e-4, max_cycles=200,
                outer="pcg")
    return {"n": prob.n, "level_n": st["n"], "level_nnz": st["nnz"],
            "operator_complexity": st["operator_complexity"],
            "iters": int(res.iters), "rel_res": float(res.rel_resnorm), "history": hist(res),
            "true_rel_res": float(np.linalg.norm(np.asarray(b) - prob.A @ x)
                                  / np.linalg.norm(np.asarray(b))),
            "f32_pcg": {"iters": int(r32.iters), "rel_res": float(r32.rel_resnorm)},
            "setup_s": setup_s, "solve_s": solve_s}


def run_ams():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from amg_tpu.problems.maxwell import maxwell_curlcurl
    from amg_tpu.setup.hierarchy import HierarchyParams, _format_converter
    from amg_tpu.solve.ams import ams_async_additive_solve, build_ams, solve_ams_pcg
    from torch_parity import JaxAMSDraws, jax_async_ams_eigs

    def level_stats(hier):
        return [int(lv.A.shape[0]) for lv in hier.levels]

    prob = maxwell_curlcurl(MAXWELL_N)
    t0 = time.perf_counter()
    ams, cfg = build_ams(prob.A, prob.aux["G"], params=None, Pi=prob.aux["Pi"])
    setup_s = time.perf_counter() - t0
    A_dev = _format_converter(HierarchyParams())(prob.A, jnp.float64)
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    t0 = time.perf_counter()
    res = solve_ams_pcg(A_dev, ams, cfg, b, tol=1e-8, max_iters=200)
    out = {"n": prob.n, "node_level_n": level_stats(ams.node_hier),
           "pi_level_n": level_stats(ams.pi_hier),
           "iters": int(res.iters), "rel_res": float(res.rel_resnorm), "history": hist(res),
           "setup_s": setup_s, "solve_s": time.perf_counter() - t0}
    print("ams pcg", out["iters"], out["rel_res"], flush=True)

    prob8 = maxwell_curlcurl(ASYNC_N)
    ams8, _ = build_ams(prob8.A, prob8.aux["G"], params=None, Pi=prob8.aux["Pi"])
    A8 = _format_converter(HierarchyParams())(prob8.A, jnp.float64)
    b8 = jnp.asarray(np.asarray(prob8.rhs) / np.linalg.norm(prob8.rhs))
    co = jax_async_ams_eigs(A8, ams8)
    omega = float(0.7 * 2.0 / (co.alpha + co.beta))
    Lg = 1 + ams8.node_hier.num_levels + ams8.pi_hier.num_levels
    t0 = time.perf_counter()
    ares = ams_async_additive_solve(A8, ams8, b8, key=jax.random.PRNGKey(0), fire_prob=0.8,
                                    sim_read_delay=2, tol=1e-8, max_cycles=600)
    steps = int(ares.iters)
    out["async_n8"] = {"n": prob8.n, "groups": Lg, "omega": omega, "iters": steps,
                       "rel_res": float(ares.rel_resnorm), "history": hist(ares),
                       "s": time.perf_counter() - t0,
                       "draws": JaxAMSDraws(0).record(Lg, steps)}
    print("async ams", steps, float(ares.rel_resnorm), flush=True)
    return out


def run_mixed():
    import jax.numpy as jnp
    import numpy as np

    from amg_tpu import native_backend
    from amg_tpu.problems import laplacian_3d_27pt
    from amg_tpu.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu.solve import CycleConfig
    from amg_tpu.solve.mixed import mixed_solve

    if not native_backend.available():
        raise RuntimeError("the reference's native setup library did not load")
    prob = laplacian_3d_27pt(MIXED_N)
    t0 = time.perf_counter()
    hh, hier32 = build_hierarchy(prob.A, HierarchyParams(dtype=jnp.float32),
                                 fine_stencil=prob.stencil)
    setup_s = time.perf_counter() - t0
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    t0 = time.perf_counter()
    res = mixed_solve(hier32, prob.stencil, CycleConfig(), b, tol=1e-8, max_cycles=200)
    st = hh.stats()
    return {"n": prob.n, "level_n": st["n"], "level_nnz": st["nnz"],
            "iters": int(res.iters), "rel_res": float(res.rel_resnorm), "history": hist(res),
            "setup_s": setup_s, "solve_s": time.perf_counter() - t0}


PARTS = {"jgs": run_jgs, "sa": run_sa, "ams": run_ams, "mixed": run_mixed}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=tuple(PARTS), default=None)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    import amg_tpu  # noqa: F401  (float64 on)

    out = {}
    for name, fn in PARTS.items():
        if args.only in (None, name):
            t0 = time.perf_counter()
            out[name] = fn()
            print(name, out[name]["iters"], f"{time.perf_counter() - t0:.1f} s", flush=True)
    if os.path.exists(args.out):  # the other parts may have landed meanwhile
        with open(args.out) as f:
            out = dict(json.load(f), **out)
    with open(args.out, "w") as f:
        json.dump(out, f, separators=(",", ":"))
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
