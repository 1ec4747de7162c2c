#!/usr/bin/env python3
"""The JAX package's own grid (level) parallel runs, for the port's tests
to hold `amg_tpu_torch/parallel/grid.py` and `solve/ams.py::
ams_grid_parallel_solve` to; writes `tools/torch_grid_reference.json`.

    JAX_PLATFORMS=cpu python3 tools/torch_grid_reference.py

Runs the reference on the CPU in float64 over 8 virtual devices (its native
setup library must load), on the fixture of its own grid tests
(tests/test_grid_parallel.py): the 5-point Laplacian at 32^2, HierarchyParams
(L1-Jacobi, keep_stencil_fine=False), b = default_rng(0).random(n),
smoothed-transfer MULTADD; and the Maxwell problem at n = 6 with G and Pi:
  * the owned storage of `plan_grid_levels(hh, D)` for D in (3, 4, 8) under
    the MULTADD (smoothed and not), AFACx, AFACj and BPX configurations:
    each device's field keys and packed bytes;
  * `grid_parallel_solve` in the modes a single-device replay cannot check
    (comm_every 2 under FULL staleness, local convergence, the asynchronous
    Chebyshev, a fail_level window): iterations, x, history, grid-wait
    summary, with each run's AsyncConfig keywords and PRNGKey;
  * `ams_grid_parallel_solve` at n = 6 with PRNGKey(0): iterations, x,
    history, the group plan and owned bytes;
  * `build_sharded_extended_system` of the 5-point Laplacian at 24^2 over 8
    devices: its padded block offsets, inv_wdiag and AA (as CSR).
About a minute on an 8-core CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tools", "torch_grid_reference.json")

# the modes held against the reference: (D, PRNGKey, max_cycles, AsyncConfig
# keywords); "cheby" takes mu and delta from cheby_setup(num_iters=20), delta
# damped 0.6x (SEMI)
SOLVES = {
    "comm_every 2 full": (8, 3, 600, {"omega": 0.7, "fire_prob": 0.8, "sim_read_delay": 1,
                                      "async_type": "full", "comm_every": 2}),
    "local": (4, 5, 600, {"omega": 0.7, "fire_prob": 0.8, "sim_read_delay": 1,
                          "async_type": "semi", "converge_test_type": "local"}),
    "cheby": (8, 3, 400, {"fire_prob": 0.5, "sim_read_delay": 2, "async_type": "semi",
                          "accel": "cheby"}),
    "fail window": (4, 0, 400, {"omega": 0.7, "fire_prob": 0.9, "sim_read_delay": 1,
                                "async_type": "semi", "fail_level": 0, "fail_start": 5,
                                "fail_duration": 10}),
}
STORAGE_CFGS = {
    "multadd smoothed": ("multadd", True),
    "multadd": ("multadd", False),
    "afacx": ("afacx", False),
    "afacj": ("afacj", False),
    "bpx": ("bpx", False),
}


def main() -> int:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from amg_tpu import native_backend
    from amg_tpu.parallel import make_row_mesh
    from amg_tpu.parallel.grid import (
        build_grid_owned_storage,
        grid_parallel_solve,
        plan_grid_levels,
    )
    from amg_tpu.problems import laplacian_2d_5pt
    from amg_tpu.problems.maxwell import maxwell_curlcurl
    from amg_tpu.setup.hierarchy import HierarchyParams, _format_converter, build_hierarchy
    from amg_tpu.smooth import SmootherType
    from amg_tpu.solve.ams import ams_grid_parallel_solve, build_ams
    from amg_tpu.solve.async_sim import AsyncConfig
    from amg_tpu.solve.cycles import CycleConfig, CycleType
    from amg_tpu.solve.driver import cheby_setup

    if not native_backend.available():
        print("the reference's native setup library did not load", file=sys.stderr)
        return 1
    assert jax.device_count() >= 8, jax.devices()

    def hist(res):
        h = np.asarray(res.history)
        return h[~np.isnan(h)].tolist()

    params = HierarchyParams(smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False)
    prob = laplacian_2d_5pt(32)
    hh, hier = build_hierarchy(prob.A, params)
    st = hh.stats()
    b = jnp.asarray(np.random.default_rng(0).random(prob.n))
    out = {"level_n": st["n"], "level_nnz": st["nnz"], "storage": {}, "solves": {}}

    for name, (cyc, smoothed) in STORAGE_CFGS.items():
        cfg = CycleConfig(cycle=CycleType(cyc), smoother=SmootherType.L1_JACOBI,
                          use_smoothed_transfers=smoothed)
        for D in (3, 4, 8):
            _, levels_of, _ = plan_grid_levels(hh, D)
            _, metas, owned = build_grid_owned_storage(hier, levels_of, cfg)
            out["storage"][f"{name} {D}"] = {
                "levels_of": [list(ls) for ls in levels_of],
                "keys": [sorted(str(list(k)) for k in m) for m in metas],
                "owned_bytes": [int(v) for v in owned]}

    cfg = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                      use_smoothed_transfers=True)
    coeffs = cheby_setup(hier, cfg, num_iters=20)
    for name, (D, key, max_cycles, kw) in SOLVES.items():
        kw = dict(kw)
        if kw.get("accel") == "cheby":
            kw.update(cheby_mu=float(coeffs.mu), cheby_delta=float(coeffs.delta) * 0.6)
        t0 = time.perf_counter()
        _, levels_of, scale = plan_grid_levels(hh, D)
        res = grid_parallel_solve(hier, cfg, AsyncConfig(**kw), levels_of, scale,
                                  make_row_mesh(D), b, key=jax.random.PRNGKey(key), tol=1e-8,
                                  max_cycles=max_cycles)
        out["solves"][name] = {
            "D": D, "key": key, "max_cycles": max_cycles, "acfg": kw,
            "iters": int(res.iters), "rel_res": float(res.rel_resnorm), "history": hist(res),
            "x": np.asarray(res.x).tolist(), "grid_wait": res.grid_wait.summary(),
            "s": time.perf_counter() - t0}
        print(name, int(res.iters), float(res.rel_resnorm), flush=True)

    pmx = maxwell_curlcurl(n=6)
    ams, _ = build_ams(pmx.A, pmx.aux["G"], Pi=pmx.aux["Pi"])
    A_mx = _format_converter(params)(pmx.A, params.dtype)
    b_mx = jnp.asarray(np.asarray(pmx.rhs) / np.linalg.norm(pmx.rhs))
    t0 = time.perf_counter()
    mres, owned = ams_grid_parallel_solve(A_mx, ams, make_row_mesh(8), b_mx,
                                          key=jax.random.PRNGKey(0), tol=1e-6, max_cycles=600)
    from amg_tpu.solve.ams import plan_ams_groups

    groups_of, gscale = plan_ams_groups(ams, 8)
    out["ams"] = {"n": 6, "key": 0, "iters": int(mres.iters),
                  "rel_res": float(mres.rel_resnorm), "history": hist(mres),
                  "x": np.asarray(mres.x).tolist(), "owned_bytes": [int(v) for v in owned],
                  "groups_of": [list(g) for g in groups_of], "scale": gscale.tolist(),
                  "s": time.perf_counter() - t0}
    print("ams", int(mres.iters), float(mres.rel_resnorm), flush=True)

    import scipy.sparse as sp

    from amg_tpu.solve.extended import build_sharded_extended_system

    hh24, _ = build_hierarchy(laplacian_2d_5pt(24).A, params)
    ext = build_sharded_extended_system(hh24, params, make_row_mesh(8))
    cols, vals = np.asarray(ext.AA.cols), np.asarray(ext.AA.vals)
    n_ext = ext.offsets[-1]
    AA = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(n_ext), cols.shape[1]),
                                       cols.ravel())), shape=(n_ext, n_ext))
    AA.eliminate_zeros()
    AA.sort_indices()
    out["ext"] = {"n": 24, "offsets": list(ext.offsets),
                  "inv_wdiag": np.asarray(ext.inv_wdiag).tolist(),
                  "indptr": AA.indptr.tolist(), "indices": AA.indices.tolist(),
                  "data": AA.data.tolist()}
    print("ext", n_ext, AA.nnz, flush=True)
    with open(OUT, "w") as f:
        json.dump(out, f)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
