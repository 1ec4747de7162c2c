#!/usr/bin/env python3
"""The JAX package's own results on the additive and asynchronous solvers of
the generic (algebraic) hierarchy, for the gates `chip_smoke.py`'s async
phase holds the port to; writes `tools/torch_async_reference.json`.

    JAX_PLATFORMS=cpu python3 tools/torch_async_reference.py [--only 48|96]

Runs the reference on the CPU in float64 (its native setup library must
load), through the calls `chip_smoke.py` makes: `build_hierarchy` of the
27-point Laplacian with the default HierarchyParams (the stencil kept on
level 0), b = default_rng(0).random(n), x0 = 0, the CLI defaults of each
solver (L1-Jacobi; smoothed transfers for multadd and mult_multadd;
Chebyshev after cheby_setup(num_iters=20) for multadd, afacx, afacj and bpx;
none for mult_multadd; tol 1e-8 within 200 cycles), and for the async
solvers the runner's recipe (`async_options` in tests/torch_parity.py:
Richardson from the MULTADD cfg's bounds, delta damped 0.4x under FULL
staleness and 0.6x under SEMI; sim_read_delay 4, fire_prob 0.5, reads of
the solution):
  * 48^3: the sync cycle count and history of multadd, afacx, bpx and
    mult_multadd; afacj's history over 40 cycles (it stalls with these
    defaults, ROADMAP F7); FULL async_multadd's step count for
    PRNGKey(0..4) on the one seed-0 hierarchy; SEMI async_multadd with
    PRNGKey(0): its whole history, grid-wait summary and every draw it
    consumed; async_smooth (southwell_exp, 8 blocks, tol 0) for 300 steps:
    its history, block_updates and draws; async_implicit_ext_bpx (fire_prob
    0.5, delay 4, 200 steps; it does not reach 1e-8 there): its history and
    draws;
  * 96^3: the sync multadd count and history, and one FULL async_multadd
    run's step count (PRNGKey(0)).
No FULL-mode draw is stored (L x n uniforms a step). The 48^3 part takes
about 8 minutes on an 8-core CPU, the 96^3 part about 5 and a few GB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
OUT = os.path.join(ROOT, "tools", "torch_async_reference.json")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, choices=(48, 96), default=None)
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from amg_tpu import native_backend
    from amg_tpu.problems import laplacian_3d_27pt
    from amg_tpu.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu.smooth import SmootherType
    from amg_tpu.solve import CycleConfig, CycleType, solve
    from amg_tpu.solve.accel import estimate_cycle_eigs
    from amg_tpu.solve.async_sim import AsyncConfig, async_solve
    from amg_tpu.solve.async_smooth import (
        AsyncSmoothConfig,
        async_smooth_solve,
        block_neighbor_mask,
    )
    from amg_tpu.solve.driver import cheby_setup
    from amg_tpu.solve.extended import build_extended_system, ext_matvec, ext_solve
    from torch_parity import JaxAsyncDraws, JaxExtDraws, JaxSmoothDraws, async_options

    if not native_backend.available():
        print("the reference's native setup library did not load", file=sys.stderr)
        return 1

    def hist(res):
        h = np.asarray(res.history)
        return h[~np.isnan(h)].tolist()

    def cfg_of(name):
        return CycleConfig(cycle=CycleType(name), smoother=SmootherType.L1_JACOBI,
                           use_smoothed_transfers=name in ("multadd", "mult_multadd"))

    def setup(n):
        prob = laplacian_3d_27pt(n)
        t0 = time.perf_counter()
        hh, hier = build_hierarchy(prob.A, HierarchyParams(), fine_stencil=prob.stencil)
        st = hh.stats()
        b = jnp.asarray(np.random.default_rng(0).random(prob.n))
        rec = {"level_n": st["n"], "level_nnz": st["nnz"],
               "setup_s": time.perf_counter() - t0}
        return prob, hh, hier, b, rec

    def sync(hier, b, name, max_cycles=200):
        cfg = cfg_of(name)
        accel = None if name == "mult_multadd" else "cheby"
        t0 = time.perf_counter()
        coeffs = cheby_setup(hier, cfg, num_iters=20) if accel else None
        res = solve(hier, cfg, b, jnp.zeros_like(b), tol=1e-8, max_cycles=max_cycles,
                    accel=accel, cheby_coeffs=coeffs)
        return {"iters": int(res.iters), "rel_res": float(res.rel_resnorm),
                "history": hist(res), "s": time.perf_counter() - t0}

    def run_async(hier, b, async_type, key):
        cfg = cfg_of("multadd")
        acfg = AsyncConfig(**async_options(hier, cfg, cheby_setup, async_type=async_type))
        t0 = time.perf_counter()
        res = async_solve(hier, cfg, acfg, b, jnp.zeros_like(b), key=jax.random.PRNGKey(key),
                          tol=1e-8, max_cycles=200)
        return res, {"iters": int(res.iters), "rel_res": float(res.rel_resnorm),
                     "grid_wait": res.grid_wait.summary(), "s": time.perf_counter() - t0}

    out = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            out = json.load(f)

    if args.only in (None, 48):
        prob, hh, hier, b, rec = setup(48)
        for name in ("multadd", "afacx", "bpx", "mult_multadd"):
            r = sync(hier, b, name)
            rec[name] = dict(r, history=r["history"][:5])
            print(name, r["iters"], r["rel_res"], flush=True)
        rec["afacj 40"] = sync(hier, b, "afacj", max_cycles=40)
        full = {}
        for key in range(5):
            _, r = run_async(hier, b, "full", key)
            full[str(key)] = r["iters"]
            print("full key", key, r["iters"], flush=True)
        rec["full richardson iters by key"] = full
        res, r = run_async(hier, b, "semi", 0)
        r["history"] = hist(res)
        r["draws"] = JaxAsyncDraws(0).record(hier.num_levels, r["iters"])
        rec["semi richardson"] = r
        print("semi", r["iters"], flush=True)

        B, steps = 8, 300
        t0 = time.perf_counter()
        sres = async_smooth_solve(
            hier.levels[0].A, hier.levels[0].sm,
            AsyncSmoothConfig(smoother=SmootherType.L1_JACOBI, num_blocks=B),
            block_neighbor_mask(prob.A, B), b, jnp.zeros_like(b),
            key=jax.random.PRNGKey(0), tol=0.0, max_cycles=steps)
        draws = JaxSmoothDraws(0)
        rec["smooth southwell_exp"] = {
            "iters": int(sres.iters), "history": hist(sres),
            "block_updates": np.asarray(sres.block_updates).tolist(),
            "draws": [draws.step(B, torch.float64, "cpu").tolist() for _ in range(steps)],
            "s": time.perf_counter() - t0,
        }
        print("smooth", sres.block_updates, flush=True)

        t0 = time.perf_counter()
        ext = build_extended_system(hh, HierarchyParams(), explicit=False)
        A0 = hier.levels[0].A
        coeffs = estimate_cycle_eigs(
            lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u),
            ext.offsets[-1], b.dtype, num_iters=20, range_start=True, operand=(ext, A0))
        eres = ext_solve(hier, ext, b, jnp.zeros_like(b), tol=1e-8, max_cycles=200,
                         cheby_coeffs=coeffs, async_fire_prob=0.5, sim_read_delay=4,
                         key=jax.random.PRNGKey(0))
        rec["async_implicit_ext_bpx"] = {
            "iters": int(eres.iters), "rel_res": float(eres.rel_resnorm),
            "history": hist(eres), "coeffs": list(coeffs), "s": time.perf_counter() - t0,
            "draws": JaxExtDraws(0).record(hier.num_levels, int(eres.iters)),
        }
        print("ext", int(eres.iters), float(eres.rel_resnorm), flush=True)
        out["48"] = rec

    if args.only in (None, 96):
        prob, hh, hier, b, rec = setup(96)
        r = sync(hier, b, "multadd")
        rec["multadd"] = dict(r, history=r["history"][:5])
        print("96 multadd", r["iters"], flush=True)
        res, r = run_async(hier, b, "full", 0)
        r["history"] = hist(res)[:5]
        rec["full richardson"] = r
        print("96 full", r["iters"], flush=True)
        out["96"] = rec

    if os.path.exists(args.out):  # the other size may have landed meanwhile
        with open(args.out) as f:
            out = dict(json.load(f), **{k: v for k, v in out.items()
                                        if k == str(args.only) or args.only is None})
    with open(args.out, "w") as f:
        json.dump(out, f, separators=(",", ":"))
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
