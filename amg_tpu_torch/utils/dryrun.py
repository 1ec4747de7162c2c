"""Multi-device dry run (counterpart of __graft_entry__.py::
dryrun_multichip): every row-sharded and grid (level) parallel path on tiny
shapes, held to the reference's gates.

    python -m amg_tpu_torch.utils.dryrun [n_devices] [-device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run, over a mesh of n_devices shards on `device` (None: the CUDA
    device; raises without one):

      * one MULT V-cycle then one smoothed-transfer MULTADD cycle on the
        5-point 16^2 problem's distributed hierarchy, in both comm modes:
        the relative residual inside the reference's pinned band
        0.05 < rel < 0.09;
      * the halo stencil matvec of the 7-point (2 n_devices)^3 problem,
        equal to the single-device matvec;
      * the grid-parallel SEMI async solve of that problem's replicated
        hierarchy (smoothed MULTADD, omega 0.7, fire_prob 0.8, delay 1, the
        port's draws for seed 0): rel <= 1e-6 in 20-60 steps;
      * the sharded DIA elasticity V(2,2)-cycle under PCG (the plain DIA
        form, as the reference's multi-device run keeps it): rel <= 1e-8 in
        at most 50 iterations;
      * async Maxwell over the AMS groups (`ams_grid_parallel_solve`, n = 6,
        G and Pi): rel <= 1e-6 within 600 steps, and no shard owns 0.6 of
        the groups' operator bytes.

    Raises AssertionError at a gate; returns the numbers and prints them on
    one line."""
    from amg_tpu_torch.dtypes import resolve_device
    from amg_tpu_torch.parallel.dist import (
        build_dist_hierarchy,
        make_row_mesh,
        pad_vector,
        shard_structured_hierarchy,
    )
    from amg_tpu_torch.parallel.grid import grid_parallel_solve, plan_grid_levels
    from amg_tpu_torch.parallel.halo import halo_stencil_matvec
    from amg_tpu_torch.problems import laplacian_2d_5pt, laplacian_3d_7pt
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.setup.hierarchy import (
        HierarchyParams,
        _format_converter,
        build_host_hierarchy,
        device_hierarchy,
    )
    from amg_tpu_torch.setup.structured import build_dia_structured_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, mult_vcycle, \
        sync_additive_cycle
    from amg_tpu_torch.convert import matrix_from_arrays
    from amg_tpu_torch.solve.ams import ams_grid_parallel_solve, build_ams
    from amg_tpu_torch.solve.async_sim import AsyncConfig
    from amg_tpu_torch.solve.driver import solve

    device = resolve_device(device)
    mesh = make_row_mesh(n_devices, device)
    out = {"n_devices": n_devices, "device": str(device)}

    prob = laplacian_2d_5pt(16)
    params = HierarchyParams(smoother=SmootherType.L1_JACOBI, keep_stencil_fine=False)
    hh = build_host_hierarchy(prob.A, params)
    cfg_mult = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    cfg_add = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                          use_smoothed_transfers=True)
    b_host = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    for comm in ("halo", "gspmd"):
        hier, pad_info = build_dist_hierarchy(hh, params, mesh, comm=comm)
        b = pad_vector(b_host, pad_info, mesh)
        x = mult_vcycle(hier, cfg_mult, torch.zeros_like(b), b)
        x = sync_additive_cycle(hier, cfg_add, x, b)
        r = b - hier.levels[0].A @ x
        rel = float(mesh.norm(r) / mesh.norm(b))
        # the reference's band around the observed contraction (0.0746)
        assert 0.05 < rel < 0.09, f"dry-run step contraction drifted ({comm}): {rel}"
        out[f"mult_add_rel_{comm}"] = rel

    # grid (level) parallelism: each shard group computes only its levels'
    # corrections, one correction sum and one fused (norm, flag) pair a step
    hier_rep = device_hierarchy(hh, params, device=device)
    _, levels_of, lscale = plan_grid_levels(hh, n_devices)
    acfg = AsyncConfig(omega=0.7, fire_prob=0.8, sim_read_delay=1, async_type="semi")
    gres = grid_parallel_solve(hier_rep, cfg_add, acfg, levels_of, lscale, mesh, b_host,
                               tol=1e-6, max_cycles=200)
    assert float(gres.rel_resnorm) <= 1e-6, \
        f"grid-parallel solve did not converge: {float(gres.rel_resnorm)}"
    # the reference's band around its step count
    assert 20 <= gres.iters <= 60, f"grid-parallel iteration count drifted: {gres.iters}"
    out.update(grid_iters=gres.iters, grid_rel=float(gres.rel_resnorm))

    p3 = laplacian_3d_7pt(2 * n_devices)
    mv, coeffs = halo_stencil_matvec(p3.stencil, mesh)
    xh = torch.ones(p3.n, dtype=torch.float64)
    yh = mesh.gather(mv(mesh.shard_vector(xh), coeffs))
    want = p3.stencil @ xh
    err = float((yh.cpu() - want).abs().max())
    assert err <= 1e-13 * float(want.abs().max()), f"halo stencil matvec differs by {err}"
    out["halo_matvec_err"] = err

    pe = elasticity_beam(nx=2 * n_devices - 1, ny=4, nz=4, bc="identity")
    _, hier_e = build_dia_structured_hierarchy(
        pe.A, (2 * n_devices, 5, 5), num_functions=3, use_kernel=False,
        max_coarse_size=64, device=device)
    hier_e = shard_structured_hierarchy(hier_e, mesh)
    cfg_e = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
                        num_pre_sweeps=2, num_post_sweeps=2)
    be = torch.from_numpy(np.asarray(pe.rhs) / np.linalg.norm(pe.rhs))
    eres = solve(hier_e, cfg_e, be, tol=1e-8, max_cycles=80, outer="pcg", device=device)
    assert float(eres.rel_resnorm) <= 1e-8, \
        f"sharded DIA elasticity did not converge: {float(eres.rel_resnorm)}"
    assert int(eres.iters) <= 50, f"sharded DIA elasticity iteration count drifted: {eres.iters}"
    out.update(dia_iters=int(eres.iters), dia_rel=float(eres.rel_resnorm))

    # async Maxwell over the AMS groups, owned operator storage
    pmx = maxwell_curlcurl(n=6)
    ams_d, _ = build_ams(pmx.A, pmx.aux["G"], Pi=pmx.aux["Pi"], device=device)
    A_mx = matrix_from_arrays(_format_converter(params)(pmx.A), params.dtype, device)
    b_mx = torch.from_numpy(np.asarray(pmx.rhs) / np.linalg.norm(pmx.rhs))
    mres, owned = ams_grid_parallel_solve(A_mx, ams_d, mesh, b_mx, tol=1e-6, max_cycles=600)
    assert float(mres.rel_resnorm) <= 1e-6, \
        f"grid-parallel async Maxwell did not converge: {float(mres.rel_resnorm)}"
    assert max(owned) < 0.6 * sum(owned), "AMS owned storage not split"
    out.update(ams_iters=int(mres.iters), ams_rel=float(mres.rel_resnorm),
               ams_owned_bytes=list(owned))
    print(f"dryrun_multichip ok: {n_devices} shards on {device}, mult+add rel_res "
          f"{out['mult_add_rel_halo']:.4e} (halo) {out['mult_add_rel_gspmd']:.4e} (gspmd), "
          f"halo matvec err {err:.1e}, grid-parallel {out['grid_iters']} steps (rel "
          f"{out['grid_rel']:.2e}), dia elasticity {out['dia_iters']} iterations "
          f"(rel {out['dia_rel']:.2e}), async Maxwell {out['ams_iters']} steps (rel "
          f"{out['ams_rel']:.2e}, max owned {max(owned)} of {sum(owned)} bytes)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("-device", default=None, help="cpu, or a CUDA device (default)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
