"""Multi-device dry run (counterpart of the row-partitioned parts of
__graft_entry__.py::dryrun_multichip): one step of every row-sharded path on
tiny shapes, held to the reference's gates.

    python -m amg_tpu_torch.utils.dryrun [n_devices] [-device cpu]

The grid (level) parallel parts of the reference's dry run (the
grid-parallel async solve, async Maxwell over AMS groups) come with ROADMAP
queue 1 item 11b.
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
      * the sharded DIA elasticity V(2,2)-cycle under PCG (the plain DIA
        form, as the reference's multi-device run keeps it): rel <= 1e-8 in
        at most 50 iterations.

    Raises AssertionError at a gate; returns the numbers and prints them on
    one line."""
    from amg_tpu_torch.dtypes import resolve_device
    from amg_tpu_torch.parallel.dist import (
        build_dist_hierarchy,
        make_row_mesh,
        pad_vector,
        shard_structured_hierarchy,
    )
    from amg_tpu_torch.parallel.halo import halo_stencil_matvec
    from amg_tpu_torch.problems import laplacian_2d_5pt, laplacian_3d_7pt
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_host_hierarchy
    from amg_tpu_torch.setup.structured import build_dia_structured_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, mult_vcycle, \
        sync_additive_cycle
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
    print(f"dryrun_multichip ok: {n_devices} shards on {device}, mult+add rel_res "
          f"{out['mult_add_rel_halo']:.4e} (halo) {out['mult_add_rel_gspmd']:.4e} (gspmd), "
          f"halo matvec err {err:.1e}, dia elasticity {out['dia_iters']} iterations "
          f"(rel {out['dia_rel']:.2e})")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("-device", default=None, help="cpu, or a CUDA device (default)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
