#!/usr/bin/env python3
"""Whether each plane-split piece of the structured hierarchy computes, in
each process of a 2-process split, its rows of the global operator bit for
bit, on one device (no process group: the neighbour planes are handed over
as the exchange would hand them).

    python3 tools/torch_plane_split_probe.py [--device cuda:0] [--small]

For the 27-point 126^3 structured hierarchy (the runner's set-up, float64
and float32) and the identity-BC beam 143x18x18 under -mixed_precision (the
float32 level 0 and the float64 outer operator), each level whose leading
axis splits over 8 shards: the plane halo in the global expression
(`parallel.halo.make_structured_halo`, which must be equal) and in the
reference's halo order (`make_halo_stencil`, printed beside it), and the
slab transfers between two plane-split levels (`SlabTransfer`, which must
be equal). `--small` takes 16^3 and the 15x4x4 beam (the CPU). Exits 1
where a piece that must be equal is not.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.parallel.dist import RowMesh, structured_layout
    from amg_tpu_torch.parallel.halo import SlabTransfer, make_halo_stencil, make_structured_halo
    from amg_tpu_torch.setup.structured import MaskedTransfer
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import setup_experiment

    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    fails = []
    glob = {}

    def mesh_for(rank):
        """Process `rank` of 2 over 8 shards; its exchange reads the planes
        next to its half of glob["grid"]."""
        mesh = RowMesh(n_devices=8, device=dev, rank=rank, world_size=2)

        def send_recv(sends, recvs):
            g = glob["grid"]
            half = g.shape[0] // 2
            for t, src, _ in recvs:
                t.copy_(g[half - 1: half] if src < rank else g[half: half + 1])

        mesh.send_recv = send_recv
        return mesh

    def rows(v, rank):
        n = v.shape[0] // 2
        return v[rank * n:(rank + 1) * n]

    def check_op(label, A, x):
        want = A @ x
        glob["grid"] = x.view(A.grid_shape)
        for rank in (0, 1):
            for name, make in (("global order", make_structured_halo),
                               ("reference's halo order", make_halo_stencil)):
                got = make(A, mesh_for(rank)) @ rows(x, rank)
                eq = torch.equal(got, rows(want, rank))
                print(f"  {label}, rank {rank}, {name}: equal {eq}, max |d| "
                      f"{(got - rows(want, rank)).abs().max().item():.3e}", flush=True)
                if make is make_structured_halo and not eq:
                    fails.append(f"{label} rank {rank}")

    def check_transfer(label, T, src_shape, x):
        inner = T.inner if isinstance(T, MaskedTransfer) else T
        want = inner @ x
        glob["grid"] = x.view(src_shape)
        for rank in (0, 1):
            slab = SlabTransfer.of(inner, mesh_for(rank))
            got = slab @ rows(x, rank)
            eq = torch.equal(got, rows(want, rank))
            print(f"  {label}, rank {rank}, slab: equal {eq}, max |d| "
                  f"{(got - rows(want, rank)).abs().max().item():.3e}", flush=True)
            if not eq:
                fails.append(f"{label} rank {rank}")

    side = 16 if args.small else 126
    t0 = time.perf_counter()
    exp = setup_experiment(SolverOptions(problem="27pt", n=side, hierarchy="structured",
                                         only_setup=True), "cpu")
    print(f"27-point {side}^3 structured set-up: {time.perf_counter() - t0:.1f} s")
    mesh0 = RowMesh(n_devices=8, device=dev, rank=0, world_size=2)
    for dtype in (torch.float64, torch.float32):
        hier = hierarchy_from_arrays(*exp.hh.arrays, dtype=dtype, device=dev)
        lay = [structured_layout(lv.A, mesh0) for lv in hier.levels]
        print(f"{side}^3 {dtype}: layouts {lay}")
        rng = np.random.default_rng(0)
        for k, lv in enumerate(hier.levels):
            if lay[k] != "planes":
                continue
            x = torch.from_numpy(rng.random(lv.A.shape[0])).to(dev, dtype)
            check_op(f"{dtype} level {k} {lv.A.grid_shape}", lv.A, x)
            if k + 1 < len(lay) and lay[k + 1] == "planes":
                check_transfer(f"{dtype} level {k} R", lv.R, lv.A.grid_shape, x)
                cs = hier.levels[k + 1].A
                xc = torch.from_numpy(rng.random(cs.shape[0])).to(dev, dtype)
                check_transfer(f"{dtype} level {k} P", lv.P, cs.grid_shape, xc)
    del exp
    nx, ny = (15, 4) if args.small else (143, 18)
    t0 = time.perf_counter()
    exp = setup_experiment(SolverOptions(problem="elasticity", nx=nx, ny=ny, nz=ny,
                                         elast_bc="identity", hierarchy="structured",
                                         mixed_precision=True, num_devices=8,
                                         only_setup=True), dev)
    print(f"beam {nx}x{ny}x{ny} ({exp.prob.n} dofs) set-up: {time.perf_counter() - t0:.1f} s; "
          f"layouts {[structured_layout(lv.A, mesh0) for lv in exp.hier.levels]}")
    x = torch.from_numpy(np.random.default_rng(1).random(exp.prob.n))
    check_op("beam level 0, float32", exp.hier.levels[0].A, x.to(dev, torch.float32))
    check_op("beam outer operator, float64", exp.A_acc, x.to(dev, torch.float64))
    print("not equal:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
