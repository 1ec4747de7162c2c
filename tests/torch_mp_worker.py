"""Multi-process worker of tests/test_torch_multiprocess.py.

Runs in N processes joined by a gloo process group (init_multihost on the
CPU), each owning 8 / N shards of one 8-shard row mesh, and drives across
the process boundary:

  1. golden config7 (27-point 12^3, MULT, comm "halo") through the port's
     run_experiment: halo V-cycles, the replicated coarse inverse on the
     gathered coarse vector, all-reduced norms;
  2. the exchange modes one by one on config7's padded matrix: HaloELL in
     ppermute and all_to_all mode and HaloBSR, and the halo stencil's plane
     exchange on the 7-point 16^3 grid;
  3. the sharded AMS-PCG on the Maxwell n = 6 mesh (all-reduced dots).

Prints one "RESULT <json>" line (global vectors gathered); the parent test
compares it with the one-process run.
"""

import json
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from amg_tpu_torch.parallel import (
        build_halo_bsr,
        build_halo_ell,
        global_mesh_info,
        init_multihost,
        make_row_mesh,
    )
    from amg_tpu_torch.parallel.dist import _pad_csr
    from amg_tpu_torch.parallel.halo import halo_stencil_matvec
    from amg_tpu_torch.problems import laplacian_3d_7pt, laplacian_3d_27pt
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.solve.ams import build_sharded_ams, solve_sharded_ams_pcg
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    init_multihost(f"localhost:{port}", nproc, pid, device="cpu")
    mesh = make_row_mesh(8, "cpu")
    info = global_mesh_info(mesh)
    assert info["process_count"] == nproc and info["local_devices"] == 8 // nproc, info

    opts = SolverOptions(problem="27pt", n=12, solver="mult", num_devices=8, comm="halo",
                         device_format="ell")
    st = run_experiment(opts, device="cpu")

    prob = laplacian_3d_27pt(12)
    A = _pad_csr(prob.A, prob.n, prob.n, unit_diag_from=prob.n)
    x = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    xl = mesh.shard_vector(x)
    ys = {
        "ppermute": build_halo_ell(A, mesh),
        "all_to_all": build_halo_ell(A, mesh, max_ppermute_offsets=0),
        "bsr": build_halo_bsr(A, mesh, bm=8, bn=8),
    }
    ys = {k: mesh.gather(a @ xl).tolist() for k, a in ys.items()}
    p7 = laplacian_3d_7pt(16)  # two planes a shard
    mv, coeffs = halo_stencil_matvec(p7.stencil, mesh)
    x7 = torch.from_numpy(np.random.default_rng(1).random(p7.n))
    ys["stencil"] = mesh.gather(mv(mesh.shard_vector(x7), coeffs)).tolist()

    pmx = maxwell_curlcurl(n=6)
    A_h, ams, cfg, pad_e, _ = build_sharded_ams(pmx.A, pmx.aux["G"], mesh, Pi=pmx.aux["Pi"])
    mres = solve_sharded_ams_pcg(A_h, ams, cfg, torch.from_numpy(np.asarray(pmx.rhs)), mesh,
                                 pad_e, tol=1e-8)
    print("RESULT " + json.dumps({
        "pid": pid, "cycles": st.cycles, "history": st.history, "x": st.x.tolist(),
        "level_n": st.level_n, "y": ys,
        "ams_iters": int(mres.iters), "ams_x": mres.x.tolist(),
    }), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
