"""Rules of the PyTorch port that hold by construction: it imports neither
JAX nor the JAX package, and its entry points never fall back to the CPU
silently (device=None means CUDA, and raises where there is none)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import amg_tpu_torch
from amg_tpu_torch.ops import stencil as ts

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)

PKG = Path(amg_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


def test_importing_every_module_loads_no_jax():
    code = (
        "import pkgutil, sys, amg_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(amg_tpu_torch.__path__, 'amg_tpu_torch.')]\n"
        "for n in names: __import__(n)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'amg_tpu'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


# an import of JAX, or any mention of a module of the JAX package (the port's
# own name is removed from each line first)
_FORBIDDEN = re.compile(r"\bimport jax|\bfrom jax|\bamg_tpu\.|\bfrom amg_tpu |\bimport amg_tpu\b")


def test_no_source_file_names_jax_or_the_jax_package():
    hits = []
    for path in sorted(PKG.rglob("*")):
        if path.suffix not in (".py", ".cu", ".cuh", ".cpp") or "_build" in path.parts:
            continue
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if _FORBIDDEN.search(line.replace("amg_tpu_torch", "")):
                hits.append(f"{path.relative_to(ROOT)}:{lineno}: {line.strip()}")
    assert not hits, "\n".join(hits)
    assert _FORBIDDEN.search("from amg_tpu.sparse.csr import CSRMatrix")
    assert not _FORBIDDEN.search("from amg_tpu_torch.sparse.csr import x".replace("amg_tpu_torch", ""))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.structured import build_structured_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.struct_cycle import struct_solve, struct_timed_cycles

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = laplacian_3d_27pt(12)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_structured_hierarchy(prob.stencil)
    hh, hier = build_structured_hierarchy(prob.stencil, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hierarchy_from_arrays(*hh.arrays)
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        struct_solve(hier, CycleConfig(), b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        struct_timed_cycles(hier, CycleConfig(), b, 2)
    # the explicit CPU request runs the plain path
    assert struct_solve(hier, CycleConfig(), b, device="cpu").iters > 0


def test_generic_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy, device_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import cheby_setup, solve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = laplacian_3d_27pt(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hierarchy(prob.A, fine_stencil=prob.stencil)
    hh, hier = build_hierarchy(prob.A, fine_stencil=prob.stencil, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_hierarchy(hh, HierarchyParams())
    assert device_hierarchy(hh, HierarchyParams(), device="cpu").device.type == "cpu"
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(hier, CycleConfig(), b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cheby_setup(hier, CycleConfig())
    with pytest.raises(ValueError, match="hierarchy lives on"):
        solve(hier, CycleConfig(), b, device="meta")
    # the explicit CPU request runs the plain path
    assert solve(hier, CycleConfig(), b, device="cpu").iters > 0
    assert cheby_setup(hier, CycleConfig(), num_iters=3, device="cpu").beta > 0


def test_native_setup_raises_when_it_cannot_be_built(monkeypatch, tmp_path):
    """The port's "hmis" is the native library's algorithm, never a silent
    numpy fallback: without a compiler it raises."""
    import scipy.sparse as sp

    from amg_tpu_torch import native_backend as nb
    from amg_tpu_torch.setup.coarsen import COARSENING

    monkeypatch.setattr(nb, "_lib", None)
    monkeypatch.setattr(nb, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    S = sp.csr_matrix(np.eye(4, k=1) + np.eye(4, k=-1))
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        COARSENING["hmis"](S)
    assert not list(tmp_path.glob("*.so"))


def test_a_hierarchy_on_another_device_is_refused():
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.structured import build_structured_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.struct_cycle import struct_solve

    prob = laplacian_3d_27pt(12)
    _, hier = build_structured_hierarchy(prob.stencil, device="cpu")
    with pytest.raises(ValueError, match="hierarchy lives on"):
        struct_solve(hier, CycleConfig(), torch.zeros(prob.n), device="meta")


def test_kernel_wrappers_take_no_other_device():
    """Only a CPU tensor gets the plain version: any other device launches
    the kernel or raises."""
    gs = (4, 4, 4)
    u = torch.zeros(ts.padded_shape(gs), device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported device"):
        ts.stencil_kernel_padded(u, u, (1.0,), gs, ((0, 0, 0),), mode="residual")


def test_async_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
    from amg_tpu_torch.solve.async_smooth import (
        AsyncSmoothConfig,
        async_smooth_solve,
        block_neighbor_mask,
    )
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
    from amg_tpu_torch.solve.extended import build_extended_system, ext_solve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = laplacian_3d_27pt(8)
    hh, hier = build_hierarchy(prob.A, fine_stencil=prob.stencil, device="cpu")
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    cfg = CycleConfig(cycle=CycleType.MULTADD)
    lv = hier.levels[0]
    nbr = block_neighbor_mask(prob.A, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        async_solve(hier, cfg, AsyncConfig(), b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        async_smooth_solve(lv.A, lv.sm, AsyncSmoothConfig(num_blocks=4), nbr, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_extended_system(hh, HierarchyParams())
    ext = build_extended_system(hh, HierarchyParams(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ext_solve(hier, ext, b)
    with pytest.raises(ValueError, match="lives on"):
        async_solve(hier, cfg, AsyncConfig(), b, device="meta")
    with pytest.raises(ValueError, match="lives on"):
        async_smooth_solve(lv.A, lv.sm, AsyncSmoothConfig(num_blocks=4), nbr, b,
                           device="meta")
    # the explicit CPU request runs the plain path
    assert async_solve(hier, cfg, AsyncConfig(), b, max_cycles=3, device="cpu").iters == 3
    assert async_smooth_solve(lv.A, lv.sm, AsyncSmoothConfig(num_blocks=4), nbr, b,
                              max_cycles=3, device="cpu").iters == 3
    assert ext_solve(hier, ext, b, max_cycles=3, device="cpu").iters == 3


def test_sa_ams_and_mixed_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amg_tpu_torch.convert import ams_from_arrays, matrix_from_arrays
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, _format_converter, build_hierarchy
    from amg_tpu_torch.solve.ams import ams_async_additive_solve, build_ams, solve_ams_pcg
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.mixed import mixed_solve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    beam = elasticity_beam(nx=16, ny=4)
    sa = HierarchyParams(num_functions=2, setup_type="sa")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hierarchy(beam.A, sa, near_nullspace=beam.near_nullspace)
    assert build_hierarchy(beam.A, sa, near_nullspace=beam.near_nullspace,
                           device="cpu")[1].device.type == "cpu"

    mx = maxwell_curlcurl(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_ams(mx.A, mx.aux["G"], Pi=mx.aux["Pi"])
    ams, cfg = build_ams(mx.A, mx.aux["G"], Pi=mx.aux["Pi"], device="cpu")
    A = matrix_from_arrays(_format_converter(HierarchyParams())(mx.A), torch.float64, "cpu")
    b = np.random.default_rng(0).random(mx.n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_ams_pcg(A, ams, cfg, b)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ams_async_additive_solve(A, ams, b)
    with pytest.raises(ValueError, match="lives on"):
        solve_ams_pcg(A, ams, cfg, b, device="meta")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ams_from_arrays({})
    assert solve_ams_pcg(A, ams, cfg, b, device="cpu").iters > 0
    assert ams_async_additive_solve(A, ams, b, max_cycles=3, device="cpu").iters == 3

    lap = laplacian_3d_27pt(8)
    _, hier = build_hierarchy(lap.A, HierarchyParams(dtype=torch.float32),
                              fine_stencil=lap.stencil, device="cpu")
    b = np.random.default_rng(0).random(lap.n)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mixed_solve(hier, lap.stencil, CycleConfig(), b)
    with pytest.raises(ValueError, match="hierarchy lives on"):
        mixed_solve(hier, lap.stencil, CycleConfig(), b, device="meta")
    assert mixed_solve(hier, lap.stencil, CycleConfig(), b, max_cycles=2, device="cpu").iters == 2


def test_driver_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amg_tpu_torch.utils import cli
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment, setup_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_experiment(SolverOptions(problem="5pt", n=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        setup_experiment(SolverOptions(problem="5pt", n=8))
    # the CLI's default -device is "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-problem", "5pt", "-n", "8"])
    assert cli.main(["-problem", "5pt", "-n", "8", "-oneline_output", "-device", "cpu"]) == 0
    assert run_experiment(SolverOptions(problem="5pt", n=8), device="cpu").cycles > 0


@pytest.mark.parametrize("opts,err,match", [
    # every multi-device branch runs (test_torch_parallel.py, test_torch_grid.py);
    # the grid solve refuses what the reference's asserts against: coalesced
    # publishes of stale residual reads
    ({"num_devices": 8, "solver": "async_multadd", "async_comm_save_divisor": 2,
      "read_type": "res"}, ValueError, "comm_every"),
    ({"device_format": "bsr"}, ValueError, "Not ported"),
], ids=["grid", "bsr"])
def test_the_runner_refuses_what_is_not_ported(opts, err, match):
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    with pytest.raises(err, match=match):
        run_experiment(SolverOptions(problem="5pt", n=8, **opts), device="cpu")


def test_the_driver_modules_load_no_jax():
    code = (
        "import sys\n"
        "import amg_tpu_torch.utils.cli, amg_tpu_torch.utils.runner\n"
        "import amg_tpu_torch.utils.phases, amg_tpu_torch.utils.checkpoint\n"
        "import amg_tpu_torch.problems.amr, amg_tpu_torch.problems.io\n"
        "from amg_tpu_torch.problems import difconv_3d, vardifconv_3d\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'amg_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_the_struct_branch_needs_the_card_and_a_constant_stencil():
    """ROADMAP F10: the fused structured solve runs on the CUDA device with a
    constant-stencil level 0 only; a DIA level 0 (vardifconv on the
    structured hierarchy) takes the generic cycle. A pure predicate: no card
    is needed to ask it."""
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt, vardifconv_3d
    from amg_tpu_torch.setup.structured import DiaKernelOperator, csr_to_dia_stencil
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import takes_struct_solve

    stencil = laplacian_3d_27pt(6).stencil
    vd = vardifconv_3d(6)
    dia = DiaKernelOperator.from_var_stencil(csr_to_dia_stencil(vd.A, vd.grid_shape))
    opts = SolverOptions(hierarchy="structured").fixup()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    l1, jgs = SmootherType.L1_JACOBI, SmootherType.HYBRID_JGS
    assert takes_struct_solve(opts, l1, cuda, stencil)
    assert takes_struct_solve(opts, SmootherType.JACOBI, cuda, stencil)
    assert not takes_struct_solve(opts, l1, cuda, dia)
    assert not takes_struct_solve(opts, l1, cpu, stencil)
    assert not takes_struct_solve(opts, jgs, cuda, stencil)
    for other in (dict(solver="multadd"), dict(mixed_precision=True), dict(accel="cheby"),
                  dict(outer_solver="pcg"), dict(hierarchy="algebraic")):
        o = SolverOptions(**dict(dict(hierarchy="structured"), **other)).fixup()
        assert not takes_struct_solve(o, l1, cuda, stencil), other


def test_the_parallel_modules_load_no_jax():
    code = (
        "import sys\n"
        "import amg_tpu_torch.parallel, amg_tpu_torch.utils.dryrun\n"
        "from amg_tpu_torch.parallel import dist, grid, halo, multihost, partition, spcomm\n"
        "from amg_tpu_torch.solve.ams import build_sharded_ams, solve_sharded_ams_pcg\n"
        "from amg_tpu_torch.solve.ams import ams_grid_parallel_solve, plan_ams_groups\n"
        "from amg_tpu_torch.solve.extended import build_sharded_extended_system\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'amg_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_parallel_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from amg_tpu_torch.parallel import init_multihost, make_row_mesh
    from amg_tpu_torch.utils.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_row_mesh(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_multihost("localhost:1", 1, 0)
    mesh = make_row_mesh(8, "cpu")
    assert (mesh.n_devices, mesh.local_devices, mesh.world_size) == (8, 8, 1)
    assert mesh.device == torch.device("cpu")
    with pytest.raises(ValueError, match="does not split"):
        make_row_mesh(0, "cpu")


def test_init_multihost_picks_nccl_for_cuda_and_gloo_for_the_cpu():
    import socket

    from amg_tpu_torch.parallel import global_mesh_info, init_multihost, make_row_mesh
    from amg_tpu_torch.parallel.multihost import process_group_backend

    assert process_group_backend("cuda") == process_group_backend(torch.device("cuda", 1)) \
        == "nccl"
    assert process_group_backend("cpu") == "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    assert init_multihost(f"localhost:{port}", 1, 0, device="cpu") == torch.device("cpu")
    try:
        assert torch.distributed.get_backend() == "gloo"
        mesh = make_row_mesh(4, "cpu")
        assert global_mesh_info(mesh) == {"process_index": 0, "process_count": 1,
                                          "local_devices": 4, "global_devices": 4,
                                          "device": "cpu"}
        assert mesh.group is None  # one process: nothing crosses
    finally:
        torch.distributed.destroy_process_group()


def test_the_one_process_routes_raise_across_processes():
    """The routes that once raised across processes (comm="gspmd", the
    block smoothers, the sharded structured hierarchy, the grid-mapped
    extended system) now build for the first of two processes without a
    collective and keep only its shards' part; nothing raises for them.
    (tests/test_torch_multiprocess.py runs them across two processes.)"""
    from amg_tpu_torch.parallel.dist import (
        GatheredOperator,
        RowMesh,
        RowShardedMatrix,
        build_dist_hierarchy,
        shard_structured_hierarchy,
    )
    from amg_tpu_torch.parallel.halo import HaloStencilOperator, SlabTransfer
    from amg_tpu_torch.problems.laplacian import laplacian_2d_5pt, laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_host_hierarchy
    from amg_tpu_torch.setup.structured import build_structured_hierarchy
    from amg_tpu_torch.smooth.smoothers import ShardedBlockInverse, SmootherType
    from amg_tpu_torch.solve.extended import build_sharded_extended_system

    # the first of two processes: no collective runs while building (the
    # mesh has no process group)
    mesh = RowMesh(n_devices=8, device=torch.device("cpu"), rank=0, world_size=2)
    prob = laplacian_2d_5pt(16)
    params = HierarchyParams(keep_stencil_fine=False)
    hh = build_host_hierarchy(prob.A, params)
    hier_g, info = build_dist_hierarchy(hh, params, mesh, comm="gspmd")
    for lv in hier_g.levels:  # each level's first half of the rows
        assert isinstance(lv.A, RowShardedMatrix)
        assert lv.A.local.n_rows == lv.A.shape[0] // 2
        assert lv.sm.scale.shape == (lv.A.shape[0] // 2,)
    assert isinstance(hier_g.coarse_Ainv, GatheredOperator)
    hier_j, _ = build_dist_hierarchy(hh, HierarchyParams(keep_stencil_fine=False,
                                                         smoother=SmootherType.HYBRID_JGS),
                                     mesh, comm="halo")
    sm0 = hier_j.levels[0].sm
    n0 = hier_j.levels[0].A.shape[0]
    assert isinstance(sm0.block_inv, ShardedBlockInverse)
    # all the 128-row blocks of the global rows, of which it keeps rows
    # [0, n0 / 2)
    assert sm0.block_inv.rows == slice(0, n0 // 2)
    assert sm0.block_inv.blocks.shape[0] == -(-n0 // 128)
    _, hier_s = build_structured_hierarchy(laplacian_3d_27pt(16).stencil,
                                           max_coarse_size=8, device="cpu")
    hier_s = shard_structured_hierarchy(hier_s, mesh)
    lv0, lv1, lv2 = hier_s.levels
    assert isinstance(lv0.A, HaloStencilOperator) and isinstance(lv1.A, HaloStencilOperator)
    assert isinstance(lv0.R, SlabTransfer) and isinstance(lv0.P, SlabTransfer)
    assert isinstance(lv1.R, GatheredOperator) and isinstance(lv2.A, GatheredOperator)
    assert lv0.sm.scale.shape == (16 ** 3 // 2,)
    hier_h, info = build_dist_hierarchy(hh, params, mesh, comm="halo")
    assert hier_h.levels[0].A.vals.shape[0] == 4  # its own 4 shards
    assert hier_h.levels[0].sm.scale.shape == (info[1] // 2,)
    with pytest.raises(ValueError, match="unknown comm"):
        build_dist_hierarchy(hh, params, mesh, comm="mpi")
    ext = build_sharded_extended_system(hh, params, mesh)
    assert ext.AA.vals.shape[0] == 4 and ext.mesh is mesh
    assert ext.inv_wdiag.shape == (ext.offsets[-1] // 2,)
