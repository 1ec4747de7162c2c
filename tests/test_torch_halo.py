"""The port's halo stencil (amg_tpu_torch/parallel/halo.py) against the JAX
package's on the CPU in float64, over an 8-shard mesh: the plane-exchange
matvec and the fused Jacobi sweep equal the reference's halo versions and
the single-device stencil to 1e-13 (the reference's own tolerance,
tests/test_halo.py), on constant and variable stencils; the reference's
operator carries across; and the runner's distributed one-level async
smoothing replays the reference's run (its draws, tests/torch_parity.py)
step for step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.parallel import make_row_mesh as r_mesh
from amg_tpu.parallel import halo as rhalo
from amg_tpu.parallel.dist import shard_vector as r_shard
from amg_tpu.problems import laplacian_3d_7pt as r7, laplacian_3d_27pt as r27
from amg_tpu.setup.structured import build_structured_hierarchy as r_structured
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu_torch.convert import halo_from_arrays
from amg_tpu_torch.parallel import make_row_mesh
from amg_tpu_torch.parallel import halo as phalo
from amg_tpu_torch.parallel.dist import RowMesh
from amg_tpu_torch.parallel.spcomm import comm_trace
from amg_tpu_torch.problems import laplacian_3d_7pt as p7, laplacian_3d_27pt as p27
from amg_tpu_torch.setup.structured import build_structured_hierarchy as p_structured
from amg_tpu_torch.smooth.smoothers import SmootherType
from torch_parity import JaxSmoothDraws, halo_arrays

torch.set_num_threads(1)

TOL = dict(rtol=1e-13, atol=1e-13)
GENS = {"7pt": (r7, p7), "27pt": (r27, p27)}


@pytest.fixture(scope="module")
def meshes():
    return r_mesh(8), make_row_mesh(8, "cpu")


def _x(n, seed=0):
    return np.random.default_rng(seed).random(n)


@pytest.mark.parametrize("gen", list(GENS))
def test_halo_matvec_equals_the_reference(meshes, gen):
    rgen, pgen = GENS[gen]
    rprob, pprob = rgen(16), pgen(16)
    x = _x(rprob.n)
    mv, coeffs = rhalo.halo_stencil_matvec(rprob.stencil, meshes[0])
    want = np.asarray(mv(r_shard(jnp.asarray(x), meshes[0]), coeffs))
    pmv, pcoeffs = phalo.halo_stencil_matvec(pprob.stencil, meshes[1])
    got = pmv(torch.from_numpy(x), pcoeffs).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, (pprob.stencil @ torch.from_numpy(x)).numpy(), **TOL)


def test_halo_matvec_constant_vector_probe(meshes):
    """A @ 1 reaches every halo plane: the dense row sums."""
    prob = p7(16)
    mv, coeffs = phalo.halo_stencil_matvec(prob.stencil, meshes[1])
    got = mv(torch.ones(prob.n, dtype=torch.float64), coeffs).numpy()
    np.testing.assert_allclose(got, prob.A.to_scipy() @ np.ones(prob.n), rtol=1e-13)


def test_halo_var_stencil_equals_the_reference(meshes):
    """The structured hierarchy's coarse level (a VarStencilOperator)."""
    _, rh = r_structured(r27(16).stencil, smoother=RSm.L1_JACOBI)
    _, ph = p_structured(p27(16).stencil, smoother=SmootherType.L1_JACOBI, device="cpu")
    A1r, A1p = rh.levels[1].A, ph.levels[1].A
    x = _x(A1p.n_rows, 1)
    mv, coeffs = rhalo.halo_stencil_matvec(A1r, meshes[0])
    want = np.asarray(mv(r_shard(jnp.asarray(x), meshes[0]), coeffs))
    pmv, pcoeffs = phalo.halo_stencil_matvec(A1p, meshes[1])
    got = pmv(torch.from_numpy(x), pcoeffs).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, (A1p @ torch.from_numpy(x)).numpy(), **TOL)


def test_halo_jacobi_sweep_equals_the_reference(meshes):
    rprob, pprob = r27(16), p27(16)
    rng = np.random.default_rng(2)
    u, b = rng.random(rprob.n), rng.random(rprob.n)
    iw = (2.0 / 3.0) / np.asarray(rprob.stencil.diagonal())
    sweep, coeffs = rhalo.halo_jacobi_sweep(rprob.stencil, meshes[0], iw)
    want = np.asarray(sweep(*(r_shard(jnp.asarray(v), meshes[0]) for v in (u, b, iw)), coeffs))
    psweep, pcoeffs = phalo.halo_jacobi_sweep(pprob.stencil, meshes[1])
    got = psweep(*(torch.from_numpy(v) for v in (u, b, iw)), pcoeffs).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_halo_stencil_operator_carries_across(meshes):
    rprob, pprob = r27(16), p27(16)
    want = rhalo.make_halo_stencil(rprob.stencil, meshes[0])
    got = halo_from_arrays(halo_arrays(want), meshes[1])
    own = phalo.make_halo_stencil(pprob.stencil, meshes[1])
    assert isinstance(got, phalo.HaloStencilOperator) and got.shape == own.shape
    x = _x(rprob.n, 3)
    w = np.asarray(want @ r_shard(jnp.asarray(x), meshes[0]))
    for op in (got, own):
        np.testing.assert_allclose((op @ torch.from_numpy(x)).numpy(), w, **TOL)
    np.testing.assert_array_equal(own.diagonal().numpy(), np.asarray(rprob.stencil.diagonal()))
    with comm_trace(meshes[1]) as log:
        own @ torch.from_numpy(x)
    # two planes of 16^2 doubles a shard, one at each end of the grid
    assert log == [round(2 * 7 * 256 * 8 / 8)]


def test_halo_stencil_refuses_what_does_not_split(meshes):
    with pytest.raises(ValueError, match="does not divide"):
        phalo.halo_stencil_matvec(p7(12).stencil, meshes[1])


def test_runner_async_smooth_distributed_replays_the_reference():
    """The runner's distributed one-level async smoothing (the plane-exchange
    operator per sweep) under the reference's draws: its steps and history."""
    from amg_tpu.utils.config import SolverOptions as RSolverOptions
    from amg_tpu.utils.runner import run_experiment as r_run
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    kw = dict(problem="7pt", n=16, solver="async_smooth", num_devices=8, tol=1e-4,
              num_cycles=4000)
    # the reference's jitted loop takes its halo operator as a pytree whose
    # metadata holds arrays, so a second caller in the same process (its
    # own tests/test_halo.py runs this path) meets a cached entry whose
    # metadata it cannot compare: run it with no cached trace and leave none
    jax.clear_caches()
    try:
        want = r_run(RSolverOptions(**kw))
    finally:
        jax.clear_caches()
    got = run_experiment(SolverOptions(**kw), device="cpu", draws=JaxSmoothDraws(0))
    assert got.cycles == want.cycles and got.rel_resnorm <= 1e-4
    np.testing.assert_allclose(got.history, want.history, rtol=1e-10, atol=1e-14)


def test_the_halo_form_of_an_interleaved_dia_operator():
    """The plane halo of a variable stencil whose taps reach further than
    one along its non-leading axes (the interleaved elasticity operator:
    99 diagonals, reach 5 along the component axis) equals its global
    matvec, each shard padded by the taps' reach on every axis."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.structured import csr_to_dia_stencil

    prob = elasticity_beam(15, 4, 4, bc="identity")
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape)
    assert max(abs(o[-1]) for o in vs.offsets) > 1 and prob.grid_shape[0] % 8 == 0
    mesh = make_row_mesh(8, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).random(prob.n))
    got = phalo.make_halo_stencil(vs, mesh) @ x
    torch.testing.assert_close(got, vs @ x, rtol=1e-13, atol=1e-13)


def _beam_dia():
    """The identity-BC elasticity beam 15x4x4's interleaved DIA operator
    (reach 5 along its component axis), 16 node planes."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.structured import csr_to_dia_stencil

    prob = elasticity_beam(15, 4, 4, bc="identity")
    return csr_to_dia_stencil(prob.A, prob.grid_shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("op", ["27pt stencil", "beam dia"])
def test_the_structured_halo_is_the_global_operator_bit_for_bit(meshes, op, dtype):
    """The structured hierarchy's plane-split form (`make_structured_halo`)
    computes each row in the global operator's expression over the haloed
    slab (every tap in list order): bit-equal to A @ x in both dtypes, on
    the 27-point 16^3 stencil and the beam's DIA operator, for one process
    holding the 8 shards and for each of two processes holding 4 (their
    neighbour planes handed over as the exchange would). The runner's halo
    form keeps the reference's interior / up / down order, which rounds
    differently in float32."""
    from amg_tpu_torch.setup.structured import VarStencilOperator
    from amg_tpu_torch.sparse.stencil import StencilOperator

    mesh = meshes[1]
    if op == "beam dia":
        vs = _beam_dia()
        assert max(abs(o[-1]) for o in vs.offsets) == 5
        A = VarStencilOperator(coeffs=vs.coeffs.to(dtype), offsets=vs.offsets,
                               grid_shape=vs.grid_shape)
    else:
        st = p27(16).stencil
        A = StencilOperator(weights=st.weights.to(dtype), offsets=st.offsets,
                            grid_shape=st.grid_shape)
    x = torch.from_numpy(_x(A.n_rows, 7)).to(dtype)
    want = A @ x
    assert torch.equal(phalo.make_structured_halo(A, mesh) @ x, want)
    if op == "27pt stencil" and dtype == torch.float32:
        assert not torch.equal(phalo.make_halo_stencil(A, mesh) @ x, want)
    grid = x.view(A.grid_shape)
    half = A.grid_shape[0] // 2
    for rank in (0, 1):
        pm = RowMesh(n_devices=8, device=torch.device("cpu"), rank=rank, world_size=2)

        def send_recv(sends, recvs, rank=rank):
            # the other process's edge plane next to this one's half
            for t, src, _ in recvs:
                t.copy_(grid[half - 1: half] if src < rank else grid[half: half + 1])

        pm.send_recv = send_recv
        rows = slice(rank * x.numel() // 2, (rank + 1) * x.numel() // 2)
        assert torch.equal(phalo.make_structured_halo(A, pm) @ x[rows], want[rows])
