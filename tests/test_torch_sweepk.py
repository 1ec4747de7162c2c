"""K2 of the PyTorch port (the k-sweep modes of
amg_tpu_torch/ops/stencil.py::stencil_kernel_padded) and its routing in
amg_tpu_torch/solve/struct_cycle.py, against the JAX package.

- The plain K2 against the JAX package's `_sweepk_kernel` (modes
  sweep2|3|4[_vec]) in interpret mode at 16^3: the same float64 inputs, atol
  1e-12 on the interior (both chain K sweeps of the separable box sum in
  the same order; XLA may contract the combine into FMAs), shell exactly 0;
  and in float32 at 12^3, to 4 ulps of the largest value.
- `struct_solve` V(3,2) at 12^3, where the JAX package runs its fused
  three-sweep kernel: the same cycle count, x to rtol 1e-12.
- F4: on the default hierarchy at 64^3, level 1 (32^3) is a constant RAP
  stencil whose taps are not the uniform box. The JAX struct_solve with two
  sweeps per side routes it to its k-sweep kernel, which asserts the uniform
  box; the port chains single sweeps there and equals the generic
  mult_vcycle solve of both packages to atol 1e-12.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import amg_tpu.ops.pallas_stencil as ps
import amg_tpu.solve.struct_cycle as jsc
from amg_tpu.problems import laplacian_3d_27pt as jax_27pt
from amg_tpu.setup.structured import build_structured_hierarchy as jax_build
from amg_tpu.smooth import SmootherType as JaxSmoother
from amg_tpu.solve.cycles import CycleConfig as JaxCycleConfig
from amg_tpu.solve.cycles import CycleType as JaxCycleType
from amg_tpu.solve.cycles import mult_vcycle as jax_mult_vcycle

import amg_tpu_torch.solve.struct_cycle as tsc
from amg_tpu_torch.ops import stencil as ts
from amg_tpu_torch.solve.cycles import CycleConfig, mult_vcycle

from torch_parity import launches, port_hierarchy

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)


def _box_inputs(n, seed):
    st = jax_27pt(n).stencil
    gs = tuple(st.grid_shape)
    rng = np.random.default_rng(seed)
    u, b = rng.random(n ** 3), rng.random(n ** 3)
    s = 0.5 / (26.0 + 4.0 * rng.random(n ** 3))
    weights = tuple(float(w) for w in np.asarray(st.weights))
    return gs, weights, tuple(st.offsets), u, b, s


@pytest.mark.parametrize("mode", ts.SWEEPK_MODES)
def test_k2_plain_matches_pallas(mode):
    gs, weights, offsets, u, b, s = _box_inputs(16, seed=int(mode[5]))
    alpha = 0.9 / 26.0
    vec = mode.endswith("_vec")

    def jpad(x):
        return ps.to_padded(jnp.asarray(x), gs, 4)

    def tpad(x):
        return ts.to_padded(torch.from_numpy(x), gs)

    with pltpu.force_tpu_interpret_mode():
        want = ps.stencil_kernel_padded(
            jpad(u), jpad(b), weights, gs, offsets, alpha=alpha,
            scale_pad=jpad(s) if vec else None, mode=mode, slab=4,
        )
    got = ts.stencil_kernel_padded(
        tpad(u), tpad(b), weights, gs, offsets, alpha=alpha,
        scale_pad=tpad(s) if vec else None, mode=mode,
    )
    np.testing.assert_allclose(
        ts.from_padded(got, gs).numpy(), np.asarray(ps.from_padded(want, gs)),
        rtol=0, atol=1e-12,
    )
    shell = got.clone()
    Z, Y, X = gs
    shell[1:Z + 1, 1:Y + 1, 1:X + 1] = 0
    assert torch.count_nonzero(shell) == 0


# float32: the K sweeps of the plain version against the Pallas kernel at
# 12^3. Both sum the box in the reference's separable order; XLA on the CPU may
# contract the combine into FMAs (one ulp per sweep at most), so the iterates
# are held to 4 ulps of their largest value (measured: 0.7 ulp for sweep2_vec,
# 1.7 for sweep4).
@pytest.mark.parametrize("mode", ["sweep2_vec", "sweep4"])
def test_k2_plain_matches_pallas_in_float32(mode):
    gs, weights, offsets, u, b, s = _box_inputs(12, seed=3)
    u, b, s = (x.astype(np.float32) for x in (u, b, s))
    vec = mode.endswith("_vec")

    def jpad(x):
        return ps.to_padded(jnp.asarray(x), gs, 4)

    def tpad(x):
        return ts.to_padded(torch.from_numpy(x), gs)

    with pltpu.force_tpu_interpret_mode():
        want = ps.stencil_kernel_padded(
            jpad(u), jpad(b), weights, gs, offsets, alpha=0.9 / 26.0,
            scale_pad=jpad(s) if vec else None, mode=mode, slab=4,
        )
    got = ts.stencil_kernel_padded(
        tpad(u), tpad(b), weights, gs, offsets, alpha=0.9 / 26.0,
        scale_pad=tpad(s) if vec else None, mode=mode,
    )
    assert got.dtype == torch.float32
    wi = np.asarray(ps.from_padded(want, gs))
    gi = ts.from_padded(got, gs).numpy()
    assert np.abs(gi - wi).max() <= 4 * np.finfo(np.float32).eps * np.abs(wi).max()


def test_k2_needs_the_uniform_box_and_counts_no_cpu_launch():
    gs, weights, offsets, u, b, s = _box_inputs(6, seed=0)
    up, bp = ts.to_padded(torch.from_numpy(u), gs), ts.to_padded(torch.from_numpy(b), gs)
    skewed = (weights[0] * 1.5,) + weights[1:]
    with pytest.raises(ValueError, match="uniform 27-point box"):
        ts.stencil_kernel_padded(up, bp, skewed, gs, offsets, alpha=0.03, mode="sweep2")
    before = launches("stencil_kernel_padded.launches", "stencil_kernel_padded.k2_launches")
    got = ts.stencil_kernel_padded(up, bp, weights, gs, offsets, alpha=0.03, mode="sweep3")
    want = ts.sweepk_plain(up, bp, ts.taps_of(weights, offsets), gs, 3, alpha=0.03)
    assert torch.equal(got, want)
    assert launches("stencil_kernel_padded.launches",
                    "stencil_kernel_padded.k2_launches") == before


@pytest.mark.parametrize("post", [2, 4])
def test_fine_sweeps_chain_greedily(post, monkeypatch):
    """On the uniform box the chain takes the deepest k <= 4 left (V(3, post):
    pre 3 -> sweep3; post 2 -> sweep2, post 4 -> sweep4); on RAP taps only
    single sweeps."""
    n = 8
    _, jh = jax_build(jax_27pt(n).stencil, smoother=JaxSmoother.L1_JACOBI)
    th = port_hierarchy(jh)
    modes = []
    real = tsc.stencil_kernel_padded

    def spy(*a, **kw):
        modes.append(kw["mode"])
        return real(*a, **kw)

    monkeypatch.setattr(tsc, "stencil_kernel_padded", spy)
    spec = tsc.make_struct_spec(th)
    assert spec.box
    b_pad = ts.to_padded(torch.from_numpy(np.random.default_rng(0).random(n ** 3)), spec.grid_shape)
    for k, want in ((3, ["sweep3_vec"]), (post, [f"sweep{post}_vec"]), (5, ["sweep4_vec", "sweep_vec"])):
        modes.clear()
        tsc._fine_sweeps(spec, torch.zeros_like(b_pad), b_pad, k)
        assert modes == want
    modes.clear()
    tsc._fine_sweeps(spec._replace(box=False), torch.zeros_like(b_pad), b_pad, post)
    assert modes == ["sweep_vec"] * post


def test_fine_sweeps_chain_k1_launches_on_the_card(monkeypatch):
    """On a CUDA state the box sweeps run as single K1 launches (chained K1
    launches are faster than K2 on the H100); on the CPU K2 modes, as the
    reference routes them."""
    n = 8
    _, jh = jax_build(jax_27pt(n).stencil, smoother=JaxSmoother.L1_JACOBI)
    spec = tsc.make_struct_spec(port_hierarchy(jh))
    modes = []

    def spy(u_pad, *a, **kw):
        modes.append(kw["mode"])
        return u_pad

    monkeypatch.setattr(tsc, "stencil_kernel_padded", spy)
    on_card = SimpleNamespace(device=SimpleNamespace(type="cuda"))
    assert not tsc._k2_pays(on_card)
    tsc._fine_sweeps(spec, on_card, None, 3)
    assert modes == ["sweep_vec"] * 3
    modes.clear()
    assert tsc._k2_pays(spec.scale_pad)
    tsc._fine_sweeps(spec, spec.scale_pad, None, 3)
    assert modes == ["sweep3_vec"]


def test_struct_solve_v32_matches_jax():
    n = 12
    _, jh = jax_build(jax_27pt(n).stencil, smoother=JaxSmoother.L1_JACOBI)
    th = port_hierarchy(jh)
    b = np.random.default_rng(5).random(n ** 3)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI,
                          num_pre_sweeps=3, num_post_sweeps=2)
    cfg = CycleConfig(num_pre_sweeps=3, num_post_sweeps=2)
    with pltpu.force_tpu_interpret_mode():
        want = jsc.struct_solve(jh, jcfg, jnp.asarray(b), tol=1e-6, max_cycles=20)
    got = tsc.struct_solve(th, cfg, torch.from_numpy(b), tol=1e-6, max_cycles=20, device="cpu")
    assert got.num_iters() == want.num_iters()
    np.testing.assert_allclose(got.history_list(), want.history_list(), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-12)


def test_f4_constant_rap_level_chains_single_sweeps():
    n = 64
    _, jh = jax_build(jax_27pt(n).stencil, smoother=JaxSmoother.L1_JACOBI)
    th = port_hierarchy(jh)
    specs = tsc.make_coarse_specs(th)
    assert list(specs) == [1] and specs[1].grid_shape == (32, 32, 32)
    assert tsc.make_struct_spec(th).box and not specs[1].box
    b = np.random.default_rng(6).random(n ** 3)
    jcfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI,
                          num_pre_sweeps=2, num_post_sweeps=2)
    cfg = CycleConfig(num_pre_sweeps=2, num_post_sweeps=2)
    with pytest.raises(AssertionError, match="uniform 27-pt box"):
        with pltpu.force_tpu_interpret_mode():
            jsc.struct_solve(jh, jcfg, jnp.asarray(b), tol=1e-12, max_cycles=2)
    got = tsc.struct_solve(th, cfg, torch.from_numpy(b), tol=1e-12, max_cycles=2, device="cpu")
    assert got.iters == 2
    x_port = torch.zeros(n ** 3, dtype=torch.float64)
    x_jax = jnp.zeros(n ** 3)
    for _ in range(2):
        x_port = mult_vcycle(th, cfg, x_port, torch.from_numpy(b))
        x_jax = jax_mult_vcycle(jh, jcfg, x_jax, jnp.asarray(b))
    np.testing.assert_allclose(got.x.numpy(), x_port.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(x_jax), rtol=0, atol=1e-12)
