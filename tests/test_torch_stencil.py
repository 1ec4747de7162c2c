"""K1 of the PyTorch port (amg_tpu_torch/ops/stencil.py) against the JAX
package's Pallas stencil kernel (amg_tpu/ops/pallas_stencil.py) run in
interpret mode on the CPU.

The same float64 inputs, drawn with numpy from fixed seeds, go through both.
Tolerances: atol 1e-12 on the interior (both sum the same <= 27 products of
O(1) values in float64, in different orders) and rtol 1e-12 on the
residual-norm sum.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import amg_tpu.ops.pallas_stencil as ps
from amg_tpu.problems import difconv_3d, laplacian_3d_7pt, laplacian_3d_27pt

from amg_tpu_torch.ops import stencil as ts

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)

CASES = [
    ("27pt-box", lambda: laplacian_3d_27pt(8).stencil),
    ("7pt", lambda: laplacian_3d_7pt(6, 7, 5, cx=1.0, cy=2.0, cz=0.5).stencil),
    ("difconv", lambda: difconv_3d(6, atype=2, ax=-1.5).stencil),
]


def _inputs(st, seed):
    gs = tuple(st.grid_shape)
    n = int(np.prod(gs))
    rng = np.random.default_rng(seed)
    u, b = rng.random(n), rng.random(n)
    s = 0.5 / (1.0 + rng.random(n))
    weights = tuple(float(w) for w in np.asarray(st.weights))
    return gs, weights, tuple(st.offsets), u, b, s


def _port_pad(x, gs):
    return ts.to_padded(torch.from_numpy(x), gs)


def _jax_pad(x, gs):
    return ps.to_padded(jnp.asarray(x), gs, 8)


@pytest.mark.parametrize("mode", ts.MODES)
@pytest.mark.parametrize("name,gen", CASES, ids=[c[0] for c in CASES])
def test_k1_plain_matches_pallas(name, gen, mode):
    st = gen()
    gs, weights, offsets, u, b, s = _inputs(st, seed=len(mode))
    alpha = 0.37 / float(np.max(np.abs(weights)))
    with pltpu.force_tpu_interpret_mode():
        want = ps.stencil_kernel_padded(
            _jax_pad(u, gs), _jax_pad(b, gs), weights, gs, offsets,
            alpha=alpha, scale_pad=_jax_pad(s, gs), mode=mode, slab=8,
        )
    got = ts.stencil_kernel_padded(
        _port_pad(u, gs), _port_pad(b, gs), weights, gs, offsets,
        alpha=alpha, scale_pad=_port_pad(s, gs), mode=mode,
    )
    if mode == "sweep_vec_norm":
        (want, want_parts), (got, got_parts) = want, got
        np.testing.assert_allclose(
            float(torch.sum(got_parts)), float(jnp.sum(want_parts)), rtol=1e-12
        )
    assert got.shape == ts.padded_shape(gs)
    np.testing.assert_allclose(
        ts.from_padded(got, gs).numpy(), np.asarray(ps.from_padded(want, gs)),
        rtol=0, atol=1e-12,
    )
    # every mode writes the zero shell (the Dirichlet truncation)
    shell = got.clone()
    Z, Y, X = gs
    shell[1:Z + 1, 1:Y + 1, 1:X + 1] = 0
    assert torch.count_nonzero(shell) == 0


def test_padded_layout_roundtrip():
    gs = (5, 6, 7)
    x = torch.from_numpy(np.random.default_rng(2).random(int(np.prod(gs))))
    p = ts.to_padded(x, gs)
    assert p.shape == ts.padded_shape(gs) == (7, 8, 12)
    assert p.shape[2] % 4 == 0  # 16-byte float32 rows
    assert torch.equal(ts.from_padded(p, gs), x)
    assert float(p.abs().sum()) == pytest.approx(float(x.abs().sum()), rel=1e-12)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    st = laplacian_3d_27pt(6).stencil
    gs, weights, offsets, u, b, s = _inputs(st, seed=0)
    up, bp, sp_ = _port_pad(u, gs), _port_pad(b, gs), _port_pad(s, gs)
    call = ts.stencil_kernel_padded
    with pytest.raises(ValueError, match="mode"):
        call(up, bp, weights, gs, offsets, mode="sweep9")
    with pytest.raises(ValueError, match="shape"):
        call(up[:-1].contiguous(), bp, weights, gs, offsets, mode="residual")
    with pytest.raises(ValueError, match="dtype"):
        call(up, bp.float(), weights, gs, offsets, mode="residual")
    with pytest.raises(ValueError, match="contiguous"):
        nc = up.transpose(0, 1).contiguous().transpose(0, 1)
        call(up, nc, weights, gs, offsets, mode="residual")
    with pytest.raises(ValueError, match="float32 or float64"):
        call(up.half(), bp.half(), weights, gs, offsets, mode="residual")
    with pytest.raises(TypeError):
        call(up, bp, weights, gs, offsets, mode="sweep_vec", scale_pad=None)
    with pytest.raises(ValueError, match="reach-1"):
        call(up, bp, (1.0,), gs, ((0, 0, 2),), mode="spmv")
    with pytest.raises(ValueError, match="one weight per offset"):
        call(up, bp, weights[:-1], gs, offsets, mode="spmv")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    st = laplacian_3d_27pt(6).stencil
    gs, weights, offsets, u, b, s = _inputs(st, seed=1)
    before = ts.stencil_kernel_padded.launches
    out = ts.stencil_kernel_padded(
        _port_pad(u, gs), _port_pad(b, gs), weights, gs, offsets,
        scale_pad=_port_pad(s, gs), mode="sweep_vec",
    )
    want = ts.stencil_plain(
        _port_pad(u, gs), _port_pad(b, gs), ts.taps_of(weights, offsets), gs,
        scale_pad=_port_pad(s, gs), mode="sweep_vec",
    )
    assert torch.equal(out, want)
    assert ts.stencil_kernel_padded.launches == before
