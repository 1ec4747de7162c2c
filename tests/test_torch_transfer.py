"""K3 and K4 of the PyTorch port (amg_tpu_torch/ops/transfer.py) against the
JAX package's fused Pallas transfer kernels (amg_tpu/ops/pallas_transfer.py)
run in interpret mode on the CPU, at shapes where the JAX kernels apply
(`transfer_fuse_ok` at slab 8).

The same float64 inputs, drawn with numpy from fixed seeds, go through both.
Tolerance: atol 1e-12 on the interior. The transfer weights are powers of two,
so the two sides differ only in the summation order of the stencil taps.
K4's plain version prolongs in the reference kernel's order (y, then x, then
z) and is also held against it in float32, on the uniform box, where it sums
the box in the reference's order too (see the float32 test for the ulps).
The launch plans of K3 and K4 are checked for coverage at their edges.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import amg_tpu.ops.pallas_stencil as ps
import amg_tpu.ops.pallas_transfer as pt
from amg_tpu.problems import laplacian_3d_27pt

from amg_tpu_torch.ops import stencil as ts
from amg_tpu_torch.ops import transfer as tt

from torch_parity import launches

# one intra-op thread: the suite runs several worker processes at once, and
# idle OpenMP threads spinning in each would take cores from the others
torch.set_num_threads(1)

# (grid shape, taps): both tap kinds at 16^3, the general taps on a ragged
# shape (odd Z, Y not a power of two)
CASES = [((16, 16, 16), "box"), ((16, 16, 16), "rap27"), ((17, 18, 16), "rap27")]


def _taps(kind):
    """(weights, offsets): the 27-pt box, or a general 27-tap stencil with
    distinct weights (the shape of the RAP coarse taps)."""
    st = laplacian_3d_27pt(4).stencil
    if kind == "box":
        return tuple(float(w) for w in np.asarray(st.weights)), tuple(st.offsets)
    w = -np.random.default_rng(7).random(27)
    w[13] = 30.0  # centre tap of the (-1, 0, 1)^3 product order
    return tuple(float(x) for x in w), tuple(st.offsets)


def _inputs(gs, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(gs))
    cs = tt.coarse_shape_of(gs)
    return (rng.random(n), rng.random(n), 0.02 + 0.01 * rng.random(n),
            rng.random(int(np.prod(cs))))


def _port(x, gs):
    return ts.to_padded(torch.from_numpy(x), gs)


def _jax(x, gs):
    return ps.to_padded(jnp.asarray(x), gs, 8)


def _assert_interior(got, want_jax, gs):
    np.testing.assert_allclose(
        ts.from_padded(got, gs).numpy(), np.asarray(ps.from_padded(want_jax, gs)),
        rtol=0, atol=1e-12,
    )
    shell = got.clone()
    Z, Y, X = gs
    shell[1:Z + 1, 1:Y + 1, 1:X + 1] = 0
    assert torch.count_nonzero(shell) == 0


# (zero_guess, alpha): the iterate itself; the zero-guess pre-sweep with the
# streamed scale; the zero-guess pre-sweep with a scalar weight
K3_MODES = [(False, 0.0), (True, 0.0), (True, 0.021)]


@pytest.mark.parametrize("zero_guess,alpha", K3_MODES)
@pytest.mark.parametrize("gs,kind", CASES, ids=str)
def test_k3_plain_matches_pallas(gs, kind, zero_guess, alpha):
    weights, offsets = _taps(kind)
    cs = tt.coarse_shape_of(gs)
    assert pt.transfer_fuse_ok(gs, cs, offsets, 8)
    u, b, s, _ = _inputs(gs, seed=11)
    scale = None if alpha else s
    with pltpu.force_tpu_interpret_mode():
        want = pt.residual_restrict_padded(
            None if zero_guess else _jax(u, gs), _jax(b, gs), weights, gs,
            offsets, 8, zero_guess=zero_guess,
            scale_pad=None if scale is None else _jax(scale, gs), alpha=alpha,
        )
    got = tt.residual_restrict_padded(
        None if zero_guess else _port(u, gs), _port(b, gs), weights, gs,
        offsets, zero_guess=zero_guess,
        scale_pad=None if scale is None else _port(scale, gs), alpha=alpha,
    )
    assert got.shape == ts.padded_shape(cs)
    _assert_interior(got, want, cs)


@pytest.mark.parametrize("zero_guess", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.021])
@pytest.mark.parametrize("gs,kind", CASES, ids=str)
def test_k4_plain_matches_pallas(gs, kind, alpha, zero_guess):
    weights, offsets = _taps(kind)
    cs = tt.coarse_shape_of(gs)
    u, b, s, ec = _inputs(gs, seed=12)
    scale = None if alpha else s
    with pltpu.force_tpu_interpret_mode():
        want = pt.prolong_sweep_padded(
            None if zero_guess else _jax(u, gs), _jax(b, gs), _jax(ec, cs),
            weights, gs, offsets, alpha=alpha,
            scale_pad=None if scale is None else _jax(scale, gs), slab=8,
            zero_guess=zero_guess,
        )
    got = tt.prolong_sweep_padded(
        None if zero_guess else _port(u, gs), _port(b, gs), _port(ec, cs),
        weights, gs, offsets, alpha=alpha,
        scale_pad=None if scale is None else _port(scale, gs),
        zero_guess=zero_guess,
    )
    assert got.shape == ts.padded_shape(gs)
    _assert_interior(got, want, gs)


# float32: XLA on the CPU may contract the Pallas kernel's combine and update
# into FMAs, so about a fifth of the points differ by an ulp of the largest
# values (measured: at most 1.2 ulps); held to 4 ulps of the largest value.
@pytest.mark.parametrize("zero_guess", [False, True])
@pytest.mark.parametrize("alpha", [0.0, 0.021])
def test_k4_plain_matches_pallas_in_float32(alpha, zero_guess):
    gs = (16, 16, 16)
    weights, offsets = _taps("box")
    cs = tt.coarse_shape_of(gs)
    u, b, s, ec = (v.astype(np.float32) for v in _inputs(gs, seed=13))
    scale = None if alpha else s
    with pltpu.force_tpu_interpret_mode():
        want = pt.prolong_sweep_padded(
            None if zero_guess else _jax(u, gs), _jax(b, gs), _jax(ec, cs),
            weights, gs, offsets, alpha=alpha,
            scale_pad=None if scale is None else _jax(scale, gs), slab=8,
            zero_guess=zero_guess,
        )
    got = tt.prolong_sweep_padded(
        None if zero_guess else _port(u, gs), _port(b, gs), _port(ec, cs),
        weights, gs, offsets, alpha=alpha,
        scale_pad=None if scale is None else _port(scale, gs),
        zero_guess=zero_guess,
    )
    assert got.dtype == torch.float32
    wi = np.asarray(ps.from_padded(want, gs))
    gi = ts.from_padded(got, gs).numpy()
    assert np.abs(gi - wi).max() <= 4 * np.finfo(np.float32).eps * np.abs(wi).max()


@pytest.mark.parametrize("gs", [(16, 16, 16), (17, 18, 15)], ids=str)
def test_k4_prolongs_in_the_reference_order(gs):
    """In float32, P ec in K4_AXES order equals the reference kernel's
    expansion bit for bit: each coarse plane times its y and x transfer
    matrices (`_axis_mat_reg`, as `_ps_kernel` multiplies them), then each
    fine plane the expanded plane or the mean 0.5 * (a + b) of two. The
    order of the unfused `prolong_padded` (z, y, x) rounds otherwise."""
    cs = tt.coarse_shape_of(gs)
    ec = np.random.default_rng(5).standard_normal(int(np.prod(cs))).astype(np.float32)
    ecp = _port(ec, cs)
    Zcr, Ycr, Xcr = ecp.shape
    Z, Y, X = gs
    Zr, Yr, Xr = ts.padded_shape(gs)
    dims = (((1,), (0,)), ((), ()))
    with jax.enable_x64(False):
        sy = pt._axis_mat_reg(Y, cs[1], Yr, Ycr, jnp.float32, transpose=True)
        sx = pt._axis_mat_reg(X, cs[2], Xr, Xcr, jnp.float32, transpose=True)
        e = jax.lax.dot_general(jnp.asarray(ecp.numpy()), sy, dims,
                                preferred_element_type=jnp.float32, precision=pt._DOT_PREC)
        e = np.asarray(jax.lax.dot_general(e, sx, dims, preferred_element_type=jnp.float32,
                                           precision=pt._DOT_PREC))
    want = np.zeros((Zr, Yr, Xr), np.float32)
    for p in range(1, Z + 1):
        want[p] = e[(p + 1) // 2] if p % 2 else np.float32(0.5) * (e[p // 2] + e[p // 2 + 1])
    assert np.array_equal(tt.prolong_padded(ecp, gs, tt.K4_AXES).numpy(), want)
    assert not np.array_equal(tt.prolong_padded(ecp, gs).numpy(), want)


@pytest.mark.parametrize("gs", [(9, 10, 11), (16, 16, 16)], ids=str)
def test_plain_transfers_match_the_transfer_matrices(gs):
    """restrict_padded / prolong_padded are R = S^T and P = S per axis, with
    S the 1-D matrix of amg_tpu.setup.structured._axis_transfer_np."""
    from amg_tpu.setup.structured import _axis_transfer_np

    cs = tt.coarse_shape_of(gs)
    rng = np.random.default_rng(3)
    r = rng.random(gs)
    ec = rng.random(cs)
    S = [_axis_transfer_np(f, c) for f, c in zip(gs, cs)]
    want_r = np.einsum("abc,aA,bB,cC->ABC", r, *S)
    want_p = np.einsum("ABC,aA,bB,cC->abc", ec, *S)
    got_r = tt.restrict_padded(_port(r.reshape(-1), gs), gs)
    got_p = tt.prolong_padded(_port(ec.reshape(-1), cs), gs)
    np.testing.assert_allclose(ts.from_padded(got_r, cs).numpy(), want_r.reshape(-1),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(ts.from_padded(got_p, gs).numpy(), want_p.reshape(-1),
                               rtol=0, atol=1e-13)


def test_wrappers_reject_what_the_kernels_do_not_take():
    gs = (16, 16, 16)
    weights, offsets = _taps("box")
    u, b, s, ec = _inputs(gs, seed=0)
    up, bp, sp_, ecp = _port(u, gs), _port(b, gs), _port(s, gs), _port(ec, (8, 8, 8))
    with pytest.raises(ValueError, match="coarsening"):
        tt.residual_restrict_padded(up, bp, (1.0,), gs, ((0, 0, 2),))
    with pytest.raises(TypeError):
        tt.residual_restrict_padded(None, bp, weights, gs, offsets)
    with pytest.raises(TypeError):
        tt.residual_restrict_padded(None, bp, weights, gs, offsets, zero_guess=True)
    with pytest.raises(ValueError, match="shape"):
        tt.prolong_sweep_padded(up, bp, ecp[:-1].contiguous(), weights, gs, offsets,
                                scale_pad=sp_)
    with pytest.raises(ValueError, match="dtype"):
        tt.prolong_sweep_padded(up, bp, ecp.float(), weights, gs, offsets, scale_pad=sp_)
    with pytest.raises(TypeError):
        tt.prolong_sweep_padded(up, bp, ecp, weights, gs, offsets, scale_pad=None)
    before = launches("residual_restrict_padded.launches", "prolong_sweep_padded.launches")
    tt.residual_restrict_padded(up, bp, weights, gs, offsets)
    tt.prolong_sweep_padded(up, bp, ecp, weights, gs, offsets, scale_pad=sp_)
    assert launches("residual_restrict_padded.launches", "prolong_sweep_padded.launches") == before


@pytest.mark.parametrize("dtype,zero_guess,scaled,want", [
    # 126^3: padded fine (128, 128, 128), padded coarse (65, 65, 68)
    (torch.float32, False, False, (2 * 128 * 128 * 128 + 65 * 65 * 68) * 4),
    (torch.float64, False, False, (2 * 128 * 128 * 128 + 65 * 65 * 68) * 8),
    # 63^3 zero-guess: padded fine (65, 65, 68), padded coarse (34, 34, 36)
    (torch.float32, True, True, (2 * 65 * 65 * 68 + 34 * 34 * 36) * 4),
    (torch.float32, True, False, (65 * 65 * 68 + 34 * 34 * 36) * 4),
], ids=["126-f32", "126-f64", "63-zg-scale", "63-zg-alpha"])
def test_k3_bytes_counts_each_padded_stream_once(dtype, zero_guess, scaled, want):
    gs = (126,) * 3 if not zero_guess else (63,) * 3
    assert tt.k3_bytes(gs, dtype, zero_guess, scaled) == want
    if gs == (126,) * 3 and dtype == torch.float32:
        assert round(want / 1e6, 1) == 17.9


@pytest.mark.parametrize("gs", [(126, 126, 126), (63, 63, 63), (32, 32, 32), (3, 4, 5),
                                (32, 33, 31), (61, 96, 128)], ids=str)
def test_k3_plan_covers_every_coarse_point_once(gs):
    """Every padded coarse point lies in exactly one block's (x, y) tile and
    z-chunk; the grid has >= 2 x 132 blocks wherever the coarse grid allows
    it with one-plane chunks."""
    zchunk, (gx, gy, gz) = tt.k3_plan(gs)
    Zcr, Ycr, Xcr = ts.padded_shape(tt.coarse_shape_of(gs))
    ty, tx = tt.K3_TILE
    assert 1 <= zchunk <= tt.K3_MAX_ZCHUNK
    cover = np.zeros((gz * zchunk, gy * ty, gx * tx), dtype=int)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                cover[bz * zchunk:(bz + 1) * zchunk, by * ty:(by + 1) * ty,
                      bx * tx:(bx + 1) * tx] += 1
    assert (cover == 1).all()
    # no block lies wholly outside the padded coarse array
    assert (gx - 1) * tx < Xcr and (gy - 1) * ty < Ycr and (gz - 1) * zchunk < Zcr
    assert gx * tx >= Xcr and gy * ty >= Ycr and gz * zchunk >= Zcr
    one_plane = Zcr * gx * gy
    assert gx * gy * gz >= min(tt.K3_MIN_BLOCKS, one_plane)


def test_k3_plan_at_the_main_path_shapes():
    # 126^3: 4-plane chunks, 765 blocks; 63^3: one-plane chunks, 510 blocks
    # (>= 264); 32^3: the coarse grid allows 108 blocks at most
    assert tt.k3_plan((126,) * 3) == (4, (5, 9, 17))
    assert tt.k3_plan((63,) * 3) == (1, (3, 5, 34))
    assert tt.k3_plan((32,) * 3) == (1, (2, 3, 18))
    zchunk, (gx, gy, gz) = tt.k3_plan((63,) * 3)
    assert gx * gy * gz >= 264


def _k4_cover(gs, plan):
    zchunk, (gx, gy, gz) = plan
    ty, tx = ts.ZMARCH_TILE
    cover = np.zeros((gz * zchunk, gy * ty, gx * tx), dtype=int)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                cover[bz * zchunk:(bz + 1) * zchunk, by * ty:(by + 1) * ty,
                      bx * tx:(bx + 1) * tx] += 1
    return cover


# K4's plan at its edges: sides under one 32x8 tile; an odd Z; 10-plane chunks
# that do not divide the 62 padded planes of (60, 96, 128); the main path's
# 126^3, 63^3 and 32^3
@pytest.mark.parametrize("gs", [(3, 4, 5), (17, 18, 16), (33, 9, 70), (60, 96, 128),
                                (126, 126, 126), (63, 63, 63), (32, 32, 32)], ids=str)
def test_k4_plan_covers_every_fine_plane_once(gs):
    """Every padded fine point lies in exactly one block's (x, y) tile and
    z-chunk, no block lies wholly outside the array, and the grid has
    >= 3 x 132 blocks wherever the array allows it with one-plane chunks."""
    zchunk, (gx, gy, gz) = tt.k4_plan(gs)
    Zr, Yr, Xr = ts.padded_shape(gs)
    ty, tx = ts.ZMARCH_TILE
    assert 1 <= zchunk <= ts.ZMARCH_MAX_ZCHUNK
    assert (_k4_cover(gs, (zchunk, (gx, gy, gz))) == 1).all()
    assert (gx - 1) * tx < Xr and (gy - 1) * ty < Yr and (gz - 1) * zchunk < Zr
    assert gx * tx >= Xr and gy * ty >= Yr and gz * zchunk >= Zr
    assert gx * gy * gz >= min(ts.ZMARCH_MIN_BLOCKS, Zr * gx * gy)
    if gs == (60, 96, 128):
        assert zchunk > 1 and gz * zchunk != Zr


def test_k4_plan_at_the_main_path_shapes():
    # 126^3: 16-plane chunks, 512 blocks; 63^3: 4-plane chunks, 459 blocks;
    # 32^3: one-plane chunks, 340 blocks (the array allows no more)
    assert tt.k4_plan((126,) * 3) == (16, (4, 16, 8))
    assert tt.k4_plan((63,) * 3) == (4, (3, 9, 17))
    assert tt.k4_plan((32,) * 3) == (1, (2, 5, 34))


@pytest.mark.parametrize("dtype,gs,zero_guess,scaled,want", [
    # 126^3: padded fine (128, 128, 128), padded coarse (65, 65, 68)
    (torch.float32, (126,) * 3, False, True, (4 * 128 ** 3 + 65 * 65 * 68) * 4),
    (torch.float64, (126,) * 3, False, False, (3 * 128 ** 3 + 65 * 65 * 68) * 8),
    # 63^3 zero-guess: padded fine (65, 65, 68), padded coarse (34, 34, 36)
    (torch.float32, (63,) * 3, True, True, (3 * 65 * 65 * 68 + 34 * 34 * 36) * 4),
    # 32^3 zero-guess: padded fine (34, 34, 36), padded coarse (18, 18, 20)
    (torch.float32, (32,) * 3, True, False, (2 * 34 * 34 * 36 + 18 * 18 * 20) * 4),
], ids=["126-f32", "126-f64-alpha", "63-zg-scale", "32-zg-alpha"])
def test_k4_bytes_counts_each_padded_stream_once(dtype, gs, zero_guess, scaled, want):
    assert tt.k4_bytes(gs, dtype, zero_guess, scaled) == want
    if gs == (126,) * 3 and dtype == torch.float32:
        assert round(want / 1e6, 1) == 34.7
