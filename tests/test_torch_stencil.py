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
from amg_tpu_torch.utils import tracing

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
    before = tracing.counter("stencil_kernel_padded.launches")
    out = ts.stencil_kernel_padded(
        _port_pad(u, gs), _port_pad(b, gs), weights, gs, offsets,
        scale_pad=_port_pad(s, gs), mode="sweep_vec",
    )
    want = ts.stencil_plain(
        _port_pad(u, gs), _port_pad(b, gs), ts.taps_of(weights, offsets), gs,
        scale_pad=_port_pad(s, gs), mode="sweep_vec",
    )
    assert torch.equal(out, want)
    assert tracing.counter("stencil_kernel_padded.launches") == before


# float32: the separable plain version against the Pallas kernel's box path.
# Both sum the box in the same order, but XLA on the CPU may contract the
# combine w_off*t + (w_c - w_off)*u into FMAs, so the two differ by an ulp
# of the largest values (measured: 1.9e-6 on values up to ~21, one ulp);
# held to 4 ulps of the largest value.
@pytest.mark.parametrize("mode", ts.MODES)
def test_box_plain_matches_pallas_in_float32(mode):
    st = laplacian_3d_27pt(8).stencil
    gs, weights, offsets, u, b, s = _inputs(st, seed=7)
    u, b, s = (x.astype(np.float32) for x in (u, b, s))
    with pltpu.force_tpu_interpret_mode():
        want = ps.stencil_kernel_padded(
            _jax_pad(u, gs), _jax_pad(b, gs), weights, gs, offsets,
            alpha=0.01, scale_pad=_jax_pad(s, gs), mode=mode, slab=8,
        )
    got = ts.stencil_kernel_padded(
        _port_pad(u, gs), _port_pad(b, gs), weights, gs, offsets,
        alpha=0.01, scale_pad=_port_pad(s, gs), mode=mode,
    )
    if mode == "sweep_vec_norm":
        (want, _), (got, _) = want, got
    assert got.dtype == torch.float32
    wi = np.asarray(ps.from_padded(want, gs))
    gi = ts.from_padded(got, gs).numpy()
    assert np.abs(gi - wi).max() <= 4 * np.finfo(np.float32).eps * np.abs(wi).max()


def test_box_plain_sums_in_the_reference_order():
    """On the uniform box, apply_plain rounds exactly as a numpy transcription
    of the reference's box_apply (z sum (m + c) + p, then y and x by rolls as
    (c + m) + p, then w_off*t + (w_c - w_off)*u), in float32."""
    gs = (6, 7, 9)
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    w_off, w_c = -0.37, 5.3
    taps = ts.taps_of(tuple(w_c if o == (0, 0, 0) else w_off for o in offs), offs)
    u = ts.to_padded(torch.from_numpy(
        np.random.default_rng(3).standard_normal(int(np.prod(gs))).astype(np.float32)), gs)
    p = u.numpy()
    Z, Y, X = gs
    t = (p[0:Z] + p[1:Z + 1]) + p[2:Z + 2]
    t = (t + np.roll(t, 1, axis=1)) + np.roll(t, -1, axis=1)
    t = (t + np.roll(t, 1, axis=2)) + np.roll(t, -1, axis=2)
    want = np.float32(w_off) * t + np.float32(w_c - w_off) * p[1:Z + 1]
    got = ts.apply_plain(u, taps, gs)
    assert np.array_equal(got.numpy(), want[:, 1:Y + 1, 1:X + 1])


@pytest.mark.parametrize("name,gen", CASES[1:], ids=[c[0] for c in CASES[1:]])
def test_non_box_taps_keep_list_order(name, gen):
    """Every tap list but the uniform box is summed in list order, and the
    wrapper on the CPU is the plain version exactly."""
    st = gen()
    gs, weights, offsets, u, b, s = _inputs(st, seed=4)
    taps = ts.taps_of(weights, offsets)
    assert ts.uniform_box_weights(taps) is None
    up = _port_pad(u, gs)
    Z, Y, X = gs
    want = torch.zeros(gs, dtype=up.dtype)
    for dz, dy, dx, w in taps:
        want = want + w * up[1 + dz:1 + dz + Z, 1 + dy:1 + dy + Y, 1 + dx:1 + dx + X]
    assert torch.equal(ts.apply_plain(up, taps, gs), want)
    bp, sp_ = _port_pad(b, gs), _port_pad(s, gs)
    for mode in ts.MODES:
        got = ts.stencil_kernel_padded(up, bp, weights, gs, offsets, alpha=0.02,
                                       scale_pad=sp_, mode=mode)
        plain = ts.stencil_plain(up, bp, taps, gs, 0.02, sp_ if "vec" in mode else None, mode)
        if mode == "sweep_vec_norm":
            assert torch.equal(got[1], plain[1])
            got, plain = got[0], plain[0]
        assert torch.equal(got, plain)


def _box_plan_writes(gs, nsweep):
    """How often the box march's plan has a block write each padded point."""
    zchunk, (gx, gy, gz) = ts.box_plan(gs, nsweep)
    Zr, Yr, Xr = ts.padded_shape(gs)
    ty, tx = ts.BOX_TILE
    writes = np.zeros((Zr, Yr, Xr), dtype=np.int32)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                writes[bz * zchunk:min(bz * zchunk + zchunk, Zr),
                       by * ty:by * ty + ty, bx * tx:bx * tx + tx] += 1
    return zchunk, (gx, gy, gz), writes


# a side under one tile and one-plane chunks; chunks that do not divide the
# planes (62 padded planes in chunks of 4 at K = 1, of 8 at K >= 2); the main
# path's 126^3
@pytest.mark.parametrize("gs", [(3, 4, 5), (5, 6, 7), (60, 96, 128), (126, 126, 126)], ids=str)
def test_box_plan_covers_every_point_once(gs):
    for nsweep in (1, 2, 3, 4):
        zchunk, grid, writes = _box_plan_writes(gs, nsweep)
        assert (writes == 1).all()
        assert 1 <= zchunk <= ts.BOX_MAX_ZCHUNK
        assert zchunk == ts.BOX_MAX_ZCHUNK or np.prod(grid) <= ts.box_max_blocks(nsweep)
        if gs == (60, 96, 128):
            assert zchunk > 1 and grid[2] * zchunk != ts.padded_shape(gs)[0]


def test_box_plan_pins_the_main_path_shapes():
    assert ts.box_plan((5, 6, 7)) == (1, (1, 1, 7))
    assert ts.box_plan((126, 126, 126)) == (8, (4, 16, 16))  # K1: 1024 blocks
    assert ts.box_plan((126, 126, 126), 2) == (16, (4, 16, 8))  # 512 blocks
    assert ts.box_plan((190, 190, 190), 3) == (32, (6, 24, 6))  # 864 blocks


_PRODUCT = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
_BOX27 = tuple(o + (26.0 if o == (0, 0, 0) else -1.0,) for o in _PRODUCT)
_RAP27 = tuple(o + (-0.1 * (k + 1),) for k, o in enumerate(_PRODUCT))
_SEVEN = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))


@pytest.mark.parametrize("name,taps,want", [
    ("box", _BOX27, 1),
    ("box-reversed", _BOX27[::-1], 1),
    ("rap27", _RAP27, 2),
    ("rap27-reversed", _RAP27[::-1], 0),
    ("7pt", tuple(o + (6.0 if o == (0, 0, 0) else -1.0,) for o in _SEVEN), 0),
    ("rap26", _RAP27[:26], 0),
], ids=lambda v: v if isinstance(v, str) else "")
def test_tap_route(name, taps, want):
    """The route K1's and K4's z-marches take: 1 the uniform box (in any
    order), 2 27 taps at (-1, 0, 1)^3 in product order whatever the weights,
    0 any other list (reversed, partial, the 7-point stencil)."""
    assert ts.tap_route(taps) == want


def _plan_cover(gs, plan, tile):
    zchunk, (gx, gy, gz) = plan
    ty, tx = tile
    cover = np.zeros((gz * zchunk, gy * ty, gx * tx), dtype=int)
    for bz in range(gz):
        for by in range(gy):
            for bx in range(gx):
                cover[bz * zchunk:(bz + 1) * zchunk, by * ty:(by + 1) * ty,
                      bx * tx:(bx + 1) * tx] += 1
    return cover


# K1's tap-list plan at its edges: sides under one 32x8 tile; an odd Z;
# chunks that do not divide the 62 padded planes of (60, 96, 128); the V(3,3)
# path's RAP levels 63^3 and 32^3
@pytest.mark.parametrize("gs", [(3, 4, 5), (17, 18, 16), (33, 9, 70), (60, 96, 128),
                                (63, 63, 63), (32, 32, 32)], ids=str)
def test_k1_taps_plan_covers_every_point_once(gs):
    """Every padded point lies in exactly one block's (x, y) tile and
    z-chunk, no block lies wholly outside the array, and the grid has
    >= 3 x 132 blocks wherever one-plane chunks allow it."""
    zchunk, (gx, gy, gz) = ts.k1_taps_plan(gs)
    Zr, Yr, Xr = ts.padded_shape(gs)
    ty, tx = ts.ZMARCH_TILE
    assert 1 <= zchunk <= ts.ZMARCH_MAX_ZCHUNK
    cover = _plan_cover(gs, (zchunk, (gx, gy, gz)), ts.ZMARCH_TILE)
    assert (cover[:Zr, :Yr, :Xr] == 1).all()
    assert (gx - 1) * tx < Xr and (gy - 1) * ty < Yr and (gz - 1) * zchunk < Zr
    assert gx * gy * gz >= min(ts.ZMARCH_MIN_BLOCKS, Zr * gx * gy)
    if gs == (60, 96, 128):
        assert zchunk > 1 and gz * zchunk != Zr


def test_k1_taps_plan_at_the_rap_levels():
    # 63^3 (padded 65 x 65 x 68): 3 x 9 tiles in 4-plane chunks, 459 blocks;
    # 32^3 (34 x 34 x 36): 2 x 5 tiles in one-plane chunks, 340 blocks (the
    # array allows no more)
    assert ts.k1_taps_plan((63,) * 3) == (4, (3, 9, 17))
    assert ts.k1_taps_plan((32,) * 3) == (1, (2, 5, 34))
