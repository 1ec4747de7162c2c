"""The CUDA kernels K1 to K5 of the PyTorch port against their plain PyTorch
versions, on the card, at ragged shapes that the main paths do not give them
(odd sides, X not a multiple of any block width or tile), with each launch
counted. K2 is also held bit for bit against K chained K1 launches. K1 on
the uniform 27-point box and K2 run through the box march
(`csrc/box_march.cu`), K1 on other taps through the tap-list z-march
(`csrc/tap_march.cu`: the 27 taps in product order, and any other list);
both marches are also run at the edges of their launch plans (chunks of one
plane, chunks that do not divide the planes, one chunk longer than the
array), and so is K4 (`csrc/prolong_march.cu`). K5 also takes bf16
coefficient planes in its sweep.

The generic (algebraic) path, which runs no custom kernel: its 24^3 solve
on the card against the port on the CPU (the same cycles, float64 history
to 1e-10), ELL and BSR spmv on the card against the CPU, and the DIA
fine-operator branch of `device_hierarchy` (K5 below float64). Its
additive cycles, `async_solve` (FULL and SEMI) and `async_smooth_solve` at
24^3 on the card against the CPU under the same draws (history to 1e-10).

The elasticity and Maxwell preconditioners: hybrid JGS on the DIA beam
(K5 in `residual` mode, counted) in both dtypes, the SA-PCG solve, AMS-PCG
and the async AMS solve, and `mixed_solve`, each on the card against the
port on the CPU.

The drivers: `run_experiment` of the structured 27-point problem at 64^3
on the card (K1, K3 and K4 launched) against the CPU, and golden config10's
options on the card (K5 launched, 20 +- 1 iterations).

Marked `cuda`; without a card every test skips. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest
    # -k k1, -k k2, -k box, -k taps, -k k3, -k k4, -k k5, -k generic, -k async,
    # -k "sa or ams or jgs or mixed_solve", -k run_experiment

Tolerances: float64 to 1e-12 and float32 to 1e-5, relative to the largest
interior value, the zero shell exactly; where the kernel rounds every
operation on its own in its plain version's order (K1 on both routes, K2
against the K1 chain, K4, K5), it is also held equal bit for bit
(`torch.equal`). The sweep_vec_norm partials (one per block, summed in the
kernel's own order) are held to the tolerance.
"""

import numpy as np
import pytest
import torch

from amg_tpu_torch.ops import stencil as ts
from amg_tpu_torch.ops import transfer as tt
from amg_tpu_torch.ops import var_stencil as tvs
from amg_tpu_torch.utils import tracing

from torch_parity import launches

pytestmark = pytest.mark.cuda

SHAPES = [(5, 6, 7), (17, 18, 16), (33, 9, 70)]
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _taps(seed):
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    w = -np.random.default_rng(seed).random(27)
    w[13] = 30.0
    return tuple(float(x) for x in w), offs


# the box march's plan edges: a side under one 32 x 8 tile and one-plane
# chunks (the SHAPES), and 62 padded planes in 9 chunks of 7
BOX_SHAPES = SHAPES + [(60, 96, 128)]


def _box():
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return tuple(26.0 if o == (0, 0, 0) else -1.0 for o in offs), offs


def _pad(rng, gs, dtype, device):
    x = torch.from_numpy(rng.random(int(np.prod(gs)))).to(device=device, dtype=dtype)
    return ts.to_padded(x, gs)


def _check(got, want, gs, dtype):
    torch.cuda.synchronize()
    gi = ts.from_padded(got, gs).double()
    wi = ts.from_padded(want, gs).double()
    assert float((gi - wi).abs().max()) <= TOL[dtype] * float(wi.abs().max())
    shell = got.clone()
    Z, Y, X = gs
    shell[1:Z + 1, 1:Y + 1, 1:X + 1] = 0
    assert torch.count_nonzero(shell) == 0


def _seven(seed):
    """A 7-point stencil with distinct weights: K1's route for any tap list."""
    offs = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0), (0, 0, -1), (0, 0, 1))
    w = -np.random.default_rng(seed).random(7)
    w[0] = 8.0
    return tuple(float(x) for x in w), offs


TAP_LISTS = {"dense27": lambda: _taps(1), "list": lambda: _reversed(*_taps(1)),
             "seven": lambda: _seven(1)}


def _k1_taps_modes(u, b, s, w, offs, gs, plan=None):
    """K1's tap-list route in all five modes against stencil_plain: bit for
    bit, the norm's partials (one per block of the plan) to the tolerance."""
    taps = ts.taps_of(w, offs)
    dtype = u.dtype
    for mode in ts.MODES:
        if plan is None:
            before = launches("stencil_kernel_padded.launches",
                              "stencil_kernel_padded.tap_launches")
            got = ts.stencil_kernel_padded(u, b, w, gs, offs, alpha=0.03, scale_pad=s, mode=mode)
            assert launches("stencil_kernel_padded.launches",
                            "stencil_kernel_padded.tap_launches") == (before[0] + 1, before[1] + 1)
        else:
            got = ts._launch_taps(u, None if mode == "spmv" else b,
                                  s if "vec" in mode else None, taps, gs, 0.03, mode, plan)
        want = ts.stencil_plain(u, b, taps, gs, 0.03, s if "vec" in mode else None, mode)
        if mode == "sweep_vec_norm":
            (got, gn), (want, wn) = got, want
            assert gn.numel() == np.prod((plan or ts.k1_taps_plan(gs))[1])
            assert abs(float(gn.double().sum()) - float(wn.double().sum())) <= (
                TOL[dtype] * float(wn.double().sum()))
        _check(got, want, gs, dtype)
        assert torch.equal(got, want), mode


@pytest.mark.parametrize("route", list(TAP_LISTS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", SHAPES, ids=str)
def test_k1_matches_plain(device, gs, dtype, route):
    """K1's tap-list route (csrc/tap_march.cu) on 27 taps in product order,
    the same taps reversed and a 7-point list: all five modes bit for bit."""
    rng = np.random.default_rng(0)
    w, offs = TAP_LISTS[route]()
    assert ts.tap_route(ts.taps_of(w, offs)) == (2 if route == "dense27" else 0)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    _k1_taps_modes(u, b, s, w, offs, gs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("zchunk", [1, 2, 3, 5, 19, 24])
def test_k1_taps_at_plan_edges(device, zchunk, dtype):
    """K1's tap-list route under explicit plans on 17 x 18 x 16 (19 padded
    planes, odd sides): chunks of one plane, chunks that end on a half step,
    chunks that do not divide the planes, one as long as the array and one
    longer; both routes."""
    gs = (17, 18, 16)
    Zr, Yr, Xr = ts.padded_shape(gs)
    plan = (zchunk, (-(-Xr // ts.ZMARCH_TILE[1]), -(-Yr // ts.ZMARCH_TILE[0]), -(-Zr // zchunk)))
    rng = np.random.default_rng(10)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    for route in TAP_LISTS:
        _k1_taps_modes(u, b, s, *TAP_LISTS[route](), gs, plan)


@pytest.fixture(scope="module")
def rap_taps():
    """(weights, offsets) of the 27-point Laplacian's RAP coarse stencil (its
    hierarchy's level 1, in product order): the taps of the V(3,3) path's
    63^3 and 32^3 levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.structured import build_structured_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.struct_cycle import make_coarse_specs

    _, hier = build_structured_hierarchy(laplacian_3d_27pt(64).stencil, coarse_op="const",
                                         smoother=SmootherType.L1_JACOBI, device="cuda")
    spec = make_coarse_specs(hier)[1]
    return spec.weights, spec.offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", [(63, 63, 63), (32, 32, 32)], ids=str)
def test_k1_taps_at_the_rap_levels(device, rap_taps, gs, dtype):
    """The V(3,3) path's coarse shapes under k1_taps_plan with the RAP taps
    (the product-order route) and the same taps reversed."""
    w, offs = rap_taps
    assert ts.tap_route(ts.taps_of(w, offs)) == 2
    rng = np.random.default_rng(11)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    for ww, oo in ((w, offs), _reversed(w, offs)):
        _k1_taps_modes(u, b, s, ww, oo, gs)


def test_k1_taps_refuse_a_misaligned_view(device):
    """K1's tap-list route copies u, b and s in 16-byte chunks: a view at an
    offset that breaks the alignment raises, and nothing is launched."""
    gs = (8, 8, 8)
    w, offs = _taps(1)
    shape = ts.padded_shape(gs)
    bad = torch.zeros(int(np.prod(shape)) + 1, device=device)[1:].view(shape)
    good = torch.zeros(shape, device=device)
    before = tracing.counter("stencil_kernel_padded.launches")
    for u, b, s in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            ts.stencil_kernel_padded(u, b, w, gs, offs, scale_pad=s, mode="sweep_vec")
    assert tracing.counter("stencil_kernel_padded.launches") == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", BOX_SHAPES, ids=str)
def test_k1_box_matches_plain(device, gs, dtype):
    """K1 on the uniform box (the box march at K = 1), all five modes; the
    norm's partials, one per block of the plan, sum to the plain r^2."""
    rng = np.random.default_rng(5)
    w, offs = _box()
    taps = ts.taps_of(w, offs)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    for mode in ts.MODES:
        before = tracing.counter("stencil_kernel_padded.launches")
        got = ts.stencil_kernel_padded(u, b, w, gs, offs, alpha=0.03, scale_pad=s, mode=mode)
        assert tracing.counter("stencil_kernel_padded.launches") == before + 1
        want = ts.stencil_plain(u, b, taps, gs, 0.03, s if "vec" in mode else None, mode)
        if mode == "sweep_vec_norm":
            (got, gn), (want, wn) = got, want
            assert gn.numel() == np.prod(ts.box_plan(gs)[1])
            assert abs(float(gn.double().sum()) - float(wn.double().sum())) <= (
                TOL[dtype] * float(wn.double().sum()))
        _check(got, want, gs, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("zchunk", [1, 3, 5, 19, 24])
def test_box_march_at_plan_edges(device, zchunk, dtype):
    """The box march under explicit plans on 17 x 18 x 16 (19 padded planes):
    K1 against its plain version and K2 bit for bit against the K1 chain
    under the same plan."""
    gs = (17, 18, 16)
    Zr, Yr, Xr = ts.padded_shape(gs)
    plan = (zchunk, (-(-Xr // ts.BOX_TILE[1]), -(-Yr // ts.BOX_TILE[0]), -(-Zr // zchunk)))
    rng = np.random.default_rng(6)
    w, offs = _box()
    box = ts.uniform_box_weights(ts.taps_of(w, offs))
    taps = ts.taps_of(w, offs)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.03 * _pad(rng, gs, dtype, device)
    got, parts = ts._launch_box(u, b, s, box, gs, 0.0, "sweep_vec_norm", 1, plan)
    want, wn = ts.stencil_plain(u, b, taps, gs, 0.0, s, "sweep_vec_norm")
    assert parts.numel() == np.prod(plan[1])
    assert abs(float(parts.double().sum()) - float(wn)) <= TOL[dtype] * float(wn)
    _check(got, want, gs, dtype)
    for k in (2, 3, 4):
        got = ts._launch_box(u, b, s, box, gs, 0.0, "sweep_vec", k, plan)
        chain = u
        for _ in range(k):
            chain = ts._launch_box(chain, b, s, box, gs, 0.0, "sweep_vec", 1, plan)
        assert torch.equal(got, chain), k
        _check(got, ts.sweepk_plain(u, b, taps, gs, k, 0.0, s), gs, dtype)


def test_box_march_refuses_a_misaligned_view(device):
    """The box march copies u, b and s in 16-byte chunks: a view at an offset
    that breaks the alignment raises, and nothing is launched."""
    gs = (8, 8, 8)
    w, offs = _box()
    shape = ts.padded_shape(gs)
    flat = torch.zeros(int(np.prod(shape)) + 1, device=device)
    bad = flat[1:].view(shape)
    good = torch.zeros(shape, device=device)
    before = launches("stencil_kernel_padded.launches", "stencil_kernel_padded.k2_launches")
    for u, b, s in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            ts.stencil_kernel_padded(u, b, w, gs, offs, scale_pad=s, mode="sweep_vec")
        with pytest.raises(ValueError, match="16-byte"):
            ts.stencil_kernel_padded(u, b, w, gs, offs, scale_pad=s, mode="sweep2_vec")
    assert launches("stencil_kernel_padded.launches",
                    "stencil_kernel_padded.k2_launches") == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", SHAPES, ids=str)
def test_k3_k4_match_plain(device, gs, dtype):
    rng = np.random.default_rng(1)
    w, offs = _taps(2)
    taps = ts.taps_of(w, offs)
    cs = tt.coarse_shape_of(gs)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    ec = _pad(rng, cs, dtype, device)
    for zg, alpha in ((False, 0.0), (True, 0.0), (True, 0.03)):
        sa = None if alpha else s
        got = tt.residual_restrict_padded(u, b, w, gs, offs, zero_guess=zg,
                                          scale_pad=sa, alpha=alpha)
        want = tt.residual_restrict_plain(u, b, taps, gs, zg, sa, alpha)
        _check(got, want, cs, dtype)
    for zg in (False, True):
        for alpha in (0.0, 0.03):
            sa = None if alpha else s
            got = tt.prolong_sweep_padded(u, b, ec, w, gs, offs, alpha=alpha,
                                          scale_pad=sa, zero_guess=zg)
            want = tt.prolong_sweep_plain(u, b, ec, taps, gs, alpha, sa, zg)
            _check(got, want, gs, dtype)
            assert torch.equal(got, want), (zg, alpha)


# K4's plan at its edges: sides under one 32x8 tile and one-plane chunks
# (the SHAPES), 10-plane chunks that do not divide the 62 padded planes of
# (60, 96, 128); the main path's shapes: 126^3 (16-plane chunks), 63^3 (4)
# and 32^3 (1)
K4_EDGE_SHAPES = SHAPES + [(60, 96, 128), (126, 126, 126), (63, 63, 63), (32, 32, 32)]


def _k4_modes(u, b, s, ec, w, offs, gs, plan=None):
    """(zero_guess, alpha, kernel out, plain out) in K4's four modes."""
    taps = ts.taps_of(w, offs)
    for zg in (False, True):
        for alpha in (0.0, 0.03):
            sa = None if alpha else s
            if plan is None:
                before = tracing.counter("prolong_sweep_padded.launches")
                got = tt.prolong_sweep_padded(u, b, ec, w, gs, offs, alpha=alpha,
                                              scale_pad=sa, zero_guess=zg)
                assert tracing.counter("prolong_sweep_padded.launches") == before + 1
            else:
                got = tt._launch_k4(None if zg else u, b, sa, ec, taps, gs, alpha, zg, plan)
            yield zg, alpha, got, tt.prolong_sweep_plain(u, b, ec, taps, gs, alpha, sa, zg)


def _reversed(w, offs):
    """The same taps listed in reverse: not the product order, so K4 takes
    its route for any tap list."""
    return tuple(reversed(w)), tuple(reversed(offs))


@pytest.mark.parametrize("route", ["box", "dense27", "list"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", K4_EDGE_SHAPES, ids=str)
def test_k4_equals_plain_bit_for_bit(device, gs, dtype, route):
    """K4 on its three routes: the uniform box (separable), 27 distinct taps
    in product order and the same taps reversed (both in list order); both
    zero_guess modes, scale and alpha: equal to the plain version."""
    rng = np.random.default_rng(8)
    w, offs = {"box": _box, "dense27": lambda: _taps(5),
               "list": lambda: _reversed(*_taps(5))}[route]()
    assert ts.tap_route(ts.taps_of(w, offs)) == {"list": 0, "box": 1, "dense27": 2}[route]
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    ec = _pad(rng, tt.coarse_shape_of(gs), dtype, device)
    for zg, alpha, got, want in _k4_modes(u, b, s, ec, w, offs, gs):
        _check(got, want, gs, dtype)
        assert torch.equal(got, want), (zg, alpha)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("zchunk", [1, 2, 3, 5, 19, 24])
def test_k4_at_plan_edges(device, zchunk, dtype):
    """K4 under explicit plans on 17 x 18 x 16 (19 padded planes): chunks of
    one plane, chunks that start on odd planes, chunks that do not divide the
    planes, one chunk as long as the array and one longer."""
    gs = (17, 18, 16)
    Zr, Yr, Xr = ts.padded_shape(gs)
    plan = (zchunk, (-(-Xr // ts.ZMARCH_TILE[1]), -(-Yr // ts.ZMARCH_TILE[0]), -(-Zr // zchunk)))
    rng = np.random.default_rng(9)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    ec = _pad(rng, tt.coarse_shape_of(gs), dtype, device)
    for w, offs in (_box(), _taps(6), _reversed(*_taps(6))):
        for zg, alpha, got, want in _k4_modes(u, b, s, ec, w, offs, gs, plan):
            _check(got, want, gs, dtype)
            assert torch.equal(got, want), (zg, alpha)


def test_k4_refuses_a_misaligned_view(device):
    """K4 copies x, b, s and ec in 16-byte chunks: a view at an offset that
    breaks the alignment raises, and nothing is launched."""
    gs = (8, 8, 8)
    shape = ts.padded_shape(gs)
    flat = torch.zeros(int(np.prod(shape)) + 1, device=device)
    bad = flat[1:].view(shape)
    good = torch.zeros(shape, device=device)
    cshape = ts.padded_shape(tt.coarse_shape_of(gs))
    ec = torch.zeros(cshape, device=device)
    bad_ec = torch.zeros(int(np.prod(cshape)) + 1, device=device)[1:].view(cshape)
    before = tracing.counter("prolong_sweep_padded.launches")
    for w, offs in (_box(), _taps(5)):
        for x, b, s in ((bad, good, good), (good, bad, good), (good, good, bad)):
            with pytest.raises(ValueError, match="16-byte"):
                tt.prolong_sweep_padded(x, b, ec, w, gs, offs, scale_pad=s)
        with pytest.raises(ValueError, match="16-byte"):
            tt.prolong_sweep_padded(None, good, ec, w, gs, offs, scale_pad=bad, zero_guess=True)
        with pytest.raises(ValueError, match="16-byte"):
            tt.prolong_sweep_padded(good, good, bad_ec, w, gs, offs, scale_pad=good)
    assert tracing.counter("prolong_sweep_padded.launches") == before


# K3's launch plan at its edges: a coarse side smaller than one 16x8 tile;
# odd and even sides mixed; 4-plane z-chunks that do not divide the 33
# padded coarse planes (coarse 31 x 48 x 64); the main path's zero-guess
# shapes 63^3 and 32^3 (one-plane chunks)
K3_EDGE_SHAPES = [(3, 4, 5), (32, 33, 31), (61, 96, 128), (63, 63, 63), (32, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", K3_EDGE_SHAPES, ids=str)
def test_k3_matches_plain_at_plan_edges(device, gs, dtype):
    if gs == (61, 96, 128):
        zchunk, (_, _, gz) = tt.k3_plan(gs)
        assert zchunk > 1 and gz * zchunk != ts.padded_shape(tt.coarse_shape_of(gs))[0]
    rng = np.random.default_rng(4)
    w, offs = _taps(5)  # 27 distinct taps, the shape of the RAP coarse taps
    taps = ts.taps_of(w, offs)
    cs = tt.coarse_shape_of(gs)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    for zg, alpha in ((False, 0.0), (True, 0.0), (True, 0.03)):
        sa = None if alpha else s
        before = tracing.counter("residual_restrict_padded.launches")
        got = tt.residual_restrict_padded(u, b, w, gs, offs, zero_guess=zg,
                                          scale_pad=sa, alpha=alpha)
        assert tracing.counter("residual_restrict_padded.launches") == before + 1
        want = tt.residual_restrict_plain(u, b, taps, gs, zg, sa, alpha)
        _check(got, want, cs, dtype)


def test_k3_refuses_a_misaligned_view(device):
    """K3 copies 16-byte chunks: a view at an offset that breaks the
    alignment raises, and nothing is launched."""
    gs = (8, 8, 8)
    w, offs = _taps(5)
    shape = ts.padded_shape(gs)
    n = int(np.prod(shape))
    flat = torch.zeros(n + 1, device=device)
    b = flat[1:].view(shape)
    u = torch.zeros(shape, device=device)
    before = tracing.counter("residual_restrict_padded.launches")
    with pytest.raises(ValueError, match="16-byte"):
        tt.residual_restrict_padded(u, b, w, gs, offs)
    assert tracing.counter("residual_restrict_padded.launches") == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", BOX_SHAPES, ids=str)
def test_k2_matches_plain_and_the_k1_chain(device, gs, dtype):
    rng = np.random.default_rng(2)
    w, offs = _box()
    taps = ts.taps_of(w, offs)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.03 * _pad(rng, gs, dtype, device)
    for mode in ts.SWEEPK_MODES:
        k, vec = int(mode[5]), mode.endswith("_vec")
        sa = s if vec else None
        before = tracing.counter("stencil_kernel_padded.k2_launches")
        got = ts.stencil_kernel_padded(u, b, w, gs, offs, alpha=0.03, scale_pad=sa, mode=mode)
        assert tracing.counter("stencil_kernel_padded.k2_launches") == before + 1
        _check(got, ts.sweepk_plain(u, b, taps, gs, k, 0.03, sa), gs, dtype)
        chain = u
        for _ in range(k):
            chain = ts.stencil_kernel_padded(chain, b, w, gs, offs, alpha=0.03, scale_pad=sa,
                                             mode="sweep_vec" if vec else "sweep")
        assert torch.equal(got, chain), mode


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs,offsets", [
    ((7, 5, 13), ((0, 0, 0), (-1, 0, 2), (1, 1, -3), (0, -1, 1), (2, 0, 0))),
    ((4, 9, 30), tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                       for dx in range(-5, 6))),
], ids=["5diag", "99diag"])
def test_k5_matches_plain(device, gs, offsets, dtype):
    rng = np.random.default_rng(3)
    h = tvs.halos_of(offsets)
    n = int(np.prod(gs))

    def pad(v):
        return tvs.var_to_padded(torch.from_numpy(v).to(device=device, dtype=dtype), gs, h)

    c = torch.from_numpy(rng.standard_normal((len(offsets),) + gs)).to(device=device, dtype=dtype)
    u, b, s = pad(rng.random(n)), pad(rng.random(n)), pad(0.1 * rng.random(n))
    for mode in tvs.MODES:
        before = tracing.counter("var_stencil_kernel_padded.launches")
        got = tvs.var_stencil_kernel_padded(u, c, offsets, gs, b_pad=b, scale_pad=s, mode=mode)
        assert tracing.counter("var_stencil_kernel_padded.launches") == before + 1
        want = tvs.var_stencil_plain(u, c, offsets, gs, b, s if mode == "sweep" else None, mode)
        torch.cuda.synchronize()
        gi, wi = tvs.var_from_padded(got, gs, h).double(), tvs.var_from_padded(want, gs, h).double()
        assert float((gi - wi).abs().max()) <= TOL[dtype] * float(wi.abs().max())
        shell = got.clone()
        shell[h[0]:h[0] + gs[0], h[1]:h[1] + gs[1], h[2]:h[2] + gs[2]] = 0
        assert torch.count_nonzero(shell) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs,offsets", [
    ((7, 5, 13), ((0, 0, 0), (-1, 0, 2), (1, 1, -3), (0, -1, 1), (2, 0, 0))),
    ((4, 9, 30), tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                       for dx in range(-5, 6))),
], ids=["5diag", "99diag"])
def test_k5_bf16_sweep_equals_plain(device, gs, offsets, dtype):
    """K5's sweep with bf16 coefficient planes beside a float32 or float64
    state: bit for bit its plain version (the planes widened exactly)."""
    rng = np.random.default_rng(12)
    h = tvs.halos_of(offsets)
    n = int(np.prod(gs))

    def pad(v):
        return tvs.var_to_padded(torch.from_numpy(v).to(device=device, dtype=dtype), gs, h)

    c = torch.from_numpy(rng.standard_normal((len(offsets),) + gs)).to(device=device,
                                                                       dtype=torch.bfloat16)
    u, b, s = pad(rng.random(n)), pad(rng.random(n)), pad(0.1 * rng.random(n))
    before = launches("var_stencil_kernel_padded.launches",
                      "var_stencil_kernel_padded.bf16_launches")
    got = tvs.var_stencil_kernel_padded(u, c, offsets, gs, b_pad=b, scale_pad=s, mode="sweep")
    assert launches("var_stencil_kernel_padded.launches",
                    "var_stencil_kernel_padded.bf16_launches") == (before[0] + 1, before[1] + 1)
    want = tvs.var_stencil_plain(u, c, offsets, gs, b, s, "sweep")
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    with pytest.raises(ValueError, match="bfloat16"):
        tvs.var_stencil_kernel_padded(u, c, offsets, gs, b_pad=b, mode="residual")


@pytest.fixture(scope="module")
def generic_24():
    """The classical host hierarchy of the 27-point Laplacian at 24^3 (default
    HierarchyParams: native HMIS, ext+i, L1-Jacobi)."""
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_host_hierarchy

    prob = laplacian_3d_27pt(24)
    return prob, build_host_hierarchy(prob.A, HierarchyParams())


@pytest.mark.parametrize("fmt", ["ell", "bsr_auto"])
def test_generic_solve_on_the_card_equals_the_cpu(device, generic_24, fmt):
    """The generic path at 24^3 in float64: the same cycles as the port on
    the CPU and the history to 1e-10."""
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, device_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import solve

    prob, hh = generic_24
    params = HierarchyParams(device_format=fmt)
    b = np.random.default_rng(0).random(prob.n)
    res = {}
    for dev in ("cpu", device):
        hier = device_hierarchy(hh, params, prob.stencil, device=dev)
        res[str(dev)] = solve(hier, CycleConfig(), torch.from_numpy(b), tol=1e-8, device=dev)
    cpu, gpu = res["cpu"], res[str(device)]
    assert gpu.iters == cpu.iters and float(gpu.rel_resnorm) <= 1e-8
    np.testing.assert_allclose(gpu.history_list(), cpu.history_list(), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_ell_and_bsr_spmv_on_the_card_equal_the_cpu(device, generic_24, dtype):
    from amg_tpu_torch.sparse.bsr import bsr_from_csr, choose_bsr_shape
    from amg_tpu_torch.sparse.ell import ell_from_csr

    _, hh = generic_24
    rng = np.random.default_rng(13)
    for m in (hh.levels[1].A, hh.levels[2].A, hh.levels[0].P, hh.levels[0].R):
        x = torch.from_numpy(rng.random(m.shape[1]))
        tiles = [(8, 8), (3, 5), choose_bsr_shape(m)[0]]
        mats = [lambda dev, dt: ell_from_csr(m, dtype=dt, device=dev)] + [
            lambda dev, dt, t=t: bsr_from_csr(m, bm=t[0], bn=t[1], dtype=dt, device=dev)
            for t in tiles]
        for make in mats:
            want = make("cpu", torch.float64) @ x
            got = make(device, dtype) @ x.to(device=device, dtype=dtype)
            torch.cuda.synchronize()
            err = float((got.double().cpu() - want).abs().max())
            assert err <= TOL[dtype] * float(want.abs().max())


def test_dia_fine_operator_runs_k5_in_float32_on_the_card(device):
    """device_hierarchy's DIA branch: a VarStencilOperator fine operator
    becomes K5's DiaKernelOperator on the card below float64 (and stays the
    plain VarStencilOperator in float64); its matvec equals the host CSR."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.setup.structured import (
        DiaKernelOperator,
        VarStencilOperator,
        csr_to_dia_stencil,
    )

    prob = elasticity_beam(12, 4, 4, bc="identity")
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape)
    x = np.random.default_rng(14).random(prob.n)
    want = prob.A @ x
    scale = np.abs(prob.A.to_scipy()) @ np.abs(x)  # the sum of |terms| of each row
    for dtype, kind in ((torch.float32, DiaKernelOperator), (torch.float64, VarStencilOperator)):
        _, hier = build_hierarchy(prob.A, HierarchyParams(num_functions=3, dtype=dtype),
                                  fine_stencil=vs, device=device)
        A0 = hier.levels[0].A
        assert type(A0) is kind
        got = (A0 @ torch.from_numpy(x).to(device=device, dtype=dtype)).double().cpu().numpy()
        assert np.abs(got - want).max() <= TOL[dtype] * scale.max()


def _additive_cfgs():
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType

    return {
        "multadd": CycleConfig(cycle=CycleType.MULTADD, use_smoothed_transfers=True),
        "afacx": CycleConfig(cycle=CycleType.AFACX),
        "afacj": CycleConfig(cycle=CycleType.AFACJ, afacj_level=0),
        "bpx": CycleConfig(cycle=CycleType.BPX),
        "mult_multadd": CycleConfig(cycle=CycleType.MULT_MULTADD, use_smoothed_transfers=True),
    }


@pytest.mark.parametrize("name", list(_additive_cfgs()))
def test_generic_additive_cycle_on_the_card_equals_the_cpu(device, generic_24, name):
    """One cycle of each additive type at 24^3 in float64, on the card and
    on the CPU (the P~/R~/P_id/R_id of `device_hierarchy` on both)."""
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, device_hierarchy
    from amg_tpu_torch.solve.cycles import cycle_step

    prob, hh = generic_24
    cfg = _additive_cfgs()[name]
    rng = np.random.default_rng(15)
    x, b = torch.from_numpy(rng.random(prob.n)), torch.from_numpy(rng.random(prob.n))
    want = cycle_step(device_hierarchy(hh, HierarchyParams(), prob.stencil, device="cpu"),
                      cfg, x, b)
    hier = device_hierarchy(hh, HierarchyParams(), prob.stencil, device=device)
    got = cycle_step(hier, cfg, x.to(device), b.to(device)).cpu()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))


class _HostDraws:
    """Every draw from one CPU generator, the FULL rows moved to the device:
    the same numbers whichever device the solve runs on."""

    def __init__(self, seed):
        from amg_tpu_torch.solve.async_sim import GeneratorDraws

        self.inner, self.gen = GeneratorDraws(seed), torch.Generator().manual_seed(seed)

    def wait_uniforms(self, L):
        return self.inner.wait_uniforms(L)

    def step(self, L):
        return self.inner.step(L)

    def read_scalar(self, lvl):
        return self.inner.read_scalar(lvl)

    def read_rows(self, lvl, n, dtype, device):
        return torch.rand(n, generator=self.gen, dtype=torch.float64).to(device=device,
                                                                          dtype=dtype)


@pytest.mark.parametrize("async_type", ["full", "semi"])
def test_async_solve_on_the_card_follows_the_cpu(device, generic_24, async_type):
    """async_multadd at 24^3 in float64 under the same draws on the card and
    on the CPU: the same steps, history to 1e-10 and grid waits."""
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, device_hierarchy
    from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
    from amg_tpu_torch.solve.driver import cheby_setup

    prob, hh = generic_24
    cfg = _additive_cfgs()["multadd"]
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    res = {}
    for dev in ("cpu", device):
        hier = device_hierarchy(hh, HierarchyParams(), prob.stencil, device=dev)
        c = cheby_setup(hier, cfg, num_iters=20, device=dev)
        acfg = AsyncConfig(async_type=async_type, accel="richardson", cheby_mu=c.mu,
                           cheby_delta=0.4 * c.delta)
        res[str(dev)] = async_solve(hier, cfg, acfg, b, draws=_HostDraws(4), tol=1e-8,
                                    max_cycles=400, device=dev)
    cpu, gpu = res["cpu"], res[str(device)]
    assert gpu.iters == cpu.iters and float(gpu.rel_resnorm) <= 1e-8
    np.testing.assert_allclose(gpu.history_list(), cpu.history_list(), rtol=1e-10, atol=1e-14)
    assert gpu.grid_wait.summary() == cpu.grid_wait.summary()


def test_async_smooth_on_the_card_follows_the_cpu(device, generic_24):
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, device_hierarchy
    from amg_tpu_torch.solve.async_smooth import (
        AsyncSmoothConfig,
        async_smooth_solve,
        block_neighbor_mask,
    )

    class Draws:
        def __init__(self):
            self.gen = torch.Generator().manual_seed(6)

        def step(self, B, dtype, device):
            return torch.rand(B, generator=self.gen, dtype=torch.float64).to(device, dtype)

    prob, hh = generic_24
    nbr = block_neighbor_mask(prob.A, 8)
    b = torch.from_numpy(np.random.default_rng(0).random(prob.n))
    res = {}
    for dev in ("cpu", device):
        lv = device_hierarchy(hh, HierarchyParams(), prob.stencil, device=dev).levels[0]
        res[str(dev)] = async_smooth_solve(lv.A, lv.sm, AsyncSmoothConfig(), nbr, b,
                                           draws=Draws(), tol=0.0, max_cycles=100, device=dev)
    cpu, gpu = res["cpu"], res[str(device)]
    assert gpu.block_updates.tolist() == cpu.block_updates.tolist()
    np.testing.assert_allclose(gpu.history_list(), cpu.history_list(), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
def test_jgs_dia_cycle_on_the_card_equals_the_cpu(device, dtype):
    """One hybrid-JGS V(2,2) cycle on the DIA beam: every sweep's residual is
    a K5 `residual` launch on the card (counted), the block solve torch.bmm;
    against the CPU (K5's plain version) to 1e-12 (float64) / 1e-5
    (float32) relative to the largest value."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.structured import build_dia_structured_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.cycles import CycleConfig, cycle_step

    prob = elasticity_beam(24, 6, 6, bc="identity")
    kw = dict(num_functions=3, dtype=dtype, smoother=SmootherType.HYBRID_JGS)
    _, h_cpu = build_dia_structured_hierarchy(prob.A, (25, 7, 7), device="cpu", **kw)
    _, h_gpu = build_dia_structured_hierarchy(prob.A, (25, 7, 7), device=device, **kw)
    cfg = CycleConfig(smoother=SmootherType.HYBRID_JGS, num_pre_sweeps=2, num_post_sweeps=2)
    b = torch.from_numpy(np.random.default_rng(16).random(prob.n)).to(dtype)
    want = cycle_step(h_cpu, cfg, torch.zeros_like(b), b)
    before = tracing.counter("var_stencil_kernel_padded.launches")
    bg = b.to(device)
    got = cycle_step(h_gpu, cfg, torch.zeros_like(bg), bg)
    torch.cuda.synchronize()
    assert (tracing.counter("var_stencil_kernel_padded.launches") - before
            >= 4 * (h_gpu.num_levels - 1))
    err = float((got.double().cpu() - want.double()).abs().max())
    assert err <= TOL[dtype] * float(want.double().abs().max())


def test_sa_pcg_on_the_card_equals_the_cpu(device):
    """SA-PCG (golden config8's recipe) on a 3-D beam in float64: the same
    iterations on the card and the CPU, the history to rtol 1e-6 (the beam's
    PCG turns rounding at 1e-16 into ~1e-8 over its iterations)."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import solve

    prob = elasticity_beam(16, 4, 4)
    params = HierarchyParams(num_functions=3, setup_type="sa")
    b = torch.from_numpy(prob.rhs / np.linalg.norm(prob.rhs))
    res = {}
    for dev in ("cpu", device):
        _, hier = build_hierarchy(prob.A, params, near_nullspace=prob.near_nullspace,
                                  device=dev)
        res[str(dev)] = solve(hier, CycleConfig(), b, tol=1e-8, outer="pcg", device=dev)
    cpu, gpu = res["cpu"], res[str(device)]
    assert gpu.iters == cpu.iters and float(gpu.rel_resnorm) <= 1e-8
    np.testing.assert_allclose(gpu.history_list(), cpu.history_list(), rtol=1e-6)


def test_ams_on_the_card_equals_the_cpu(device):
    """AMS-PCG and the async AMS solve (the same CPU-generator draws) on
    maxwell_curlcurl(6) in float64: the same iterations / steps on the card
    and the CPU, the histories to rtol 1e-8."""
    from amg_tpu_torch.convert import matrix_from_arrays
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, _format_converter
    from amg_tpu_torch.solve.ams import (
        GeneratorAMSDraws,
        ams_async_additive_solve,
        build_ams,
        solve_ams_pcg,
    )

    prob = maxwell_curlcurl(6)
    b = np.random.default_rng(0).random(prob.n)
    pcgs, asyncs = {}, {}
    for dev in ("cpu", device):
        ams, cfg = build_ams(prob.A, prob.aux["G"], Pi=prob.aux["Pi"], device=dev)
        A = matrix_from_arrays(_format_converter(HierarchyParams())(prob.A), torch.float64, dev)
        pcgs[str(dev)] = solve_ams_pcg(A, ams, cfg, b, device=dev)
        asyncs[str(dev)] = ams_async_additive_solve(A, ams, b, draws=GeneratorAMSDraws(3),
                                                    tol=1e-8, device=dev)
    for res in (pcgs, asyncs):
        cpu, gpu = res["cpu"], res[str(device)]
        assert gpu.iters == cpu.iters and float(gpu.rel_resnorm) <= 1e-8
        hc, hg = cpu.history.cpu().numpy(), gpu.history.cpu().numpy()
        np.testing.assert_allclose(hg[~np.isnan(hg)], hc[~np.isnan(hc)], rtol=1e-8, atol=1e-14)


def test_mixed_solve_on_the_card_equals_the_cpu(device):
    """mixed_solve on the generic 16^3 hierarchy in float32 against the
    float64 stencil: the same cycles on the card and the CPU, x to 1e-6."""
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.mixed import mixed_solve
    from amg_tpu_torch.sparse.stencil import StencilOperator

    prob = laplacian_3d_27pt(16)
    b = np.random.default_rng(0).random(prob.n)
    res = {}
    for dev in ("cpu", device):
        _, hier = build_hierarchy(prob.A, HierarchyParams(dtype=torch.float32),
                                  fine_stencil=prob.stencil, device=dev)
        A64 = StencilOperator(weights=prob.stencil.weights.to(dev), offsets=prob.stencil.offsets,
                              grid_shape=prob.stencil.grid_shape)
        res[str(dev)] = mixed_solve(hier, A64, CycleConfig(), b, tol=1e-8, device=dev)
    cpu, gpu = res["cpu"], res[str(device)]
    assert gpu.iters == cpu.iters and gpu.rel_resnorm <= 1e-8
    x = cpu.x.numpy()
    assert np.linalg.norm(gpu.x.cpu().numpy() - x) <= 1e-6 * np.linalg.norm(x)


def test_run_experiment_struct_on_the_card_equals_the_cpu(device):
    """The runner's structured 27-point solve at 64^3 (the smallest side whose
    path launches K3 and K4: the zero-guess pair at the 32^3 constant level;
    the fine level fuses its transfers from 96 up): on the card through
    struct_solve (K1 box, K3, K4 launched), on the CPU through the plain
    cycle; the same cycles and x within 1e-10."""
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    opts = dict(problem="27pt", n=64, hierarchy="structured")
    cpu = run_experiment(SolverOptions(**opts), device="cpu")
    before = launches("stencil_kernel_padded.launches",
                      "residual_restrict_padded.launches",
                      "prolong_sweep_padded.launches")
    gpu = run_experiment(SolverOptions(**opts), device=device)
    after = launches("stencil_kernel_padded.launches",
                     "residual_restrict_padded.launches",
                     "prolong_sweep_padded.launches")
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert gpu.cycles == cpu.cycles and gpu.rel_resnorm <= 1e-8
    assert gpu.level_n == cpu.level_n and gpu.level_nnz == cpu.level_nnz
    x = cpu.x.numpy()
    assert np.linalg.norm(gpu.x.cpu().numpy() - x) <= 1e-10 * np.linalg.norm(x)


def test_run_experiment_config10_on_the_card(device):
    """Golden config10's options (the 49,179-dof beam, float32 DIA hierarchy
    under mixed_pcg) through the runner on the card: K5 launched, the
    golden's level sizes, 20 +- 1 iterations (ROADMAP F1), a true float64
    residual <= 1e-5."""
    import json
    import os

    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                           "config10_elasticity_dia_mixed.json")) as f:
        g = json.load(f)
    c = g["config"]
    before = tracing.counter("var_stencil_kernel_padded.launches")
    st = run_experiment(SolverOptions(**c), device=device)
    assert tracing.counter("var_stencil_kernel_padded.launches") > before
    assert st.level_n == g["level_n"] and st.level_nnz == g["level_nnz"]
    assert abs(st.cycles - g["cycles"]) <= 1
    prob = elasticity_beam(nx=c["nx"], ny=c["ny"], nz=c["nz"], bc=c["elast_bc"])
    b = prob.rhs / np.linalg.norm(prob.rhs)
    x = st.x.cpu().numpy()
    assert np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b) <= 1e-5
