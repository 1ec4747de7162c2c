"""The CUDA kernels K1, K3 and K4 of the PyTorch port against their plain
PyTorch versions, on the card, at ragged shapes that the 126^3 main path does
not give them (odd sides, X not a multiple of any block width).

Marked `cuda`; without a card every test skips. On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances: float64 to 1e-12 and float32 to 1e-5, relative to the largest
interior value (the kernels fuse multiply-adds and sum in their own order);
the zero shell exactly.
"""

import numpy as np
import pytest
import torch

from amg_tpu_torch.ops import stencil as ts
from amg_tpu_torch.ops import transfer as tt

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("gs", SHAPES, ids=str)
def test_k1_matches_plain(device, gs, dtype):
    rng = np.random.default_rng(0)
    w, offs = _taps(1)
    taps = ts.taps_of(w, offs)
    u, b = _pad(rng, gs, dtype, device), _pad(rng, gs, dtype, device)
    s = 0.02 * _pad(rng, gs, dtype, device)
    for mode in ts.MODES:
        before = ts.stencil_kernel_padded.launches
        got = ts.stencil_kernel_padded(u, b, w, gs, offs, alpha=0.03, scale_pad=s, mode=mode)
        assert ts.stencil_kernel_padded.launches == before + 1
        want = ts.stencil_plain(u, b, taps, gs, 0.03, s if "vec" in mode else None, mode)
        if mode == "sweep_vec_norm":
            (got, gn), (want, wn) = got, want
            assert abs(float(gn.double().sum()) - float(wn.double().sum())) <= (
                TOL[dtype] * float(wn.double().sum()))
        _check(got, want, gs, dtype)


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
