"""K3 and K4: the fused transfer kernels (counterpart of
amg_tpu/ops/pallas_transfer.py; the CUDA kernels are `csrc/transfer.cu`
(K3) and `csrc/prolong_march.cu` (K4)).

    residual_restrict_padded:  rc = R (b - A x)           (K3)
    prolong_sweep_padded:      u' = x + P ec;  out = u' + s (b - A u')   (K4)

with x the iterate, or under `zero_guess` the zero-guess pre-sweep s*b
(alpha*b): a coarse level's whole V(1,1) visit is one K3 and one K4 launch.
Fine arrays are in the padded layout of `ops.stencil`, coarse arrays in the
padded layout of the coarse grid. R is full weighting ({1/2, 1, 1/2} per axis),
P trilinear, for the standard (s+1)//2 coarsening only.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
PyTorch version for a CPU tensor; there is no other fallback. The plain
transfers (`restrict_padded`, `prolong_padded`) are strided slices and also
serve the unfused branches of `solve.struct_cycle`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from amg_tpu_torch.ops import _build
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.ops.stencil import (
    check_aligned,
    check_dtype_device,
    check_state,
    padded_shape,
    stencil_plain,
    tap_arrays,
    tap_route,
    taps_of,
    uniform_box_weights,
    zmarch_plan,
)


def coarse_shape_of(grid_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    return tuple((s + 1) // 2 for s in grid_shape)


def transfer_fuse_ok(grid_shape, coarse_shape, offsets) -> bool:
    """True when the fused transfer kernels apply at this level: standard
    (s+1)//2 coarsening on every axis and a reach-1 stencil (the structural
    conditions of the reference's transfer_fuse_ok; its slab and VMEM terms
    are TPU tuning and have no counterpart here)."""
    if tuple(coarse_shape) != coarse_shape_of(grid_shape):
        return False
    return all(max(abs(int(d)) for d in o) <= 1 for o in offsets)


def _restrict_axis(g: torch.Tensor, axis: int, sc: int) -> torch.Tensor:
    """Coarse interior c <- 1/2 g[2c] + g[2c+1] + 1/2 g[2c+2] along `axis`
    (padded fine indices; the zero shell clips the edges)."""
    g = torch.movedim(g, axis, 0)
    out = 0.5 * g[0:2 * sc - 1:2] + g[1:2 * sc:2] + 0.5 * g[2:2 * sc + 1:2]
    return torch.movedim(out, 0, axis)


def _prolong_axis(g: torch.Tensor, axis: int, sf: int) -> torch.Tensor:
    """Fine interior f <- coarse f/2 (even f) or the mean of coarse (f-1)/2 and
    (f+1)/2 (odd f), along `axis` of a padded coarse array."""
    g = torch.movedim(g, axis, 0)
    ne, no = (sf + 1) // 2, sf // 2
    out = g.new_empty((sf,) + tuple(g.shape[1:]))
    out[0::2] = g[1:1 + ne]
    out[1::2] = 0.5 * (g[1:1 + no] + g[2:2 + no])
    return torch.movedim(out, 0, axis)


def restrict_padded(r_pad: torch.Tensor, grid_shape) -> torch.Tensor:
    """Full-weighting restriction, padded fine (zero shell) -> padded coarse."""
    cs = coarse_shape_of(grid_shape)
    g = r_pad
    for d in range(3):
        g = _restrict_axis(g, d, cs[d])
    out = r_pad.new_zeros(padded_shape(cs))
    out[1:cs[0] + 1, 1:cs[1] + 1, 1:cs[2] + 1] = g
    return out


def prolong_padded(ec_pad: torch.Tensor, grid_shape, axes=(0, 1, 2)) -> torch.Tensor:
    """Trilinear prolongation, padded coarse (zero shell) -> padded fine,
    one axis after the other in the order `axes`; each mean of two values is
    one rounded 0.5 * (a + b), so the order decides the float rounding."""
    Z, Y, X = grid_shape
    g = ec_pad
    for d in axes:
        g = _prolong_axis(g, d, grid_shape[d])
    out = ec_pad.new_zeros(padded_shape(grid_shape))
    out[1:Z + 1, 1:Y + 1, 1:X + 1] = g
    return out


def _zero_guess_iterate(b_pad, scale_pad, alpha):
    """The single zero-guess pre-sweep x = s*b (alpha*b when alpha != 0)."""
    return b_pad * scale_pad if alpha == 0.0 else alpha * b_pad


def residual_restrict_plain(u_pad, b_pad, taps, grid_shape, zero_guess=False,
                            scale_pad=None, alpha=0.0):
    """Plain PyTorch version of K3."""
    x = _zero_guess_iterate(b_pad, scale_pad, alpha) if zero_guess else u_pad
    r_pad = stencil_plain(x, b_pad, taps, grid_shape, mode="residual")
    return restrict_padded(r_pad, grid_shape)


# K4 prolongs as the reference's _ps_kernel does: each coarse plane in y,
# then in x (its MXU expansion), then each fine plane as the z-mean of two
# expanded planes
K4_AXES = (1, 2, 0)


def prolong_sweep_plain(x_pad, b_pad, ec_pad, taps, grid_shape, alpha=0.0,
                        scale_pad=None, zero_guess=False):
    """Plain PyTorch version of K4: u' = x + P ec with P in K4_AXES order,
    then one sweep of `stencil_plain` (the uniform box summed separably,
    other taps in list order)."""
    if zero_guess:
        x_pad = _zero_guess_iterate(b_pad, scale_pad, alpha)
    u2 = x_pad + prolong_padded(ec_pad, grid_shape, K4_AXES)
    if alpha != 0.0:
        return stencil_plain(u2, b_pad, taps, grid_shape, alpha, None, "sweep")
    return stencil_plain(u2, b_pad, taps, grid_shape, 0.0, scale_pad, "sweep_vec")


_SIGNATURES = {
    "amg_k3_launch": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.POINTER(ctypes.c_double)] + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 17 + [ctypes.c_double, ctypes.c_void_p],
    ),
}
_K4_SIGNATURES = {
    "amg_k4_launch": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.POINTER(ctypes.c_double)] + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 2 + [ctypes.c_double] * 2 + [ctypes.c_int] * 14
        + [ctypes.c_double, ctypes.c_void_p],
    ),
}


# K3's launch plan. K3_TILE mirrors the coarse (y, x) columns of one block in
# csrc/transfer.cu (k3BY, k3BX), which refuses a plan that does not cover the
# padded coarse array with it. A block walks up to K3_MAX_ZCHUNK coarse
# z-planes; the chunk is the longest that still gives K3_MIN_BLOCKS blocks
# (two per SM of the H100's 132), else one plane.
K3_TILE = (8, 16)
K3_MAX_ZCHUNK = 4
K3_MIN_BLOCKS = 2 * 132


def k3_plan(grid_shape) -> Tuple[int, Tuple[int, int, int]]:
    """(zchunk, (gx, gy, gz)) of K3's launch for a fine interior grid_shape:
    block (bx, by, bz) owns the padded coarse columns bx*16 .. +15 (x) and
    by*8 .. +7 (y) of coarse planes bz*zchunk .. +zchunk-1."""
    Zcr, Ycr, Xcr = padded_shape(coarse_shape_of(grid_shape))
    gx, gy = math.ceil(Xcr / K3_TILE[1]), math.ceil(Ycr / K3_TILE[0])
    zchunk = 1
    for zc in range(K3_MAX_ZCHUNK, 1, -1):
        if math.ceil(Zcr / zc) * gx * gy >= K3_MIN_BLOCKS:
            zchunk = zc
            break
    return zchunk, (gx, gy, math.ceil(Zcr / zchunk))


def k3_bytes(grid_shape, dtype: torch.dtype, zero_guess: bool, scaled: bool) -> int:
    """Bytes K3 must move, each padded stream once: u and b (or under
    zero_guess b, and s when `scaled`) read, the padded coarse rc written."""
    item = torch.empty((), dtype=dtype).element_size()
    fine = math.prod(padded_shape(grid_shape))
    coarse = math.prod(padded_shape(coarse_shape_of(grid_shape)))
    reads = 1 + (scaled if zero_guess else 1)
    return (reads * fine + coarse) * item


def k4_plan(grid_shape) -> Tuple[int, Tuple[int, int, int]]:
    """(zchunk, (gx, gy, gz)) of K4's launch for a fine interior grid_shape
    (ops/stencil.py::zmarch_plan, the plan K4 shares with K1's tap list)."""
    return zmarch_plan(grid_shape)


def k4_bytes(grid_shape, dtype: torch.dtype, zero_guess: bool, scaled: bool) -> int:
    """Bytes K4 must move, each padded stream once: x (not under zero_guess),
    b and s (when `scaled`) and the padded coarse ec read, out written."""
    item = torch.empty((), dtype=dtype).element_size()
    fine = math.prod(padded_shape(grid_shape))
    coarse = math.prod(padded_shape(coarse_shape_of(grid_shape)))
    fine_streams = (0 if zero_guess else 1) + 1 + scaled + 1
    return (fine_streams * fine + coarse) * item


def _check_transfer(grid_shape, offsets):
    if not transfer_fuse_ok(grid_shape, coarse_shape_of(grid_shape), offsets):
        raise ValueError("fused transfers need (s+1)//2 coarsening and reach-1 taps")


def _count_products() -> None:
    """K3 and K4 each compute one product with A and one transfer, on
    every route (`utils.tracing`'s `spmv.*`)."""
    tracing.count("spmv.stencil_kernel")
    tracing.count("spmv.transfer")


def residual_restrict_padded(
    u_pad, b_pad, weights, grid_shape, offsets, zero_guess: bool = False,
    scale_pad=None, alpha: float = 0.0,
):
    """K3: rc_pad = R (b - A u), padded fine u, b -> padded COARSE rhs.

    zero_guess=True folds the single zero-guess pre-sweep in as well:
    rc_pad = R (b - A (s b)), or A (alpha b) when alpha != 0 (u_pad is
    ignored and may be None; scale_pad is read only when alpha == 0)."""
    _check_transfer(grid_shape, offsets)
    taps = taps_of(weights, offsets)
    check_dtype_device(b_pad)
    shape = padded_shape(grid_shape)
    check_state("b_pad", b_pad, b_pad, shape)
    if zero_guess:
        u_pad = None
        if alpha == 0.0:
            check_state("scale_pad", scale_pad, b_pad, shape)
        else:
            scale_pad = None
    else:
        check_state("u_pad", u_pad, b_pad, shape)
        scale_pad, alpha = None, 0.0
    _count_products()
    if b_pad.device.type == "cpu":
        return residual_restrict_plain(
            u_pad, b_pad, taps, grid_shape, zero_guess, scale_pad, alpha
        )
    check_aligned("K3", u_pad=u_pad, b_pad=b_pad, scale_pad=scale_pad)
    lib = _build.load("transfer", _SIGNATURES)
    Z, Y, X = grid_shape
    cs = coarse_shape_of(grid_shape)
    rc = b_pad.new_empty(padded_shape(cs))
    w, dz, dy, dx, n = tap_arrays(taps)
    zchunk, grid = k3_plan(grid_shape)
    _build.launch(
        lib.amg_k3_launch, "residual-restrict kernel (K3)", b_pad.device,
        int(b_pad.dtype == torch.float64), _build.ptr(u_pad), _build.ptr(b_pad),
        _build.ptr(scale_pad), _build.ptr(rc), w, dz, dy, dx, n, Z, Y, X, shape[1],
        shape[2], *cs, *rc.shape, int(zero_guess), *grid, zchunk, float(alpha),
    )
    tracing.count("residual_restrict_padded.launches")
    return rc



def _launch_k4(x_pad, b_pad, scale_pad, ec_pad, taps, grid_shape, alpha, zero_guess,
               plan=None):
    """K4's kernel under k4_plan's plan unless `plan` is given, on the route
    that tap_route picks; every route sums as the plain version does."""
    check_aligned("K4", x_pad=x_pad, b_pad=b_pad, scale_pad=scale_pad, ec_pad=ec_pad)
    lib = _build.load("prolong_march", _K4_SIGNATURES)
    Z, Y, X = grid_shape
    zchunk, grid = k4_plan(grid_shape) if plan is None else plan
    out = torch.empty_like(b_pad)
    w, dz, dy, dx, n = tap_arrays(taps)
    box = uniform_box_weights(taps)
    w_off, w_c = box if box is not None else (0.0, 0.0)
    _build.launch(
        lib.amg_k4_launch, "prolong-sweep kernel (K4)", b_pad.device,
        int(b_pad.dtype == torch.float64), _build.ptr(x_pad), _build.ptr(b_pad),
        _build.ptr(scale_pad), _build.ptr(ec_pad), _build.ptr(out), w, dz, dy, dx, n,
        tap_route(taps), float(w_off), float(w_c - w_off), Z, Y, X, *b_pad.shape,
        *ec_pad.shape, int(zero_guess), *grid, zchunk, float(alpha),
    )
    return out


def prolong_sweep_padded(
    x_pad, b_pad, ec_pad, weights, grid_shape, offsets,
    alpha: float = 0.0, scale_pad=None, zero_guess: bool = False,
):
    """K4: one fused (prolong + correction-add + smoother sweep) pass,

        u' = x + P ec;   out = u' + s (b - A u')

    x_pad/b_pad in padded fine layout, ec_pad in padded COARSE layout.
    alpha != 0 selects the scalar-weight sweep (no scale stream).
    zero_guess=True substitutes x = s*b (or alpha*b); x_pad is ignored."""
    _check_transfer(grid_shape, offsets)
    taps = taps_of(weights, offsets)
    check_dtype_device(b_pad)
    shape = padded_shape(grid_shape)
    check_state("b_pad", b_pad, b_pad, shape)
    check_state("ec_pad", ec_pad, b_pad, padded_shape(coarse_shape_of(grid_shape)))
    if zero_guess:
        x_pad = None
    else:
        check_state("x_pad", x_pad, b_pad, shape)
    if alpha == 0.0:
        check_state("scale_pad", scale_pad, b_pad, shape)
    else:
        scale_pad = None
    _count_products()
    if b_pad.device.type == "cpu":
        return prolong_sweep_plain(
            x_pad, b_pad, ec_pad, taps, grid_shape, alpha, scale_pad, zero_guess
        )
    out = _launch_k4(x_pad, b_pad, scale_pad, ec_pad, taps, grid_shape, alpha, zero_guess)
    tracing.count("prolong_sweep_padded.launches")
    return out
