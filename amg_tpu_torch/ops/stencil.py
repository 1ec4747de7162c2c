"""K1 and K2: the constant-weight stencil kernels on the padded state
(counterpart of amg_tpu/ops/pallas_stencil.py). Their CUDA kernels, both
z-marches: `csrc/box_march.cu` for the uniform 27-point box (K1's modes at
K = 1, K2's at K = 2..4: one template) and `csrc/tap_march.cu` for K1 on any
other reach-1 tap list (the RAP coarse levels), with a route of its own for
the 27 taps in product order (`tap_route`).

K1 takes the modes of MODES; K2 the modes of SWEEPK_MODES, K = 2, 3 or 4
fused weighted-Jacobi sweeps of the uniform 27-point box in one launch, equal
to K chained K1 `sweep`/`sweep_vec` launches bit for bit.

The uniform box is summed separably, as the reference's kernels sum it:
A u = w_off * boxsum(u) + (w_c - w_off) * u, the box sum along z as
(m + c) + p, then along y and x as (c + m) + p. Every other tap list is
summed in list order.

State layout: a grid of interior shape (Z, Y, X) is stored as a dense
(Z+2, Y+2, Xr) array, Xr = X+2 rounded up to a multiple of 4 (16-byte float32
rows). The one-cell zero shell is the homogeneous-Dirichlet truncation of the
assembled operator and is kept by construction (every mode writes 0 off the
interior). The reference's TPU alignment (128 lanes, Y to 8, Z to the slab)
is not carried over, so there is no slab.

`stencil_kernel_padded` launches the CUDA kernel for a CUDA tensor and runs
the plain PyTorch version `stencil_plain` for a CPU tensor; there is no other
fallback.
"""

from __future__ import annotations

import ctypes
import itertools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from amg_tpu_torch.ops import _build
from amg_tpu_torch.utils import tracing

MODES = ("spmv", "residual", "sweep", "sweep_vec", "sweep_vec_norm")
SWEEPK_MODES = tuple(f"sweep{k}{v}" for v in ("", "_vec") for k in (2, 3, 4))
_X_ALIGN = 4


def padded_shape(grid_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """(Zr, Yr, Xr) storage shape for interior grid_shape=(Z, Y, X)."""
    Z, Y, X = grid_shape
    return (Z + 2, Y + 2, -(-(X + 2) // _X_ALIGN) * _X_ALIGN)


def to_padded(x: torch.Tensor, grid_shape) -> torch.Tensor:
    """Embed a flat interior vector into the zero-shelled padded layout."""
    Z, Y, X = grid_shape
    Xr = padded_shape(grid_shape)[2]
    return F.pad(x.reshape(Z, Y, X), (1, Xr - X - 1, 1, 1, 1, 1))


def from_padded(p: torch.Tensor, grid_shape) -> torch.Tensor:
    Z, Y, X = grid_shape
    return p[1:Z + 1, 1:Y + 1, 1:X + 1].reshape(Z * Y * X)


def taps_of(weights, offsets) -> tuple:
    """((dz, dy, dx, w), ...) in the caller's order; the kernels take reach-1
    tap lists of at most 27 taps."""
    if len(weights) != len(offsets) or len(offsets) > 27:
        raise ValueError(
            f"need one weight per offset and at most 27 taps, got {len(weights)} "
            f"weights for {len(offsets)} offsets"
        )
    taps = tuple(
        (int(o[0]), int(o[1]), int(o[2]), float(w)) for o, w in zip(offsets, weights)
    )
    if any(max(abs(t[0]), abs(t[1]), abs(t[2])) > 1 for t in taps):
        raise ValueError("the padded stencil kernels take reach-1 offsets only")
    return taps


def uniform_box_weights(taps):
    """(w_off, w_center) if taps form the full 3x3x3 box with one uniform
    off-center weight (the 27-pt Laplacian shape); else None."""
    if len(taps) != 27:
        return None
    offs = {(dz, dy, dx): w for dz, dy, dx, w in taps}
    if len(offs) != 27 or (0, 0, 0) not in offs:
        return None
    w_off = None
    for key, w in offs.items():
        if key == (0, 0, 0):
            continue
        if w_off is None:
            w_off = w
        elif w != w_off:
            return None
    return w_off, offs[(0, 0, 0)]


_PRODUCT27 = tuple(itertools.product((-1, 0, 1), repeat=3))


def tap_route(taps) -> int:
    """The route of a tap list in the z-marching kernels (K1's and K4's enum
    Route): 1 the uniform box, 2 the 27 taps at (-1, 0, 1)^3 in product order
    (the RAP levels' layout, whatever the weights), 0 any other list."""
    if uniform_box_weights(taps) is not None:
        return 1
    return 2 if tuple(t[:3] for t in taps) == _PRODUCT27 else 0


def check_state(name: str, t, like: torch.Tensor, shape, dtype=None) -> None:
    """Raise unless `t` is a contiguous tensor of `like`'s device and dtype
    (or `dtype` when given) with the given padded shape."""
    dtype = like.dtype if dtype is None else dtype
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype or t.device != like.device:
        raise ValueError(
            f"{name}: dtype/device {t.dtype}/{t.device} differ from "
            f"{dtype}/{like.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != padded shape {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_dtype_device(t: torch.Tensor) -> None:
    if t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the kernels take float32 or float64, got {t.dtype}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")


def tap_arrays(taps):
    """ctypes arrays (weights, dz, dy, dx) of a tap list, for the C entries."""
    n = len(taps)
    return (
        (ctypes.c_double * 27)(*[t[3] for t in taps]),
        (ctypes.c_int * 27)(*[t[0] for t in taps]),
        (ctypes.c_int * 27)(*[t[1] for t in taps]),
        (ctypes.c_int * 27)(*[t[2] for t in taps]),
        n,
    )


def apply_plain(u_pad: torch.Tensor, taps, grid_shape) -> torch.Tensor:
    """A u on the interior, (Z, Y, X): the uniform box separably (see the
    module's docstring), any other taps in list order."""
    Z, Y, X = grid_shape
    box = uniform_box_weights(taps)
    if box is not None:
        w_off, w_c = box
        u = u_pad[:, :, :X + 2]
        t = (u[0:Z] + u[1:Z + 1]) + u[2:Z + 2]
        t = (t[:, 1:Y + 1] + t[:, 0:Y]) + t[:, 2:Y + 2]
        t = (t[..., 1:X + 1] + t[..., 0:X]) + t[..., 2:X + 2]
        return w_off * t + (w_c - w_off) * u[1:Z + 1, 1:Y + 1, 1:X + 1]
    acc = torch.zeros((Z, Y, X), dtype=u_pad.dtype, device=u_pad.device)
    for dz, dy, dx, w in taps:
        acc = acc + w * u_pad[1 + dz:1 + dz + Z, 1 + dy:1 + dy + Y, 1 + dx:1 + dx + X]
    return acc


def stencil_plain(u_pad, b_pad, taps, grid_shape, alpha=0.0, scale_pad=None, mode="spmv"):
    """Plain PyTorch version of K1 (same modes and outputs)."""
    Z, Y, X = grid_shape
    acc = apply_plain(u_pad, taps, grid_shape)
    inner = (slice(1, Z + 1), slice(1, Y + 1), slice(1, X + 1))
    norm = None
    if mode == "spmv":
        val = acc
    elif mode == "residual":
        val = b_pad[inner] - acc
    elif mode == "sweep":
        val = u_pad[inner] + alpha * (b_pad[inner] - acc)
    elif mode == "sweep_vec":
        val = u_pad[inner] + scale_pad[inner] * (b_pad[inner] - acc)
    elif mode == "sweep_vec_norm":
        r = b_pad[inner] - acc
        val = u_pad[inner] + scale_pad[inner] * r
        norm = torch.sum(r * r).reshape(1)
    else:
        raise ValueError(mode)
    out = torch.zeros_like(u_pad)
    out[inner] = val
    return out if norm is None else (out, norm)


def sweepk_plain(u_pad, b_pad, taps, grid_shape, nsweep, alpha=0.0, scale_pad=None):
    """Plain PyTorch version of K2: `nsweep` applications of the plain K1
    sweep (scalar alpha) or sweep_vec (scale_pad)."""
    mode = "sweep" if scale_pad is None else "sweep_vec"
    for _ in range(nsweep):
        u_pad = stencil_plain(u_pad, b_pad, taps, grid_shape, alpha, scale_pad, mode)
    return u_pad


# The box march's launch plan. BOX_TILE mirrors the (y, x) output tile of one
# block in csrc/box_march.cu (kTY, kTX), which refuses a plan that does not
# cover the padded array with it. The planes go in the fewest chunks (each
# at most BOX_MAX_ZCHUNK planes) that keep the blocks within
# box_max_blocks(K): eight per SM of the H100's 132 at K = 1, four at K >= 2,
# about as many as the card holds at once (the blocks at K >= 2 hold more
# rings and registers). More blocks than that run as a partial second wave,
# and fewer, longer chunks leave the SMs short of warps; each chunk also
# warms up over 3(K-1) extra planes. Measured with tools/torch_box_variants.py.
BOX_TILE = (8, 32)
BOX_MAX_ZCHUNK = 32


# The launch plan of the z-marching kernels on 32x8 tiles: K1's tap-list
# route (csrc/tap_march.cu) and K4 (csrc/prolong_march.cu). ZMARCH_TILE
# mirrors their (y, x) output tile (kTY, kTX); each kernel refuses a plan
# that does not cover the padded array with it. The plan takes the longest
# chunk, up to ZMARCH_MAX_ZCHUNK planes, that still gives ZMARCH_MIN_BLOCKS
# blocks (three per SM of the H100's 132: a wave the card holds at once),
# else chunks of one plane. Fewer, longer chunks leave the SMs short of
# blocks, more blocks than fit run as a second wave, and each chunk warms up
# over its halo planes. For K1's taps that is 4-plane chunks (459 blocks) at
# 63^3 and one-plane chunks (340) at 32^3; for K4 16-plane chunks (512
# blocks) at 126^3, 4 at 63^3 and 1 at 32^3, within 6% of the fastest chunk
# lengths measured there with tools/torch_k4_variants.py.
ZMARCH_TILE = (8, 32)
ZMARCH_MAX_ZCHUNK = 16
ZMARCH_MIN_BLOCKS = 3 * 132


def zmarch_plan(grid_shape) -> Tuple[int, Tuple[int, int, int]]:
    """(zchunk, (gx, gy, gz)) of a z-march over the padded array of interior
    grid_shape: block (bx, by, bz) owns the padded columns bx*32 .. +31 (x)
    and rows by*8 .. +7 (y) of planes bz*zchunk .. +zchunk-1."""
    Zr, Yr, Xr = padded_shape(grid_shape)
    gx, gy = math.ceil(Xr / ZMARCH_TILE[1]), math.ceil(Yr / ZMARCH_TILE[0])
    zchunk = 1
    for zc in range(ZMARCH_MAX_ZCHUNK, 1, -1):
        if math.ceil(Zr / zc) * gx * gy >= ZMARCH_MIN_BLOCKS:
            zchunk = zc
            break
    return zchunk, (gx, gy, math.ceil(Zr / zchunk))


def k1_taps_plan(grid_shape) -> Tuple[int, Tuple[int, int, int]]:
    """(zchunk, (gx, gy, gz)) of K1's tap-list launch for interior grid_shape."""
    return zmarch_plan(grid_shape)


def box_max_blocks(nsweep: int) -> int:
    return (8 if nsweep == 1 else 4) * 132


def box_plan(grid_shape, nsweep: int = 1) -> Tuple[int, Tuple[int, int, int]]:
    """(zchunk, (gx, gy, gz)) of the box march of `nsweep` sweeps for interior
    grid_shape: block (bx, by, bz) owns the padded columns bx*32 .. +31 (x)
    and by*8 .. +7 (y) of planes bz*zchunk .. +zchunk-1."""
    Zr, Yr, Xr = padded_shape(grid_shape)
    gx, gy = math.ceil(Xr / BOX_TILE[1]), math.ceil(Yr / BOX_TILE[0])
    chunks = max(1, box_max_blocks(nsweep) // (gx * gy))
    zchunk = min(BOX_MAX_ZCHUNK, math.ceil(Zr / chunks))
    return zchunk, (gx, gy, math.ceil(Zr / zchunk))


_BOX_SIGNATURES = {
    "amg_box_launch": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_double] * 3
        + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    ),
}


def check_aligned(what, **tensors):
    """Raise unless every tensor given (None: skipped) is 16-byte aligned,
    as the z-marching kernels' 16-byte copies need."""
    for name, t in tensors.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} copies 16-byte chunks and needs a 16-byte-"
                             f"aligned tensor (a view at an offset is not)")


def _launch_box(u_pad, b_pad, scale_pad, box, grid_shape, alpha, mode, nsweep, plan=None):
    """The box march: K1 `mode` (nsweep 1) or K2 (nsweep 2..4, mode sweep or
    sweep_vec) on the uniform box (w_off, w_c), under box_plan's plan unless
    `plan` is given."""
    check_aligned("the box march", u_pad=u_pad, b_pad=b_pad, scale_pad=scale_pad)
    lib = _build.load("box_march", _BOX_SIGNATURES)
    Z, Y, X = grid_shape
    zchunk, grid = box_plan(grid_shape, nsweep) if plan is None else plan
    out = torch.empty_like(u_pad)
    partials = None
    if mode == "sweep_vec_norm":
        partials = u_pad.new_empty(math.prod(grid))
    w_off, w_c = box
    _build.launch(
        lib.amg_box_launch, "box march (K1/K2)", u_pad.device,
        int(u_pad.dtype == torch.float64), _build.ptr(u_pad), _build.ptr(b_pad),
        _build.ptr(scale_pad), _build.ptr(out), _build.ptr(partials), float(w_off),
        float(w_c - w_off), float(alpha), Z, Y, X, *u_pad.shape, nsweep, MODES.index(mode),
        *grid, zchunk,
    )
    return out if partials is None else (out, partials)


_TAP_SIGNATURES = {
    "amg_k1_taps_launch": (
        ctypes.c_int,
        [ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.POINTER(ctypes.c_double)] + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 13 + [ctypes.c_double, ctypes.c_void_p],
    ),
}


def _launch_taps(u_pad, b_pad, scale_pad, taps, grid_shape, alpha, mode, plan=None):
    """K1's tap-list z-march (csrc/tap_march.cu) on the route that tap_route
    picks (2 or 0), under k1_taps_plan's plan unless `plan` is given."""
    check_aligned("K1's tap-list route", u_pad=u_pad, b_pad=b_pad, scale_pad=scale_pad)
    lib = _build.load("tap_march", _TAP_SIGNATURES)
    Z, Y, X = grid_shape
    zchunk, grid = k1_taps_plan(grid_shape) if plan is None else plan
    out = torch.empty_like(u_pad)
    partials = u_pad.new_empty(math.prod(grid)) if mode == "sweep_vec_norm" else None
    w, dz, dy, dx, n = tap_arrays(taps)
    _build.launch(
        lib.amg_k1_taps_launch, "stencil kernel (K1, tap list)", u_pad.device,
        int(u_pad.dtype == torch.float64), _build.ptr(u_pad), _build.ptr(b_pad),
        _build.ptr(scale_pad), _build.ptr(out), _build.ptr(partials), w, dz, dy, dx, n,
        tap_route(taps), Z, Y, X, *u_pad.shape, MODES.index(mode), *grid, zchunk, float(alpha),
    )
    return out if partials is None else (out, partials)


def _launch_k1(u_pad, b_pad, scale_pad, taps, grid_shape, alpha, mode):
    box = uniform_box_weights(taps)
    if box is not None:
        out = _launch_box(u_pad, b_pad, scale_pad, box, grid_shape, alpha, mode, 1)
    else:
        out = _launch_taps(u_pad, b_pad, scale_pad, taps, grid_shape, alpha, mode)
        tracing.count("stencil_kernel_padded.tap_launches")
    tracing.count("stencil_kernel_padded.launches")
    return out


def _launch_k2(u_pad, b_pad, scale_pad, taps, grid_shape, alpha, nsweep):
    mode = "sweep" if scale_pad is None else "sweep_vec"
    out = _launch_box(u_pad, b_pad, scale_pad, uniform_box_weights(taps), grid_shape,
                      alpha, mode, nsweep)
    tracing.count("stencil_kernel_padded.k2_launches")
    return out


def stencil_kernel_padded(
    u_pad, b_pad, weights, grid_shape, offsets,
    alpha: float = 0.0, scale_pad=None, mode: str = "spmv",
):
    """K1 or K2 on padded-layout state.

    K1 (MODES): y = A u, b - A u, u + alpha (b - A u), u + s (b - A u), or
    the latter plus the partial sums of r^2 of the incoming residual
    (returns (out, partials); sum them). b_pad may be None in spmv mode;
    scale_pad is read by the _vec modes.

    K2 (SWEEPK_MODES, `sweep<K>` with alpha, `sweep<K>_vec` with scale_pad):
    K sweeps in one launch; the taps must be the uniform 27-point box (the
    reference kernel's contract). Launches are counted in the recorder's
    (`utils.tracing`) `stencil_kernel_padded.launches` (K1, both routes),
    `stencil_kernel_padded.tap_launches` (K1's tap-list route alone) and
    `stencil_kernel_padded.k2_launches` (K2); its products with A (one a
    K1 call, K a K2 call) in `spmv.stencil_kernel`, on every route."""
    if mode in SWEEPK_MODES:
        return _sweepk(u_pad, b_pad, weights, grid_shape, offsets, alpha, scale_pad, mode)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    taps = taps_of(weights, offsets)
    check_dtype_device(u_pad)
    shape = padded_shape(grid_shape)
    check_state("u_pad", u_pad, u_pad, shape)
    if mode != "spmv":
        check_state("b_pad", b_pad, u_pad, shape)
    if mode in ("sweep_vec", "sweep_vec_norm"):
        check_state("scale_pad", scale_pad, u_pad, shape)
    else:
        scale_pad = None
    tracing.count("spmv.stencil_kernel")
    if u_pad.device.type == "cpu":
        return stencil_plain(u_pad, b_pad, taps, grid_shape, alpha, scale_pad, mode)
    return _launch_k1(
        u_pad, b_pad if mode != "spmv" else None, scale_pad, taps, grid_shape, alpha, mode
    )


def _sweepk(u_pad, b_pad, weights, grid_shape, offsets, alpha, scale_pad, mode):
    taps = taps_of(weights, offsets)
    if uniform_box_weights(taps) is None:
        raise ValueError(f"{mode}: the k-sweep modes need the uniform 27-point box")
    nsweep = int(mode[5])
    check_dtype_device(u_pad)
    shape = padded_shape(grid_shape)
    check_state("u_pad", u_pad, u_pad, shape)
    check_state("b_pad", b_pad, u_pad, shape)
    if mode.endswith("_vec"):
        check_state("scale_pad", scale_pad, u_pad, shape)
    else:
        scale_pad = None
    tracing.count("spmv.stencil_kernel", nsweep)
    if u_pad.device.type == "cpu":
        return sweepk_plain(u_pad, b_pad, taps, grid_shape, nsweep, alpha, scale_pad)
    return _launch_k2(u_pad, b_pad, scale_pad, taps, grid_shape, alpha, nsweep)
