"""K5: the variable-coefficient (DIA) stencil kernel on the padded state
(counterpart of amg_tpu/ops/pallas_var_stencil.py; the CUDA kernel is
`csrc/var_stencil.cu`).

An operator with m generalized diagonals (offsets (dz, dy, dx), any reach) on
a grid (Z, Y, X) is stored as m coefficient planes of the interior, stacked as
(m, Z, Y, X): the kernel reads a coefficient only at an interior output point,
so the planes carry no shell. The state vectors are padded: a zero shell of
per-axis halo widths (hz, hy, hx) = max |offset| per axis, in the natural axis
order, so the padded shape is (Z + 2hz, Y + 2hy, Xr) with Xr = X + 2hx rounded
up to a multiple of 4. The reference's axis permutation and slab search choose
TPU lanes and VMEM and cannot change a result; they are not carried over.

Modes, at every interior point (shell -> 0):
    spmv      y = A u
    residual  b - A u
    sweep     u + s (b - A u)   (streamed per-point scale)

The planes are in the state's dtype; in `sweep` they may also be bfloat16
beside a float32 or float64 state (the reference's narrow sweep stream,
`DiaKernelOperator.with_sweep_dtype`): each coefficient is widened to the
state's dtype, exactly, before its multiply.

`var_stencil_kernel_padded` launches the CUDA kernel for a CUDA tensor and
runs the plain PyTorch version `var_stencil_plain` for a CPU tensor; there is
no other fallback. The reference's compensated `spmv_comp` mode exists for
its double-single arithmetic; here the float64 instantiation of the same
kernel takes its place.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.ops import _build
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.ops.stencil import check_dtype_device, check_state

MODES = ("spmv", "residual", "sweep")
MAX_OFFSETS = 128
_X_ALIGN = 4


def halos_of(offsets) -> Tuple[int, int, int]:
    """Per-axis halo widths (max |offset|) for an offset set."""
    o = np.asarray(offsets, dtype=np.int64)
    return tuple(int(v) for v in np.abs(o).max(axis=0))


def var_padded_shape(grid_shape, halos) -> Tuple[int, int, int]:
    Z, Y, X = grid_shape
    hz, hy, hx = halos
    return (Z + 2 * hz, Y + 2 * hy, -(-(X + 2 * hx) // _X_ALIGN) * _X_ALIGN)


def _pad_spec(grid_shape, halos):
    """F.pad widths (last axis first) of the interior inside the padded shape."""
    Z, Y, X = grid_shape
    hz, hy, hx = halos
    Xr = var_padded_shape(grid_shape, halos)[2]
    return (hx, Xr - X - hx, hy, hy, hz, hz)


def var_to_padded(x: torch.Tensor, grid_shape, halos) -> torch.Tensor:
    """Embed a flat interior vector into the zero-shelled padded layout."""
    return F.pad(x.reshape(tuple(grid_shape)), _pad_spec(grid_shape, halos))


def var_from_padded(p: torch.Tensor, grid_shape, halos) -> torch.Tensor:
    Z, Y, X = grid_shape
    hz, hy, hx = halos
    return p[hz:hz + Z, hy:hy + Y, hx:hx + X].reshape(Z * Y * X)


def _interior(grid_shape, halos):
    Z, Y, X = grid_shape
    hz, hy, hx = halos
    return (slice(hz, hz + Z), slice(hy, hy + Y), slice(hx, hx + X))


def var_apply_plain(u_pad, coeffs, offsets, grid_shape, halos) -> torch.Tensor:
    """A u on the interior, (Z, Y, X), diagonals summed in list order, each
    plane widened to u's dtype before its multiply."""
    Z, Y, X = grid_shape
    hz, hy, hx = halos
    acc = torch.zeros((Z, Y, X), dtype=u_pad.dtype, device=u_pad.device)
    for t, (dz, dy, dx) in enumerate(offsets):
        shifted = u_pad[hz + dz:hz + dz + Z, hy + dy:hy + dy + Y, hx + dx:hx + dx + X]
        acc = acc + coeffs[t].to(u_pad.dtype) * shifted
    return acc


def var_stencil_plain(u_pad, coeffs, offsets, grid_shape, b_pad=None, scale_pad=None,
                      mode="spmv"):
    """Plain PyTorch version of K5 (same modes and outputs)."""
    halos = halos_of(offsets)
    inner = _interior(grid_shape, halos)
    acc = var_apply_plain(u_pad, coeffs, offsets, grid_shape, halos)
    if mode == "spmv":
        val = acc
    elif mode == "residual":
        val = b_pad[inner] - acc
    elif mode == "sweep":
        val = u_pad[inner] + scale_pad[inner] * (b_pad[inner] - acc)
    else:
        raise ValueError(mode)
    out = torch.zeros_like(u_pad)
    out[inner] = val
    return out


def offset_arrays(offsets):
    """ctypes arrays (dz, dy, dx) of an offset list, for the C entry."""
    n = len(offsets)
    return tuple(
        (ctypes.c_int * n)(*[int(o[a]) for o in offsets]) for a in range(3)
    ) + (n,)


_SIGNATURES = {
    "amg_k5_launch": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int)] * 3
        + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    ),
}


def _launch_k5(u_pad, coeffs, offsets, grid_shape, b_pad, scale_pad, mode):
    lib = _build.load("var_stencil", _SIGNATURES)
    Z, Y, X = grid_shape
    Zr, Yr, Xr = u_pad.shape
    out = torch.empty_like(u_pad)
    dz, dy, dx, n = offset_arrays(offsets)
    narrow = coeffs.dtype == torch.bfloat16
    _build.launch(
        lib.amg_k5_launch, "variable stencil kernel (K5)", u_pad.device,
        int(u_pad.dtype == torch.float64), int(narrow), _build.ptr(u_pad), _build.ptr(coeffs),
        _build.ptr(b_pad), _build.ptr(scale_pad), _build.ptr(out), dz, dy, dx, n,
        Z, Y, X, Zr, Yr, Xr, MODES.index(mode),
    )
    tracing.count("var_stencil_kernel_padded.launches")
    tracing.count("var_stencil_kernel_padded.bf16_launches", int(narrow))
    return out


def var_stencil_kernel_padded(u_pad, coeffs, offsets, grid_shape, b_pad=None,
                              scale_pad=None, mode: str = "spmv"):
    """K5 on padded-layout vectors (see MODES). coeffs is (m, Z, Y, X), the
    planes of the interior, in u_pad's dtype or, in `sweep` only, bfloat16;
    b_pad is read by residual and sweep, scale_pad by sweep. Launches are
    counted in the recorder's (`utils.tracing`) `var_stencil_kernel_padded.
    launches`, those with bfloat16 planes also in `var_stencil_kernel_padded.
    bf16_launches`."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    if not 1 <= len(offsets) <= MAX_OFFSETS or any(len(o) != 3 for o in offsets):
        raise ValueError(f"need 1 to {MAX_OFFSETS} offsets of 3 axes, got {len(offsets)}")
    check_dtype_device(u_pad)
    shape = var_padded_shape(grid_shape, halos_of(offsets))
    check_state("u_pad", u_pad, u_pad, shape)
    narrow = isinstance(coeffs, torch.Tensor) and coeffs.dtype == torch.bfloat16
    if narrow and mode != "sweep":
        raise ValueError(f"bfloat16 coefficient planes are read by mode 'sweep' only, "
                         f"not {mode!r}")
    check_state("coeffs", coeffs, u_pad, (len(offsets),) + tuple(grid_shape),
                dtype=torch.bfloat16 if narrow else None)
    if mode != "spmv":
        check_state("b_pad", b_pad, u_pad, shape)
    else:
        b_pad = None
    if mode == "sweep":
        check_state("scale_pad", scale_pad, u_pad, shape)
    else:
        scale_pad = None
    if u_pad.device.type == "cpu":
        return var_stencil_plain(u_pad, coeffs, offsets, grid_shape, b_pad, scale_pad, mode)
    return _launch_k5(u_pad, coeffs, offsets, grid_shape, b_pad, scale_pad, mode)
