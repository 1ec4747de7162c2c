"""The ELL sparse matrix-vector product as one CUDA kernel (`csrc/ell_spmv.cu`).

It replaces no TPU kernel: the reference's `amg_tpu/sparse/ell.py::
ell_spmv` is plain jnp. `ell_spmv_plain` is the same product as a gather,
a multiply and a sum over the slot axis, three PyTorch launches that write
and read two (n, k) temporaries; the kernel reads each slot of `vals` and
`cols` once and keeps the products in registers.

`ell_spmv_kernel` launches the kernel for CUDA tensors and runs
`ell_spmv_plain` for CPU tensors; there is no other fallback. A call costs
the host its checks, the output's allocation and one ctypes call
(`_build.launch`). A group of `lanes_for(k)` lanes sums each row, so the
order of a row's sum, and its bits, depend on k alone. The sum is taken
with fused multiply-adds and a shuffle tree, so it rounds otherwise than
the plain version: both are within k eps of sum |a_ij x_j|.
"""

from __future__ import annotations

import ctypes

import torch

from amg_tpu_torch.ops import _build
from amg_tpu_torch.utils import tracing

_FLOATS = (torch.float32, torch.float64)
# the kernel's template widths (the `switch` of `launch_lanes`) and its
# kUnroll, in `csrc/ell_spmv.cu`; `test_torch_ell_kernel.py` reads them there
LANE_WIDTHS = (4, 8, 16, 32)
SLOTS_PER_LANE = 4

_SIGNATURES = {
    "amg_ell_spmv_launch": (
        ctypes.c_int,
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                                      ctypes.c_void_p],
    ),
}
_entry = None


def lanes_for(k: int) -> int:
    """The lanes that share a row of width k: the smallest power of two
    L >= k / SLOTS_PER_LANE, in [4, 32], so one pass of a group's loads
    covers a row of up to 128 slots."""
    lanes = LANE_WIDTHS[0]
    while lanes < LANE_WIDTHS[-1] and lanes * SLOTS_PER_LANE < k:
        lanes *= 2
    return lanes


def ell_spmv_plain(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x: gather x by cols, multiply by vals, sum over the slot axis."""
    g = torch.index_select(x, 0, cols.reshape(-1)).view(cols.shape)
    return (vals * g).sum(dim=1)


def _refusal(cols, vals, x, dev):
    """What of (cols, vals, x) `ell_spmv_kernel` does not take on CUDA device
    `dev`, or None: its one list of checks, each a few attribute reads."""
    if not (x.dtype is vals.dtype and x.dtype in _FLOATS):
        return f"float32 or float64 vals and x of one dtype, got {vals.dtype} and {x.dtype}"
    if cols.dtype is not torch.int32:
        return f"int32 cols, got {cols.dtype}"
    if not (x.dim() == 1 and cols.dim() == 2 and vals.shape == cols.shape):
        return (f"(n, k) cols and vals and a 1-D x, got {tuple(cols.shape)}, "
                f"{tuple(vals.shape)}, {tuple(x.shape)}")
    if not (cols.is_contiguous() and vals.is_contiguous() and x.is_contiguous()):
        return "contiguous cols, vals and x"
    if not (cols.get_device() == dev and vals.get_device() == dev):
        return f"cols, vals and x on one device, got {cols.device}, {vals.device}, {x.device}"
    if x.shape[0] == 0 and cols.numel() > 0:
        return "an x with the columns that cols names, got an empty x"
    return None


def ell_spmv_kernel(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the ELL matrix (cols, vals): (n, k) int32 cols and
    float32 or float64 vals, contiguous, and a contiguous x of vals' dtype.
    One launch on the current stream for CUDA tensors, counted in the
    recorder's (`utils.tracing`) `ell_spmv.launches`; none for an empty
    matrix. Other tensors take `ell_spmv_plain`."""
    if not x.is_cuda:
        return ell_spmv_plain(cols, vals, x)
    global _entry
    dev = x.get_device()
    why = _refusal(cols, vals, x, dev)
    if why is not None:
        raise ValueError(f"ell_spmv_kernel takes {why}")
    n, k = cols.shape
    y = x.new_empty(n)
    if n == 0:
        return y
    if _entry is None:
        _entry = _build.load("ell_spmv", _SIGNATURES).amg_ell_spmv_launch
    _build.launch(_entry, "ELL spmv kernel", dev, x.dtype is torch.float64, lanes_for(k),
                  cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(), n, k)
    tracing.count("ell_spmv.launches")
    return y
