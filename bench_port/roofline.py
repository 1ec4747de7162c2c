"""The yardstick of the roofline shares: the chip's peaks and the bytes each
measured operation needs.

Bytes are counted from the benchmark's matrix and vector lengths, each input
byte read once and each output byte written once, whatever the program's
format pads or re-reads; so a later change of format (ELL to CSR, a
library, a kernel) is read against the same work.
"""

from __future__ import annotations

from typing import Optional

# NVIDIA's data sheet, SXM part at its 700 W limit: HBM3 bandwidth
HBM_BYTES_PER_S = {"H100 SXM": 3.35e12}


def peak_bytes_per_s(kind: str) -> Optional[float]:
    """The device memory bandwidth of a card by its name
    (`torch.cuda.get_device_name()`); None for a card not in the table."""
    if "H100" in kind and "PCIe" not in kind and "NVL" not in kind:
        return HBM_BYTES_PER_S["H100 SXM"]
    return None


def stencil_bytes(n: int, value_bytes: int = 8) -> int:
    """A constant stencil's matvec: x read once, y written once (the
    weights are a few scalars)."""
    return 2 * n * value_bytes


def spmv_bytes(n_rows: int, n_cols: int, nnz: int, value_bytes: int = 8,
               index_bytes: int = 4) -> int:
    """A sparse matvec: each true nonzero's value and column index once, x
    read once, y written once."""
    return nnz * (value_bytes + index_bytes) + n_cols * value_bytes + n_rows * value_bytes


def share_percent(bytes_moved: int, seconds: float, kind: str) -> Optional[float]:
    """The memory roofline's least time over the measured time, in %; None
    without a peak or a time."""
    peak = peak_bytes_per_s(kind)
    if peak is None or not seconds > 0.0:
        return None
    return 100.0 * bytes_moved / peak / seconds
