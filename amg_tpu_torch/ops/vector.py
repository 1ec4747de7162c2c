"""Vector helpers (counterpart of amg_tpu/ops/vector.py)."""

from __future__ import annotations


def residual(A, u, f):
    """r = f - A u. (The reference dispatches to a fused residual where the
    operator has one; its only such operators are the DIA kernels of a later
    slice.)"""
    return f - (A @ u)
