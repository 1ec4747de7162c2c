"""Vector helpers (counterpart of amg_tpu/ops/vector.py)."""

from __future__ import annotations


def residual(A, u, f):
    """r = f - A u, through the operator's fused residual where it has one
    (the DIA device operator streams f through its K5 launch)."""
    if hasattr(A, "residual"):
        return A.residual(u, f)
    return f - (A @ u)
