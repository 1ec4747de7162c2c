"""Jacobi-family smoothers (counterpart of amg_tpu/smooth/smoothers.py).

This slice ports JACOBI and L1_JACOBI:

    u_new = u + w S^-1 (f - A u),   S = diag(A) or the L1 row norms.

The hybrid Jacobi-Gauss-Seidel, Gauss-Seidel and symmetrized smoothers come
with the generic-AMG slice; asking for them raises NotImplementedError.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from amg_tpu_torch.dtypes import SETUP_DTYPE


class SmootherType(enum.Enum):
    JACOBI = "jacobi"
    L1_JACOBI = "l1_jacobi"
    HYBRID_JGS = "hybrid_jgs"
    HYBRID_JGS_BACKWARD = "hybrid_jgs_backward"
    GS = "gs"
    SYM_JACOBI = "sym_jacobi"
    SYM_L1_JACOBI = "sym_l1_jacobi"


_PORTED = (SmootherType.JACOBI, SmootherType.L1_JACOBI)


def _require_ported(smoother: SmootherType) -> None:
    if smoother not in _PORTED:
        raise NotImplementedError(
            f"smoother {smoother.value} is ported with the generic-AMG slice; "
            "this slice has JACOBI and L1_JACOBI"
        )


class SmootherData(NamedTuple):
    """Per-level smoother state.

    scale:      (n,) — S = diag(A) (JACOBI) or L1 row norms (L1_JACOBI).
    inv_wscale: (n,) — w / S, the multiplier applied to residuals.
    w:          ()   — damping weight.
    """

    scale: torch.Tensor
    inv_wscale: torch.Tensor
    w: torch.Tensor


def make_smoother_data(A_csr, smoother: SmootherType, w: float = 1.0) -> dict:
    """Precompute the smoother state from the host CSR matrix at setup time,
    as float64 arrays {scale, inv_wscale, w} (the Jacobi branch of the
    reference's make_smoother_data); `smoother_data_from_arrays` puts them on
    the device."""
    _require_ported(smoother)
    if smoother == SmootherType.L1_JACOBI:
        scale = A_csr.l1_row_norms()
    else:
        scale = A_csr.diagonal().astype(SETUP_DTYPE)
    # guard empty/zero rows (padded or disconnected): unit scale
    scale = np.where(scale == 0.0, 1.0, scale)
    return {"scale": scale, "inv_wscale": w / scale, "w": np.float64(w)}


def smoother_data_from_arrays(arrays: dict, dtype, device) -> SmootherData:
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float64)).to(
            device=device, dtype=dtype
        )

    return SmootherData(
        scale=t(arrays["scale"]), inv_wscale=t(arrays["inv_wscale"]), w=t(arrays["w"])
    )


def _one_sweep(A, sm: SmootherData, smoother: SmootherType, u, f, zero_guess):
    """u_new = u + S^-1 w (f - A u); zero_guess skips the matvec."""
    _require_ported(smoother)
    r = f if zero_guess else f - (A @ u)
    du = sm.inv_wscale * r
    return du if zero_guess else u + du


def smooth(
    A,
    sm: SmootherData,
    smoother: SmootherType,
    u: torch.Tensor,
    f: torch.Tensor,
    num_sweeps: int = 1,
    zero_guess: bool = False,
):
    """Run `num_sweeps` smoothing sweeps. A DIA device operator runs the whole
    Jacobi chain itself: one pad/unpad pair and one K5 `sweep` launch per
    sweep."""
    if num_sweeps > 0 and hasattr(A, "fused_jacobi_sweeps"):
        _require_ported(smoother)
        return A.fused_jacobi_sweeps(u, f, sm.inv_wscale, num_sweeps, zero_guess=zero_guess)
    for s in range(num_sweeps):
        u = _one_sweep(A, sm, smoother, u, f, zero_guess and s == 0)
    return u
