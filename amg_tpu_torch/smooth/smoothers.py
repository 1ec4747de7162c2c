"""The smoother family (counterpart of amg_tpu/smooth/smoothers.py).

  JACOBI / L1_JACOBI    u += w S^-1 (f - A u),  S = diag(A) or L1 row norms
  HYBRID_JGS            Gauss-Seidel within fixed row blocks, Jacobi across
                        blocks: the precomputed dense inverse of
                        (D + tril(A_block)) applied as one batched matrix-
                        vector product (`torch.bmm`)
  HYBRID_JGS_BACKWARD   the transposed variant, (D + triu(A_block))^-1
  GS                    exact sequential Gauss-Seidel: HYBRID_JGS with one
                        block spanning the matrix
  SYM_JACOBI /          the SPD-preserving symmetrized sweep
  SYM_L1_JACOBI         e = w S^-1 (2S/w - A) w S^-1 r

The float32 block products need full float32: PyTorch's default
(`torch.backends.cuda.matmul.allow_tf32` False).
"""

from __future__ import annotations

import contextlib
import enum
from typing import NamedTuple, Optional

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


JACOBI_TYPES = (SmootherType.JACOBI, SmootherType.L1_JACOBI)
BLOCK_TYPES = (SmootherType.HYBRID_JGS, SmootherType.HYBRID_JGS_BACKWARD, SmootherType.GS)
# Smoothers whose error propagator is symmetric in the A inner product
SYMMETRIC_TYPES = (SmootherType.SYM_JACOBI, SmootherType.SYM_L1_JACOBI)


class SmootherData(NamedTuple):
    """Per-level smoother state.

    scale:         (n,) — S = diag(A) (Jacobi flavors) or the L1 row norms.
    inv_wscale:    (n,) — w / S, the multiplier applied to residuals.
    w:             ()   — damping weight.
    block_inv:     (nblocks, bs, bs) or None — inverse of (D + tril) of the
                   bs x bs diagonal blocks of A, identity-padded past n.
    block_inv_bwd: the same for the upper-triangular (transposed) sweep.
    """

    scale: torch.Tensor
    inv_wscale: torch.Tensor
    w: torch.Tensor
    block_inv: Optional[torch.Tensor] = None
    block_inv_bwd: Optional[torch.Tensor] = None


def _block_inverses(A_csr, bs: int, nblocks: int, upper: bool) -> np.ndarray:
    n = A_csr.n_rows
    s = A_csr.to_scipy()
    out = np.tile(np.eye(bs, dtype=SETUP_DTYPE), (nblocks, 1, 1))
    for b in range(nblocks):
        lo, hi = b * bs, min((b + 1) * bs, n)
        blk = s[lo:hi, lo:hi].toarray()
        tri = np.triu(blk) if upper else np.tril(blk)
        m = hi - lo
        d = np.diag(blk)
        np.fill_diagonal(tri, np.where(d == 0.0, 1.0, d))
        tgt = out[b]  # identity-padded past n
        tgt[:m, :m] = tri
        out[b] = np.linalg.inv(tgt)
    return out


def _jgs_auto_weight(A_csr, inv_fwd: np.ndarray, bs: int, nblocks: int) -> float:
    """1 if the undamped hybrid sweep contracts (rho(I - M^-1 A) <= 1.02),
    else 1/rho(M^-1 A): host power iterations from default_rng(0)."""
    n = A_csr.n_rows
    rng = np.random.default_rng(0)
    s_op = A_csr.to_scipy()

    def apply_MinvA(v):
        y = s_op @ v
        yp = np.zeros(nblocks * bs)
        yp[:n] = y
        yp = yp.reshape(nblocks, bs)
        return np.einsum("bij,bj->bi", inv_fwd, yp).reshape(-1)[:n]

    def rho_power(apply_fn, iters=50):
        x = rng.standard_normal(n)
        lam = 0.0
        for _ in range(iters):
            y = apply_fn(x)
            nrm = np.linalg.norm(y)
            if nrm == 0.0:
                return 0.0
            lam = nrm / np.linalg.norm(x)
            x = y / nrm
        return lam

    rho_E = rho_power(lambda v: v - apply_MinvA(v))
    if rho_E <= 1.02:
        return 1.0  # already convergent: exact undamped semantics
    return 1.0 / max(rho_power(apply_MinvA), 1.0)


def _one_blas_thread():
    """numpy's BLAS held to one thread where threadpoolctl is installed (a
    no-op elsewhere). The block inverses are one LAPACK call per 128 x 128
    block and the damping estimate one BLAS-1 call per vector, which BLAS
    threads only slow down: the inverses 18x on an idle 8-core host at
    24,843 rows, and by two orders of magnitude when other processes share
    the cores. The results are bit-equal either way."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        return contextlib.nullcontext()
    return threadpool_limits(limits=1, user_api="blas")


def make_smoother_data(
    A_csr, smoother: SmootherType, w: float = 1.0, block_size: int = 128, jgs_weight=None
) -> dict:
    """Precompute the smoother state from the host CSR matrix at setup time,
    as float64 arrays {scale, inv_wscale, w[, block_inv, block_inv_bwd]};
    `smoother_data_from_arrays` puts them on the device.

    jgs_weight (block smoothers): None = undamped, "auto" = damped by
    1/rho(M^-1 A) only where the sweep diverges, or a float weight."""
    if smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI):
        scale = A_csr.l1_row_norms()
    else:
        scale = A_csr.diagonal().astype(SETUP_DTYPE)
    # guard empty/zero rows (padded or disconnected): unit scale
    scale = np.where(scale == 0.0, 1.0, scale)
    out = {"scale": scale, "inv_wscale": w / scale, "w": np.float64(w)}
    if smoother in BLOCK_TYPES:
        n = A_csr.n_rows
        bs = n if smoother == SmootherType.GS else min(block_size, n)
        nblocks = -(-n // bs)
        # many small blocks: one BLAS thread (GS's one block keeps them all)
        with _one_blas_thread() if nblocks > 1 else contextlib.nullcontext():
            inv_fwd = _block_inverses(A_csr, bs, nblocks, upper=False)
            inv_bwd = _block_inverses(A_csr, bs, nblocks, upper=True)
            if jgs_weight == "auto":
                jgs_w = _jgs_auto_weight(A_csr, inv_fwd, bs, nblocks)
            else:
                jgs_w = 1.0 if jgs_weight is None else float(jgs_weight)
        out["block_inv"] = jgs_w * inv_fwd
        out["block_inv_bwd"] = jgs_w * inv_bwd
    return out


def smoother_data_from_arrays(arrays: dict, dtype, device) -> SmootherData:
    def t(a):
        if a is None:
            return None
        return torch.from_numpy(np.array(a, dtype=np.float64)).to(device=device, dtype=dtype)

    return SmootherData(
        scale=t(arrays["scale"]), inv_wscale=t(arrays["inv_wscale"]), w=t(arrays["w"]),
        block_inv=t(arrays.get("block_inv")), block_inv_bwd=t(arrays.get("block_inv_bwd")),
    )


class ShardedBlockInverse(NamedTuple):
    """The block inverses of a row-sharded level across processes: all the
    level's blocks (cut from the global rows), applied to the gathered
    residual by the one batched product that one process holding the level
    makes, of which this process keeps its `rows`. So the block solve is
    the one-process one bit for bit (a product over fewer blocks may round
    otherwise: a batch of one takes another kernel)."""

    blocks: torch.Tensor
    rows: slice
    mesh: object  # parallel.dist.RowMesh

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        return _block_solve(self.blocks, self.mesh.gather(r))[self.rows]


def _block_solve(block_inv, r: torch.Tensor) -> torch.Tensor:
    """Apply the batched dense (D+L_block)^-1 to r: one batched product."""
    if isinstance(block_inv, ShardedBlockInverse):
        return block_inv.solve(r)
    nblocks, bs, _ = block_inv.shape
    n = r.shape[0]
    npad = nblocks * bs
    rp = torch.nn.functional.pad(r, (0, npad - n)) if npad != n else r
    out = torch.bmm(block_inv, rp.view(nblocks, bs, 1))
    return out.reshape(npad)[:n]


def _one_sweep(A, sm: SmootherData, smoother: SmootherType, u, f, zero_guess):
    """u_new = u + M^-1 (f - A u); zero_guess skips the matvec."""
    r = f if zero_guess else f - (A @ u)
    if smoother in JACOBI_TYPES:
        du = sm.inv_wscale * r
    elif smoother in (SmootherType.HYBRID_JGS, SmootherType.GS):
        du = _block_solve(sm.block_inv, r)
    elif smoother == SmootherType.HYBRID_JGS_BACKWARD:
        du = _block_solve(sm.block_inv_bwd, r)
    elif smoother in SYMMETRIC_TYPES:
        # e = w S^-1 (2 S/w t - A t),  t = w S^-1 r  — SPD symmetrized sweep
        t = sm.inv_wscale * r
        du = 2.0 * t - sm.inv_wscale * (A @ t)
    else:
        raise ValueError(f"unknown smoother {smoother}")
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
    """Run `num_sweeps` smoothing sweeps. A DIA device operator runs a Jacobi
    chain itself (one pad/unpad pair and one K5 `sweep` launch per sweep);
    the block smoothers on an operator with a fused `residual` take it."""
    if num_sweeps > 0 and smoother in JACOBI_TYPES and hasattr(A, "fused_jacobi_sweeps"):
        return A.fused_jacobi_sweeps(u, f, sm.inv_wscale, num_sweeps, zero_guess=zero_guess)
    if num_sweeps > 0 and smoother in BLOCK_TYPES and hasattr(A, "residual"):
        inv = sm.block_inv_bwd if smoother == SmootherType.HYBRID_JGS_BACKWARD else sm.block_inv
        for s in range(num_sweeps):
            if zero_guess and s == 0:
                u = _block_solve(inv, f)
            else:
                u = u + _block_solve(inv, A.residual(u, f))
        return u
    for s in range(num_sweeps):
        u = _one_sweep(A, sm, smoother, u, f, zero_guess and s == 0)
    return u


def smooth_transpose(
    A,
    sm: SmootherData,
    smoother: SmootherType,
    u: torch.Tensor,
    f: torch.Tensor,
    num_sweeps: int = 1,
    zero_guess: bool = False,
):
    """The adjoint sweep (backward ordering), the post-smoother that keeps
    cycles symmetric; the Jacobi flavors are self-adjoint in the S inner
    product."""
    t = {
        SmootherType.HYBRID_JGS: SmootherType.HYBRID_JGS_BACKWARD,
        SmootherType.HYBRID_JGS_BACKWARD: SmootherType.HYBRID_JGS,
    }.get(smoother, smoother)
    return smooth(A, sm, t, u, f, num_sweeps, zero_guess)
