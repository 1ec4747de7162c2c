"""Outer Chebyshev / Richardson acceleration and eigenvalue estimation
(counterpart of amg_tpu/solve/accel.py).

The cycle produces an additive correction u; the accelerated direction d
follows the Chebyshev three-term recurrence

    cycle 0: d = u
    else:    c_{k+1} = 2 mu c_k - c_{k-1};  omega = 2 mu c_k / c_{k+1}
             d = (omega - 1) d + omega * delta * u
    x += d

with mu = (beta+alpha)/(beta-alpha), delta = 2/(beta+alpha) from eigenvalue
bounds [alpha, beta] of the cycle-preconditioned operator M^-1 A; Richardson
uses the fixed omega = 2/(1+sqrt(1-mu^-2)).

The three estimators draw their start vectors from numpy (`default_rng`), as
the reference's do, so both packages start from the same vectors. On a row
mesh (`mesh=`) each process takes its rows of the one global draw and the
dots and norms reduce over the mesh. The
reference runs the power iterations as one jitted loop; here they are host
loops over device operations that read the estimate once at the end.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class ChebyCoeffs(NamedTuple):
    alpha: float  # lambda_min bound
    beta: float  # lambda_max bound
    mu: float
    delta: float


def make_cheby_coeffs(alpha: float, beta: float) -> ChebyCoeffs:
    return ChebyCoeffs(
        alpha=alpha, beta=beta, mu=(beta + alpha) / (beta - alpha), delta=2.0 / (beta + alpha)
    )


class ChebyState(NamedTuple):
    d: torch.Tensor
    c: torch.Tensor  # Chebyshev polynomial values T_k(mu)
    c_prev: torch.Tensor
    k: int  # cycle counter


def cheby_init(n: int, dtype, device="cpu") -> ChebyState:
    return ChebyState(
        d=torch.zeros(n, dtype=dtype, device=device),
        c=torch.ones((), dtype=dtype, device=device),
        c_prev=torch.ones((), dtype=dtype, device=device),
        k=0,
    )


def cheby_update(
    state: ChebyState, u: torch.Tensor, coeffs: ChebyCoeffs, richardson: bool = False
) -> ChebyState:
    """One accelerated-direction update. The k = 0 copy step leaves
    c = T_1 = mu behind (T_0 = 1), so the first accelerated update uses
    omega = 2 mu^2/(2 mu^2 - 1)."""
    if state.k == 0:
        return ChebyState(d=u, c=torch.full_like(state.c, coeffs.mu), c_prev=state.c_prev, k=1)
    c_new = 2.0 * coeffs.mu * state.c - state.c_prev
    if richardson:
        omega = 2.0 / (1.0 + (1.0 - 1.0 / (coeffs.mu * coeffs.mu)) ** 0.5)
    else:
        omega = 2.0 * coeffs.mu * state.c / c_new
    d = (omega - 1.0) * state.d + omega * coeffs.delta * u
    return ChebyState(d=d, c=c_new, c_prev=state.c, k=state.k + 1)


def _start(v: np.ndarray, dtype, device, mesh=None) -> torch.Tensor:
    """A start vector (or block) drawn on the host, on `device`: its rows on
    the mesh where there is one (each process's rows of the one global
    draw)."""
    if mesh is not None:
        v = v[mesh.local_rows(v.shape[0])]
    return torch.from_numpy(np.ascontiguousarray(v)).to(device=device, dtype=dtype)


def _reducers(mesh):
    """(dot, norm) over the whole vector: the plain ones, or the mesh's
    (the shards' dots summed in shard order) where the vectors are this
    process's rows."""
    return (torch.dot, torch.linalg.norm) if mesh is None else (mesh.dot, mesh.norm)


def estimate_cycle_eigs(
    apply_MinvA,
    n: int,
    dtype,
    num_iters: int = 20,
    seed: int = 0,
    range_start: bool = False,
    operand=None,
    device="cpu",
    mesh=None,
) -> ChebyCoeffs:
    """Eigenvalue bounds of M^-1 A by power iteration, then a shifted power
    iteration for the smallest eigenvalue.

    range_start: start both iterations inside range(op) (one extra apply
    each), so that the second finds the smallest nonzero eigenvalue of a
    singular operator (the semidefinite extended BPX system).
    operand: passed as apply_MinvA's first argument, apply_MinvA(operand, u).
    mesh: the row mesh whose rows the operator's vectors are (n the global
    length); dots and norms reduce over it."""
    if operand is not None:
        op, apply_MinvA = apply_MinvA, (lambda u: op(operand, u))
    dot, norm = _reducers(mesh)
    rng = np.random.default_rng(seed)
    u1 = _start(rng.random(n), dtype, device, mesh)
    u2 = _start(rng.random(n), dtype, device, mesh)
    if range_start:
        u1, u2 = apply_MinvA(u1), apply_MinvA(u2)
    u, lam_max = u1, torch.ones((), dtype=dtype, device=device)
    for _ in range(num_iters):
        u = u / norm(u)
        v = apply_MinvA(u)
        u, lam_max = v, dot(u, v)
    lam_max = torch.abs(lam_max)
    u, rho = u2, torch.zeros((), dtype=dtype, device=device)
    for _ in range(num_iters):
        u = u / norm(u)
        v = lam_max * u - apply_MinvA(u)
        u, rho = v, dot(u, v)
    lam_min = torch.clamp(lam_max - torch.abs(rho), min=1e-12)
    # mild safety margins
    return make_cheby_coeffs(alpha=0.95 * float(lam_min), beta=1.05 * float(lam_max))


def estimate_eigs_lobpcg(
    apply_op, n: int, dtype, num_iters: int = 12, block: int = 4,
    seed: int = 0, device="cpu", mesh=None,
) -> ChebyCoeffs:
    """Eigenvalue bounds via block LOBPCG: Rayleigh-Ritz over span[X, R, P]
    with the Ritz block tracking both ends of the spectrum, so one run yields
    (lambda_min, lambda_max). The operator is applied column by column. On a
    mesh the blocks are this process's rows: the Gram products are
    all-reduced and the tall-skinny QR runs on the gathered block."""
    rng = np.random.default_rng(seed)
    b = max(2, min(block, n // 2))

    def applym(Xm):
        return torch.stack([apply_op(Xm[:, i]) for i in range(Xm.shape[1])], dim=1)

    def gram(Xm, Ym):
        g = Xm.T @ Ym
        return g if mesh is None else mesh.all_reduce(g)

    def qr(Sm):
        if mesh is None:
            return torch.linalg.qr(Sm)[0]
        full = mesh.gather(Sm)
        return torch.linalg.qr(full)[0][mesh.local_rows(full.shape[0])]

    X = qr(_start(rng.standard_normal((n, b)), dtype, device, mesh))
    P = None
    lam_lo, lam_hi = 1.0, 1.0
    lo_sel = b // 2  # Ritz vectors kept at the low end; the rest at the high end
    for _ in range(num_iters):
        AX = applym(X)
        T = gram(X, AX)
        T = (T + T.T) / 2
        R = AX - X @ T  # block residual of the current Ritz approximation
        S = torch.cat([X, R] + ([P] if P is not None else []), dim=1)
        Q = qr(S)
        AQ = applym(Q)
        Tq = gram(Q, AQ)
        Tq = (Tq + Tq.T) / 2
        evals, W = torch.linalg.eigh(Tq)
        lam_lo, lam_hi = float(evals[0]), float(evals[-1])
        m = Tq.shape[0]
        sel = list(range(lo_sel)) + list(range(m - (b - lo_sel), m))
        P = X  # previous iterate block: the locally-optimal direction
        X = Q @ W[:, sel]
    lam_lo = max(lam_lo, 1e-12)
    return make_cheby_coeffs(alpha=0.95 * lam_lo, beta=1.05 * lam_hi)


def estimate_eigs_lanczos(
    apply_op, n: int, dtype, num_iters: int = 30, seed: int = 0, device="cpu", mesh=None,
) -> ChebyCoeffs:
    """Eigenvalue bounds via Lanczos: the extreme Ritz values of the
    tridiagonal matrix of the recurrence on the (symmetric) operator."""
    from scipy.linalg import eigh_tridiagonal

    dot, norm = _reducers(mesh)
    rng = np.random.default_rng(seed)
    v = _start(rng.random(n), dtype, device, mesh)
    v = v / norm(v)
    alphas, betas = [], []
    v_prev = torch.zeros_like(v)
    beta = 0.0
    for _ in range(num_iters):
        w = apply_op(v)
        alpha = float(dot(v, w))
        w = w - alpha * v - beta * v_prev
        # no full reorthogonalization: the extreme Ritz values need only the
        # recurrence against the previous two vectors
        beta_new = float(norm(w))
        alphas.append(alpha)
        if beta_new < 1e-14:
            break
        betas.append(beta_new)
        v_prev = v
        v = w / beta_new
        beta = beta_new
    if len(alphas) == 1:
        lam_min = lam_max = alphas[0]
    else:
        evals = eigh_tridiagonal(
            np.asarray(alphas), np.asarray(betas[: len(alphas) - 1]), eigvals_only=True
        )
        lam_min, lam_max = float(evals[0]), float(evals[-1])
    lam_min = max(lam_min, 1e-12)
    return make_cheby_coeffs(alpha=0.95 * lam_min, beta=1.05 * lam_max)
