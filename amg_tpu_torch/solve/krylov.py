"""Outer PCG with any cycle as the preconditioner (counterpart of
amg_tpu/solve/krylov.py::pcg).

The preconditioner is any callable M(r) -> z, typically one V-cycle from a
zero guess. The reference runs the loop as a `lax.while_loop` on the device;
here it is a host loop that reads one device scalar per iteration (the
convergence test) and keeps the recurrence, the test ||r|| / ||r0|| > tol and
the NaN-padded history of the reference.

With tracing on (`utils/tracing.py`) each iteration runs inside
`amg.iteration`, its operator apply inside `amg.matvec`, its
preconditioner inside `amg.precond` (so are the start's), and the
convergence test's read inside `amg.host_read`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import span


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_resnorm: torch.Tensor
    history: torch.Tensor  # (max_iters + 1,) relative residual norms, NaN-padded


def pcg(
    matvec: Callable,
    precond: Callable,
    b: torch.Tensor,
    x0: torch.Tensor,
    tol: float = 1e-8,
    max_iters: int = 100,
    dot: Callable = torch.dot,
    norm: Callable = torch.linalg.norm,
) -> PCGResult:
    """`dot` and `norm` reduce over the whole vector: the plain ones on one
    device, a row mesh's (parallel.dist.RowMesh: the shards' dots summed in
    shard order) where the vectors are this process's rows."""
    with span("matvec"):
        r = b - matvec(x0)
    bnorm = norm(r)
    safe_bnorm = torch.where(bnorm == 0.0, torch.ones_like(bnorm), bnorm)
    with span("precond"):
        z = precond(r)
    p = z
    rz = dot(r, z)
    x = x0
    hist = torch.full((max_iters + 1,), math.nan, dtype=b.dtype, device=b.device)
    hist[0] = 1.0
    rel = bnorm / safe_bnorm
    it = 0
    while it < max_iters and tracing.host_read(rel > tol, bool):
        with span("iteration"):
            with span("matvec"):
                Ap = matvec(p)
            alpha = rz / dot(p, Ap)
            x = alpha * p + x
            r = -alpha * Ap + r
            with span("precond"):
                z = precond(r)
            rz_new = dot(r, z)
            beta = rz_new / rz
            p = beta * p + z
            rz = rz_new
            rel = norm(r) / safe_bnorm
            hist[it + 1] = rel
        it += 1
    return PCGResult(x=x, iters=it, rel_resnorm=rel, history=hist)
