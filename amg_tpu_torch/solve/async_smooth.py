"""Asynchronous one-level smoothing, including stochastic parallel Southwell
(counterpart of amg_tpu/solve/async_smooth.py).

The rows are cut into num_blocks contiguous blocks (the analog of ranks or
device shards); each step every block decides on its own whether to relax
its rows:

  fixed                 fire ~ Bernoulli(fire_prob)
  southwell_exp         p = exp(-x alpha)
  southwell_inv         p = 1 / max(x alpha, 1)

where x counts the neighbour blocks whose residual L1 norm exceeds this
block's, and alpha is sps_alpha or, with sps_min_prob > 0, -log(sps_min_prob)
over the block's neighbour count. Firing blocks take one smoother sweep
against the current residual.

The reference runs this as one jitted while loop with jax.random draws.
Here it is a host loop that reads one device scalar a step (the relative
residual); the (B,) firing uniforms come from an injectable draw source
(`SmoothDrawSource`; by default a torch.Generator on the device), and the
probabilities, which depend on the residual, stay on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Protocol

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.smooth.smoothers import SmootherData, SmootherType, smooth
from amg_tpu_torch.solve.driver import nan_padded


@dataclass(frozen=True)
class AsyncSmoothConfig:
    smoother: SmootherType = SmootherType.L1_JACOBI
    num_blocks: int = 8  # rank/shard analog
    method: str = "southwell_exp"  # fixed | southwell_exp | southwell_inv
    sps_alpha: float = 1.0
    # > 0: each block's alpha from its neighbour count, so that a block whose
    # neighbours all have larger residuals fires with exactly sps_min_prob
    sps_min_prob: float = 0.0
    fire_prob: float = 0.5  # method "fixed"


class AsyncSmoothResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_resnorm: torch.Tensor
    history: torch.Tensor  # relative residual per step, NaN-padded
    block_updates: torch.Tensor  # (B,) relaxations per block

    def history_list(self):
        h = self.history.detach().cpu().numpy()
        return h[~np.isnan(h)].tolist()


class SmoothDrawSource(Protocol):
    def step(self, B: int, dtype, device) -> torch.Tensor:
        """This step's (B,) firing uniforms in [0, 1) on `device`."""


class GeneratorSmoothDraws:
    """The production draw source: a torch.Generator on `device` seeded from
    `seed` (the firing test runs on the device, beside the probabilities)."""

    def __init__(self, seed: int = 0, device="cpu"):
        self._gen = torch.Generator(device=torch.device(device)).manual_seed(seed)

    def step(self, B, dtype, device):
        return torch.rand(B, generator=self._gen, dtype=dtype, device=device)


def block_neighbor_mask(A_csr, num_blocks: int) -> np.ndarray:
    """(B, B) bool: the blocks coupled through A, without the diagonal (the
    graph whose edges carry the Southwell residual norms)."""
    n = A_csr.n_rows
    bs = -(-n // num_blocks)
    row_blocks = np.repeat(np.arange(n) // bs, np.diff(A_csr.indptr))
    col_blocks = A_csr.indices // bs
    m = np.zeros((num_blocks, num_blocks), dtype=bool)
    m[row_blocks, col_blocks] = True
    np.fill_diagonal(m, False)
    return m


def async_smooth_solve(
    A,
    sm: SmootherData,
    cfg: AsyncSmoothConfig,
    neighbor_mask: np.ndarray,
    b,
    x0: Optional[torch.Tensor] = None,
    draws: Optional[SmoothDrawSource] = None,
    seed: int = 0,
    tol: float = 1e-8,
    max_cycles: int = 2000,
    device=None,
    mesh=None,
) -> AsyncSmoothResult:
    """Solve A x = b by asynchronous block relaxation on `device` (None: the
    CUDA device; raises without one; A and sm must live there).
    draws=None takes GeneratorSmoothDraws(seed). `mesh`: the row mesh whose
    rows A, sm, b and x0 are (a halo operator's); the blocks stay those of
    the global rows (neighbor_mask indexes them), each process relaxes its
    rows of the firing blocks, and the blocks' residual norms and the solve's
    norms reduce over the mesh."""
    device = resolve_device(device)
    if sm.inv_wscale.device != device:
        raise ValueError(f"operator lives on {sm.inv_wscale.device}, solve asked for {device}")
    dtype = sm.inv_wscale.dtype
    b = torch.as_tensor(b).to(device=device, dtype=dtype)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorSmoothDraws(seed, device)
    n = b.shape[0]
    B = cfg.num_blocks
    norm = torch.linalg.norm if mesh is None else mesh.norm
    n_all, rows = n, slice(0, n)
    if mesh is not None and mesh.world_size > 1:
        n_all = n * mesh.world_size
        rows = mesh.local_rows(n_all)
    # this process's rows -> their blocks of the global rows
    seg = torch.arange(rows.start, rows.stop, device=device) // -(-n_all // B)
    nbr = torch.as_tensor(np.asarray(neighbor_mask, dtype=bool), device=device)
    if cfg.sps_min_prob > 0.0:
        deg = torch.clamp(nbr.sum(dim=1).to(dtype), min=1.0)
        alpha = -math.log(cfg.sps_min_prob) / deg
    else:
        alpha = cfg.sps_alpha

    r = b - A @ x
    r0n = norm(r)
    safe_r0 = torch.where(r0n == 0.0, torch.ones_like(r0n), r0n)
    counts = torch.zeros(B, dtype=torch.int64, device=device)
    relnorm = torch.full((), float("inf"), dtype=dtype, device=device)
    hist = [1.0]
    k, rel = 0, float("inf")
    while k < max_cycles and rel > tol:
        if cfg.method == "fixed":
            p = torch.full((B,), cfg.fire_prob, dtype=dtype, device=device)
        else:
            rnorms = torch.zeros(B, dtype=dtype, device=device).index_add_(0, seg, r.abs())
            if mesh is not None:
                rnorms = mesh.all_reduce(rnorms)
            bigger = (rnorms[None, :] > rnorms[:, None]) & nbr
            xcount = bigger.sum(dim=1).to(dtype)
            if cfg.method == "southwell_inv":
                p = 1.0 / torch.clamp(xcount * alpha, min=1.0)
            else:
                p = torch.exp(-xcount * alpha)
        fire = draws.step(B, dtype, device) < p
        du = smooth(A, sm, cfg.smoother, x, b, num_sweeps=1) - x
        x = x + torch.where(fire[seg], du, torch.zeros_like(du))
        counts += fire
        r = b - A @ x  # the next step's residual too (x is unchanged until then)
        relnorm = norm(r) / safe_r0
        k += 1
        rel = float(relnorm)  # the step's one host read
        hist.append(rel)
    return AsyncSmoothResult(x=x, iters=k, rel_resnorm=relnorm,
                             history=nan_padded(hist, max_cycles + 1, dtype, device),
                             block_updates=counts)
