"""The extended-system BPX solver: the whole multilevel operator as one
system (counterpart of amg_tpu/solve/extended.py), on one device or, with
grid parallelism, with its level blocks on the shards of a row mesh
(`build_sharded_extended_system`).

With Pchain_k = P_0 ... P_{k-1} (level k -> level 0) and
C = [Pchain_0 | ... | Pchain_{L-1}], the extended system is the Galerkin
product over the concatenated chains,

    AA = C^T A_0 C,   AA_{l,m} = Pchain_l^T A_0 Pchain_m,

assembled as one ELL matrix (explicit mode) or applied through the chains
(implicit mode). `ext_solve` runs Chebyshev-weighted Jacobi on
AA U = C^T r0 and monitors the true fine residual of x = x0 + C U; with
async_fire_prob < 1 each level block updates only when it fires, from a
stale snapshot of U, under a damped Richardson weight.

The reference runs the loop as one jitted while loop with jax.random
draws; here it is a host loop that reads one device scalar a step, with
the (L,) firing and read uniforms from an injectable draw source
(`ExtDrawSource`; by default a CPU torch.Generator).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional, Protocol, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from amg_tpu_torch.solve.accel import ChebyCoeffs, cheby_init, cheby_update
from amg_tpu_torch.solve.driver import _check_device, nan_padded
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.ell import ELLMatrix, ell_from_csr


@dataclass
class ExtendedSystem:
    pchains: Tuple[ELLMatrix, ...]  # n0 x n_k, the level-k chain prolongation
    rchains: Tuple[ELLMatrix, ...]  # n_k x n0, their transposes
    inv_wdiag: torch.Tensor  # (N,) w / diag(AA): the Jacobi scaling
    AA: Optional[ELLMatrix]  # explicit mode only
    offsets: Tuple[int, ...]  # block offsets, len L + 1
    # the grid-mapped system's row mesh: U, inv_wdiag and AA's rows are this
    # process's rows of the extended vector; the fine vectors are whole
    mesh: Any = None

    @property
    def rows(self) -> slice:
        """This process's rows of the extended vector."""
        N = self.offsets[-1]
        return slice(0, N) if self.mesh is None else self.mesh.local_rows(N)

    def row_levels(self) -> torch.Tensor:
        """The level block of each of this process's rows, on the device."""
        lvl = np.repeat(np.arange(len(self.offsets) - 1), np.diff(self.offsets))[self.rows]
        return torch.from_numpy(lvl).to(self.inv_wdiag.device)


def build_extended_system(
    hh, params, explicit: bool = False, weight: Optional[float] = None, device=None
) -> ExtendedSystem:
    """The extended system of a host hierarchy, on `device` (None: the CUDA
    device; raises without one) in params.dtype."""
    from amg_tpu_torch.dtypes import resolve_device

    device = resolve_device(device)
    dtype = params.dtype
    L = hh.num_levels
    A0 = hh.levels[0].A.to_scipy()
    chains = [sp.identity(hh.levels[0].A.n_rows, format="csr")]
    for k in range(L - 1):
        chains.append((chains[-1] @ hh.levels[k].P.to_scipy()).tocsr())

    def ell(m):
        return ell_from_csr(CSRMatrix.from_scipy(m), dtype=dtype, device=device)

    pchains = tuple(ell(c) for c in chains)
    rchains = tuple(ell(c.T.tocsr()) for c in chains)
    offsets = [0]
    for lv in hh.levels:
        offsets.append(offsets[-1] + lv.A.n_rows)
    # diag(AA_kk) = diag(A_k); the weight per level from the hierarchy
    diags = []
    for lv in hh.levels:
        d = lv.A.diagonal()
        d = np.where(d == 0.0, 1.0, d)
        diags.append((weight if weight is not None else lv.weight) / d)
    inv_wdiag = torch.from_numpy(np.concatenate(diags)).to(device=device, dtype=dtype)
    AA = None
    if explicit:
        AA_sp = sp.bmat([[(chains[l].T @ A0 @ chains[m]).tocsr() for m in range(L)]
                         for l in range(L)], format="csr")
        AA_sp.data[np.abs(AA_sp.data) < 1e-300] = 0.0
        AA_sp.eliminate_zeros()
        AA = ell(AA_sp)
    return ExtendedSystem(pchains=pchains, rchains=rchains, inv_wdiag=inv_wdiag, AA=AA,
                          offsets=tuple(offsets))


def build_sharded_extended_system(
    hh, params, mesh, imbalance: float = 0.0, assign_policy: str = "balanced",
    assign_scalar: float = 0.5,
) -> ExtendedSystem:
    """Grid parallelism on the extended system, over the shards of `mesh`
    (a RowMesh, one process; on its device): each level block padded to the
    shard range of its work-model group (`parallel.dist.pad_extended_layout`,
    the reference's AssignProcs split applied to the flattened PAR_BPX
    system), so that a plain row split of the flat vector puts level k's
    rows on its group's shards. AA, assembled with its padding in one COO
    pass, is a HaloELL row-sharded over the mesh: shard d holds exactly its
    levels' block rows, and its ghost exchange is the gridj -> gridk
    correction exchange (`parallel.spcomm.comm_trace` counts it). Padding
    rows carry a unit diagonal and a zero inv_wdiag, so they never move.
    The chains keep the padded block widths; `ext_matvec`,
    `estimate_cycle_eigs` (with mesh=ext.mesh) and `ext_solve` take the
    system unchanged. Across processes U is this process's rows of the
    extended vector (and inv_wdiag with it), the fine vectors are whole in
    every process, and the chains read them whole: `ext_prolong` gathers U,
    `ext_restrict` keeps this process's block rows, as GSPMD computes."""
    from amg_tpu_torch.parallel.dist import pad_extended_layout
    from amg_tpu_torch.parallel.partition import assign_levels_to_devices, compute_level_work
    from amg_tpu_torch.parallel.spcomm import build_halo_ell

    device = mesh.device
    L = hh.num_levels
    D = mesh.n_devices
    dtype = params.dtype
    sizes = [lv.A.n_rows for lv in hh.levels]
    work = compute_level_work(hh, imbalance=imbalance)
    assignment = assign_levels_to_devices(work, D, policy=assign_policy, scalar=assign_scalar)
    p_off, p_total, row_owner = pad_extended_layout(sizes, assignment, D)

    A0 = hh.levels[0].A.to_scipy()
    n0 = sizes[0]
    chains = [sp.identity(n0, format="csr")]
    for k in range(L - 1):
        chains.append((chains[-1] @ hh.levels[k].P.to_scipy()).tocsr())

    def ell(m):
        return ell_from_csr(CSRMatrix.from_scipy(m), dtype=dtype, device=device)

    pch = []
    for k in range(L):  # n0 x block width, the level's columns first
        c = chains[k].tocsr().copy()
        c.resize((n0, p_off[k + 1] - p_off[k]))
        pch.append(c)
    pchains = tuple(ell(c) for c in pch)
    rchains = tuple(ell(c.T.tocsr()) for c in pch)

    # AA_{l,m} = chain_l^T A0 chain_m, every block and the padding's unit
    # diagonal in one COO pass
    rows_all, cols_all, data_all = [], [], []
    for l in range(L):
        left = (chains[l].T @ A0).tocsr()
        for m in range(L):
            blk = (left @ chains[m]).tocoo()
            rows_all.append(blk.row + p_off[l])
            cols_all.append(blk.col + p_off[m])
            data_all.append(blk.data)
    pad_rows = np.flatnonzero(row_owner < 0)
    rows_all.append(pad_rows)
    cols_all.append(pad_rows)
    data_all.append(np.ones(pad_rows.size))
    AA_sp = sp.coo_matrix((np.concatenate(data_all),
                           (np.concatenate(rows_all), np.concatenate(cols_all))),
                          shape=(p_total, p_total)).tocsr()
    AA_sp.data[np.abs(AA_sp.data) < 1e-300] = 0.0
    AA_sp.eliminate_zeros()
    AA = build_halo_ell(CSRMatrix.from_scipy(AA_sp), mesh, dtype=dtype)

    inv_wdiag = np.zeros(p_total)
    for k, lv in enumerate(hh.levels):
        d = lv.A.diagonal()
        d = np.where(d == 0.0, 1.0, d)
        inv_wdiag[p_off[k]: p_off[k] + sizes[k]] = lv.weight / d
    rows = mesh.local_rows(p_total)
    return ExtendedSystem(pchains=pchains, rchains=rchains,
                          inv_wdiag=torch.from_numpy(inv_wdiag[rows]).to(device=device,
                                                                          dtype=dtype),
                          AA=AA, offsets=tuple(p_off), mesh=mesh)


def ext_prolong(ext: ExtendedSystem, U: torch.Tensor) -> torch.Tensor:
    """x = C U = sum_k Pchain_k U_k (a fine-grid vector, whole; U is
    gathered across processes first)."""
    if ext.mesh is not None:
        U = ext.mesh.gather(U)
    x = None
    for k, pc in enumerate(ext.pchains):
        c = pc @ U[ext.offsets[k]: ext.offsets[k + 1]]
        x = c if x is None else x + c
    return x


def ext_restrict(ext: ExtendedSystem, y: torch.Tensor) -> torch.Tensor:
    """C^T y: the restrict chains of a fine-grid vector, concatenated (this
    process's rows of it: the chains of the blocks that meet them)."""
    rows, parts = ext.rows, []
    for k, r in enumerate(ext.rchains):
        lo, hi = max(ext.offsets[k], rows.start), min(ext.offsets[k + 1], rows.stop)
        if lo < hi:
            parts.append((r @ y)[lo - ext.offsets[k]: hi - ext.offsets[k]])
    return torch.cat(parts)


def ext_matvec(ext: ExtendedSystem, A0, U: torch.Tensor) -> torch.Tensor:
    """AA @ U: the explicit ELL, or through the chains."""
    if ext.AA is not None:
        return ext.AA @ U
    return ext_restrict(ext, A0 @ ext_prolong(ext, U))


class ExtSolveResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_resnorm: torch.Tensor
    history: torch.Tensor  # relative residual per step, NaN-padded

    def history_list(self):
        h = self.history.detach().cpu().numpy()
        return h[~np.isnan(h)].tolist()


class ExtDrawSource(Protocol):
    def step(self, L: int) -> Tuple[np.ndarray, np.ndarray]:
        """This step's (L,) firing uniforms and (L,) read uniforms."""


class GeneratorExtDraws:
    """The production draw source: a CPU torch.Generator seeded from `seed`
    (the draws are per block, so the host knows who fires)."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(seed)

    def step(self, L):
        u = torch.rand(2, L, generator=self._gen, dtype=torch.float64).numpy()
        return u[0], u[1]


def ext_solve(
    hier,
    ext: ExtendedSystem,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    max_cycles: int = 300,
    cheby_coeffs: Optional[ChebyCoeffs] = None,
    async_fire_prob: float = 1.0,
    sim_read_delay: int = 0,
    draws: Optional[ExtDrawSource] = None,
    seed: int = 0,
    device=None,
) -> ExtSolveResult:
    """Solve A x = b by (async) Chebyshev-weighted Jacobi on the extended
    system, on `device` (None: the CUDA device; raises without one; the
    hierarchy and `ext` must live there). draws=None takes
    GeneratorExtDraws(seed)."""
    device = _check_device(hier, device)
    b = torch.as_tensor(b).to(device=device, dtype=hier.dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorExtDraws(seed)
    A0 = hier.levels[0].A
    L = len(ext.pchains)
    N = ext.inv_wdiag.shape[0]  # this process's rows of the extended vector
    row_lvl = ext.row_levels()
    W = sim_read_delay + 1
    async_on = async_fire_prob < 1.0

    r0 = b - A0 @ x0
    r0norm = torch.linalg.norm(r0)
    safe_r0 = torch.where(r0norm == 0.0, torch.ones_like(r0norm), r0norm)
    FF = ext_restrict(ext, r0)
    U = torch.zeros(N, dtype=b.dtype, device=device)
    ring = U.unsqueeze(0).repeat(W, 1) if async_on else None  # the stale snapshots
    ch = cheby_init(N, b.dtype, device)
    x = x0
    relnorm = torch.full((), float("inf"), dtype=b.dtype, device=device)
    hist = [1.0]
    k, rel = 0, float("inf")
    while k < max_cycles and rel > tol:
        u_fire, u_read = draws.step(L)
        if async_on:
            fire = u_fire < async_fire_prob
            low = max(k - sim_read_delay, 0)
            col = np.round(low + u_read * (k - low)).astype(np.int64)
            slot = torch.from_numpy(col % W).to(device)[row_lvl]
            U_read = ring.gather(0, slot.unsqueeze(0)).squeeze(0)
        else:
            U_read = U
        du = ext.inv_wdiag * (FF - ext_matvec(ext, A0, U_read))
        if cheby_coeffs is not None:
            if async_on:
                # the global recurrence does not hold under partial, stale
                # updates: the damped stationary Richardson weight instead
                du = (0.6 * 2.0 / (cheby_coeffs.alpha + cheby_coeffs.beta)) * du
            else:
                ch = cheby_update(ch, du, cheby_coeffs)
                du = ch.d
        if async_on:
            U = torch.where(torch.from_numpy(fire).to(device)[row_lvl], U + du, U)
        else:
            U = U + du
        x = x0 + ext_prolong(ext, U)
        relnorm = torch.linalg.norm(b - A0 @ x) / safe_r0
        if async_on:
            ring[(k + 1) % W].copy_(U)
        k += 1
        rel = float(relnorm)  # the step's one host read
        hist.append(rel)
    return ExtSolveResult(x=x, iters=k, rel_resnorm=relnorm,
                          history=nan_padded(hist, max_cycles + 1, b.dtype, device))
