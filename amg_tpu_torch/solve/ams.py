"""Auxiliary-space (Hiptmair-Xu / AMS-style) preconditioner for curl-curl
systems, on a single device (counterpart of amg_tpu/solve/ams.py).

The curl-curl operator's near-nullspace is the range of the discrete
gradient G (C G = 0), which nodal AMG cannot see in the edge unknowns. The
additive Hiptmair-Xu decomposition corrects in both auxiliary spaces:

    M^-1 r  =  w S^-1 r  +  G B_n(G^T r)  +  Pi B_p(Pi^T r)

with w S^-1 one L1-Jacobi sweep on the edge operator, B_n one cycle on the
nodal operator A_n = G^T A G and B_p one cycle on the vector-nodal operator
A_p = Pi^T A Pi (Pi the Nedelec nodal interpolation,
problems.maxwell's aux["Pi"]). M is SPD, so it drives PCG
(`solve_ams_pcg`). Pi=None leaves the two-term variant.

`ams_async_additive_solve` runs the edge smoother and every nodal level as
independent correction groups that fire at their own rates against
bounded-staleness iterates. The reference draws its random numbers with
jax.random inside one jitted loop; here the loop takes the raw draws from a
draw source (per step, Lg firing and Lg column uniforms), makes every
comparison and rounding itself and reads the device once a step (the stop
test). A group that does not fire computes nothing.

`build_sharded_ams` / `solve_sharded_ams_pcg` run AMS-PCG row-sharded over a
mesh of D shards (`parallel.dist`): the edge operator, G, G^T (and Pi, Pi^T)
as halo operators (`parallel.spcomm`), the nodal hierarchies as halo
hierarchies. The reference's grid-parallel AMS groups (plan_ams_groups,
ams_grid_parallel_solve) are ROADMAP queue 1 item 11b.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Protocol, Tuple

import numpy as np
import torch

from amg_tpu_torch.dtypes import resolve_device
from amg_tpu_torch.setup.hierarchy import (
    Hierarchy,
    HierarchyParams,
    _format_converter,
    build_hierarchy,
)
from amg_tpu_torch.setup.rap import estimate_rho_dinv_a
from amg_tpu_torch.smooth.smoothers import SmootherType
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType, additive_correction, cycle_step
from amg_tpu_torch.solve.driver import SolveResult, nan_padded
from amg_tpu_torch.solve.krylov import pcg
from amg_tpu_torch.sparse.csr import CSRMatrix


class AMSData(NamedTuple):
    """Device-side preconditioner state."""

    G: object  # edges x nodes device matrix
    Gt: object  # nodes x edges
    inv_wscale: torch.Tensor  # edge smoother w / scale
    node_hier: Hierarchy  # AMG hierarchy on G^T A G
    Pi: object = None  # edges x 3 nodes Nedelec nodal interpolation
    Pit: object = None
    pi_hier: Optional[Hierarchy] = None  # AMG hierarchy on Pi^T A Pi


def build_ams(
    A_edge: CSRMatrix,
    G: CSRMatrix,
    params: Optional[HierarchyParams] = None,
    smoother_weight: Optional[float] = None,
    Pi: Optional[CSRMatrix] = None,
    device=None,
) -> Tuple[AMSData, CycleConfig]:
    """Set up the AMS preconditioner on `device` (None: the CUDA device;
    raises without one). Returns (AMSData, node CycleConfig).

    `G` is the discrete gradient and `Pi` the (optional) Nedelec nodal
    interpolation (Problem.aux["G"] / aux["Pi"] of problems.maxwell); with
    Pi the full two-auxiliary-space decomposition is built."""
    from amg_tpu_torch.convert import matrix_from_arrays

    device = resolve_device(device)
    if params is None:
        params = HierarchyParams(keep_stencil_fine=False)
    dtype = params.dtype
    convert = _format_converter(params)

    def dev(m):
        return matrix_from_arrays(convert(m), dtype, device)

    # nodal operator A_n = G^T A G (host SpGEMM, setup-time)
    As = A_edge.to_scipy().tocsr()
    Gs = G.to_scipy().tocsr()
    A_n = CSRMatrix.from_scipy((Gs.T @ (As @ Gs)).tocsr())
    _, node_hier = build_hierarchy(A_n, params, device=device)
    pi_kw = {}
    if Pi is not None:
        Pis = Pi.to_scipy().tocsr()
        A_p = CSRMatrix.from_scipy((Pis.T @ (As @ Pis)).tocsr())
        _, pi_hier = build_hierarchy(A_p, params, device=device)
        pi_kw = dict(Pi=dev(Pi), Pit=dev(Pi.transpose()), pi_hier=pi_hier)
    # SPD edge smoother term: w / scale with w = 1 / rho(S^-1 A)
    scale = A_edge.l1_row_norms()
    scale = np.where(scale == 0.0, 1.0, scale)
    if smoother_weight is None:
        smoother_weight = 1.0 / max(
            estimate_rho_dinv_a(A_edge, seed=params.seed, scale=scale), 1e-12
        )
    data = AMSData(
        G=dev(G), Gt=dev(G.transpose()),
        inv_wscale=torch.from_numpy(smoother_weight / scale).to(device=device, dtype=dtype),
        node_hier=node_hier, **pi_kw,
    )
    return data, CycleConfig(cycle=CycleType.MULT, smoother=params.smoother)


def ams_precondition(ams: AMSData, cfg: CycleConfig, r: torch.Tensor) -> torch.Tensor:
    """M^-1 r = w S^-1 r + G C(G^T r) [+ Pi C(Pi^T r)], C one cycle of
    cfg's type from a zero guess on the nodal (and vector-nodal)
    hierarchy."""

    def aux_cycle(hier, rr):
        return cycle_step(hier, cfg, torch.zeros_like(rr), rr)

    e = ams.inv_wscale * r + ams.G @ aux_cycle(ams.node_hier, ams.Gt @ r)
    if ams.pi_hier is not None:
        e = e + ams.Pi @ aux_cycle(ams.pi_hier, ams.Pit @ r)
    return e


def _check_ams_device(ams: AMSData, device) -> torch.device:
    device = resolve_device(device)
    if ams.inv_wscale.device != device:
        raise ValueError(f"AMS data lives on {ams.inv_wscale.device}, solve asked for {device}")
    return device


def solve_ams_pcg(
    A_dev,
    ams: AMSData,
    cfg: CycleConfig,
    b,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    max_iters: int = 200,
    device=None,
):
    """PCG on the edge system with the AMS preconditioner, on `device`
    (None: the CUDA device; raises without one)."""
    device = _check_ams_device(ams, device)
    b = torch.as_tensor(b).to(device=device, dtype=ams.inv_wscale.dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    return pcg(lambda v: A_dev @ v, lambda r: ams_precondition(ams, cfg, r), b, x0,
               tol=tol, max_iters=max_iters)


def build_sharded_ams(
    A_edge: CSRMatrix,
    G: CSRMatrix,
    mesh,
    params: Optional[HierarchyParams] = None,
    smoother_weight: Optional[float] = None,
    Pi: Optional[CSRMatrix] = None,
):
    """Row-sharded AMS over `mesh` (a parallel.dist.RowMesh) with halo
    comm, the distributed Maxwell path: the edge operator, the discrete
    gradient G and its transpose as HaloELL operators (boundary segments
    only), the nodal hierarchy on G^T A G as a halo hierarchy, and with Pi
    the second auxiliary space sharded the same way. Edge vectors pad to a
    multiple of the mesh (`dist.pad_unit`), the pad rows decoupled with a
    unit diagonal.

    Returns (A_halo, AMSData, node CycleConfig, pad_edge, pad_node); vectors
    pad with parallel.dist.pad_vector(b, pad_edge, mesh)."""
    from amg_tpu_torch.parallel.dist import _pad_csr, build_dist_hierarchy, pad_unit
    from amg_tpu_torch.parallel.spcomm import build_halo_ell
    from amg_tpu_torch.setup.hierarchy import build_host_hierarchy

    if params is None:
        params = HierarchyParams(keep_stencil_fine=False, device_format="ell")
    dtype = params.dtype
    E = A_edge.n_rows
    As = A_edge.to_scipy().tocsr()
    Gs = G.to_scipy().tocsr()
    A_n = CSRMatrix.from_scipy((Gs.T @ (As @ Gs)).tocsr())
    node_hier, pad_node = build_dist_hierarchy(build_host_hierarchy(A_n, params), params,
                                               mesh, comm="halo")
    unit = pad_unit(params, mesh)
    E_pad = -(-E // unit) * unit
    A_pad = _pad_csr(A_edge, E_pad, E_pad, unit_diag_from=E)
    G_pad = _pad_csr(G, E_pad, pad_node[1])  # zero pad block: the pads decouple
    scale = A_pad.l1_row_norms()  # pad rows: unit diagonal, scale 1
    scale = np.where(scale == 0.0, 1.0, scale)
    if smoother_weight is None:
        smoother_weight = 1.0 / max(
            estimate_rho_dinv_a(A_edge, seed=params.seed, scale=scale[:E]), 1e-12)
    pi_kw = {}
    if Pi is not None:
        Pis = Pi.to_scipy().tocsr()
        A_p = CSRMatrix.from_scipy((Pis.T @ (As @ Pis)).tocsr())
        pi_hier, pad_pi = build_dist_hierarchy(build_host_hierarchy(A_p, params), params,
                                               mesh, comm="halo")
        Pi_pad = _pad_csr(Pi, E_pad, pad_pi[1])
        pi_kw = dict(Pi=build_halo_ell(Pi_pad, mesh, dtype=dtype),
                     Pit=build_halo_ell(Pi_pad.transpose(), mesh, dtype=dtype),
                     pi_hier=pi_hier)
    data = AMSData(
        G=build_halo_ell(G_pad, mesh, dtype=dtype),
        Gt=build_halo_ell(G_pad.transpose(), mesh, dtype=dtype),
        inv_wscale=mesh.shard_vector(torch.from_numpy(smoother_weight / scale).to(dtype)),
        node_hier=node_hier, **pi_kw,
    )
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=params.smoother)
    return build_halo_ell(A_pad, mesh, dtype=dtype), data, cfg, (E, E_pad), pad_node


def solve_sharded_ams_pcg(
    A_halo,
    ams: AMSData,
    cfg: CycleConfig,
    b,
    mesh,
    pad_edge,
    x0=None,
    tol: float = 1e-8,
    max_iters: int = 200,
):
    """PCG on the sharded edge system: b (and x0) the unpadded global
    vectors, the returned x unpadded and global. The pad rows carry a zero
    residual (unit diagonal, zero right-hand side), so dots and norms are
    the unpadded system's; across processes they are all-reduced."""
    from amg_tpu_torch.parallel.dist import pad_vector, unpad_vector

    dtype = ams.inv_wscale.dtype
    b_pad = pad_vector(torch.as_tensor(b).to(dtype), pad_edge, mesh)
    x0_pad = torch.zeros_like(b_pad) if x0 is None else \
        pad_vector(torch.as_tensor(x0).to(dtype), pad_edge, mesh)
    res = pcg(lambda v: A_halo @ v, lambda r: ams_precondition(ams, cfg, r), b_pad, x0_pad,
              tol=tol, max_iters=max_iters, dot=mesh.dot, norm=mesh.norm)
    return res._replace(x=unpad_vector(res.x, pad_edge, mesh))


class AMSDrawSource(Protocol):
    """The raw random numbers of one async AMS solve, in the reference's
    shapes (amg_tpu/solve/ams.py:337-343)."""

    def step(self, Lg: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Lg,) firing uniforms and (Lg,) column uniforms in [0, 1)."""


class GeneratorAMSDraws:
    """The production draw source: a CPU torch.Generator seeded from `seed`,
    so the host knows who fires and what each group reads without a device
    read."""

    def __init__(self, seed: int = 0):
        self._gen = torch.Generator().manual_seed(seed)

    def step(self, Lg):
        u = torch.rand(2, Lg, generator=self._gen, dtype=torch.float64).numpy()
        return u[0], u[1]


def _groups(ams: AMSData, smoothed_transfers: bool):
    """(Lg, correction(g, r)): the async solve's correction groups, the edge
    smoother (g = 0), then each node level's additive correction prolonged
    through G, then each Pi level's through Pi."""
    nL = ams.node_hier.num_levels
    Lg = 1 + nL + (ams.pi_hier.num_levels if ams.pi_hier is not None else 0)
    cfg = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                      use_smoothed_transfers=smoothed_transfers)

    def correction(g, r):
        if g == 0:
            return ams.inv_wscale * r
        if g <= nL:
            return ams.G @ additive_correction(ams.node_hier, cfg, ams.Gt @ r, g - 1)
        return ams.Pi @ additive_correction(ams.pi_hier, cfg, ams.Pit @ r, g - 1 - nL)

    return Lg, correction


def async_ams_eigs(A_dev, ams: AMSData, smoothed_transfers: bool = True):
    """Eigenvalue bounds of the summed group corrections times A
    (estimate_cycle_eigs, 20 power iterations from default_rng(0)): the
    async solve's omega="auto" and its accelerations' coefficients."""
    from amg_tpu_torch.solve.accel import estimate_cycle_eigs

    Lg, correction = _groups(ams, smoothed_transfers)

    def minv_a(u):
        r = A_dev @ u
        c = torch.zeros_like(u)
        for g in range(Lg):
            c = c + correction(g, r)
        return c

    return estimate_cycle_eigs(minv_a, ams.inv_wscale.shape[0], ams.inv_wscale.dtype,
                               num_iters=20, device=ams.inv_wscale.device)


def ams_async_additive_solve(
    A_dev,
    ams: AMSData,
    b,
    x0: Optional[torch.Tensor] = None,
    draws: Optional[AMSDrawSource] = None,
    seed: int = 0,
    omega="auto",  # "auto": 0.7 * 2 / (alpha + beta) from estimated eig bounds
    fire_prob: float = 0.8,
    sim_read_delay: int = 2,
    tol: float = 1e-6,
    max_cycles: int = 600,
    accel: str = "none",  # none | cheby | richardson (asymmetric async)
    cheby_coeffs=None,  # auto-estimated from the additive AMS operator
    cheby_grid: int = 0,  # group keeping the 3-term direction (0 = edge)
    cheby_damp: float = 1.0,  # staleness damping of delta
    cheby_restart: int = 16,  # restart the recurrences every m group-cycles
    smoothed_transfers: bool = True,  # smoothed P~/R~ in the nodal multadds
    device=None,
) -> SolveResult:
    """The asynchronous additive auxiliary-space Maxwell solve, on `device`
    (None: the CUDA device; raises without one): group 0 is the edge
    smoother, group k+1 node level k's additive correction prolonged through
    G, then the Pi levels likewise; each group fires with probability
    fire_prob against an iterate up to sim_read_delay steps stale, and the
    corrections are accumulated into x.

    accel="cheby" runs the reference's asymmetric async Chebyshev (per-group
    three-term recurrences at each group's own rate, the cheby_grid group's
    momentum, restarted every cheby_restart group-cycles), "richardson" its
    constant-omega form. draws=None takes GeneratorAMSDraws(seed)."""
    device = _check_ams_device(ams, device)
    dtype = ams.inv_wscale.dtype
    b = torch.as_tensor(b).to(device=device, dtype=dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorAMSDraws(seed)
    Lg, group_correction = _groups(ams, smoothed_transfers)
    W = sim_read_delay + 1
    accel_on = accel in ("cheby", "richardson")
    cg = min(max(cheby_grid, 0), Lg - 1)

    if cheby_coeffs is None and (accel_on or omega == "auto"):
        cheby_coeffs = async_ams_eigs(A_dev, ams, smoothed_transfers)
    if omega == "auto":
        # 0.7x the synchronous Richardson optimum of the group-sum operator,
        # backed off for staleness (the reference's choice)
        omega = float(0.7 * 2.0 / (cheby_coeffs.alpha + cheby_coeffs.beta))
    mu = float(cheby_coeffs.mu) if accel_on else 2.0
    delta = float(cheby_coeffs.delta) * cheby_damp if accel_on else 0.0

    r0n = float(torch.linalg.norm(b - A_dev @ x0))
    safe = 1.0 if r0n == 0.0 else r0n
    ring = x0.unsqueeze(0).repeat(W, 1)
    x = x0
    d_dir = torch.zeros_like(x0)
    # the recurrences' per-group scalars live on the host, in float64
    cheb_c = np.full(Lg, mu)
    cheb_cp = np.ones(Lg)
    cyc = np.zeros(Lg, dtype=np.int64)
    hist = [1.0]
    rel, k = 1.0, 0
    while k < max_cycles and rel > tol and rel < 1e3:
        fire_u, col_u = draws.step(Lg)
        fire = np.asarray(fire_u) < fire_prob
        low = max(k - sim_read_delay, 0)
        cols = np.round(low + np.asarray(col_u) * (k - low)).astype(np.int64)
        if accel_on:
            c_next = 2.0 * mu * cheb_c - cheb_cp
            if accel == "richardson":
                om = np.full(Lg, 2.0 / (1.0 + (1.0 - 1.0 / (mu ** 2)) ** 0.5))
            else:
                om = 2.0 * mu * cheb_c / c_next
            first_f = cyc == 0
            g_scale = np.where(first_f, 1.0, om * delta)
        else:
            g_scale = np.full(Lg, omega)
        c = torch.zeros_like(x)
        for g in np.flatnonzero(fire):
            r_g = b - A_dev @ ring[cols[g] % W]
            c = c + float(g_scale[g]) * group_correction(int(g), r_g)
        if accel_on:
            if fire[cg] and not first_f[cg]:
                c = c + float(om[cg] - 1.0) * d_dir
            d_dir = c if fire[cg] else d_dir + c
            adv = fire & ~first_f
            cheb_cp = np.where(adv, cheb_c, cheb_cp)
            cheb_c = np.where(adv, c_next, cheb_c)
            cyc = cyc + fire
            if cheby_restart > 0:
                wrap = cyc >= cheby_restart
                cyc = np.where(wrap, 0, cyc)
                cheb_c = np.where(wrap, mu, cheb_c)
                cheb_cp = np.where(wrap, 1.0, cheb_cp)
        x = x + c
        rel = float(torch.linalg.norm(b - A_dev @ x)) / safe
        hist.append(rel)
        k += 1
        ring[k % W] = x
    return SolveResult(x=x, iters=k, rel_resnorm=torch.tensor(rel, dtype=dtype),
                       history=nan_padded(hist, max_cycles + 1, dtype, device))
