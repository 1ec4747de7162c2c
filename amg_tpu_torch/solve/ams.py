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
hierarchies. `ams_grid_parallel_solve` runs the async groups with grid
parallelism over such a mesh: each shard computes the groups the work
model gives it (`plan_ams_groups`) from the operator fields it owns.
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
    the unpadded system's; they sum the shards' dots (`RowMesh.dot`)."""
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


def _group_cfg(smoothed_transfers: bool) -> CycleConfig:
    return CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                       use_smoothed_transfers=smoothed_transfers)


def _num_groups(ams: AMSData) -> int:
    return 1 + ams.node_hier.num_levels + (ams.pi_hier.num_levels if ams.pi_hier is not None
                                           else 0)


def _group_correction(src, cfg: CycleConfig, g: int, r: torch.Tensor) -> torch.Tensor:
    """Correction group g of the async solve, read from `src` (an AMSData or
    a shard's view of one): the edge smoother (g = 0), then each node
    level's additive correction prolonged through G, then each Pi level's
    through Pi."""
    nL = src.node_hier.num_levels
    if g == 0:
        return src.inv_wscale * r
    if g <= nL:
        return src.G @ additive_correction(src.node_hier, cfg, src.Gt @ r, g - 1)
    return src.Pi @ additive_correction(src.pi_hier, cfg, src.Pit @ r, g - 1 - nL)


def async_ams_eigs(A_dev, ams: AMSData, smoothed_transfers: bool = True):
    """Eigenvalue bounds of the summed group corrections times A
    (estimate_cycle_eigs, 20 power iterations from default_rng(0)): the
    async solve's omega="auto" and its accelerations' coefficients."""
    from amg_tpu_torch.solve.accel import estimate_cycle_eigs

    Lg, cfg = _num_groups(ams), _group_cfg(smoothed_transfers)

    def minv_a(u):
        r = A_dev @ u
        c = torch.zeros_like(u)
        for g in range(Lg):
            c = c + _group_correction(ams, cfg, g, r)
        return c

    return estimate_cycle_eigs(minv_a, ams.inv_wscale.shape[0], ams.inv_wscale.dtype,
                               num_iters=20, device=ams.inv_wscale.device)


def _auto_omega(cheby_coeffs) -> float:
    # 0.7x the synchronous Richardson optimum of the group-sum operator,
    # backed off for staleness (the reference's choice)
    return float(0.7 * 2.0 / (cheby_coeffs.alpha + cheby_coeffs.beta))


def _fire_and_cols(draws: AMSDrawSource, Lg: int, fire_prob: float, delay: int, k: int):
    """Step k's draws: which groups fire, and the snapshot each reads, in
    [max(k - delay, 0), k]."""
    fire_u, col_u = draws.step(Lg)
    low = max(k - delay, 0)
    return (np.asarray(fire_u) < fire_prob,
            np.round(low + np.asarray(col_u) * (k - low)).astype(np.int64))


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
    from amg_tpu_torch.solve.async_sim import _Accel

    device = _check_ams_device(ams, device)
    dtype = ams.inv_wscale.dtype
    b = torch.as_tensor(b).to(device=device, dtype=dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorAMSDraws(seed)
    Lg, cfg = _num_groups(ams), _group_cfg(smoothed_transfers)
    W = sim_read_delay + 1
    accel_on = accel in ("cheby", "richardson")

    if cheby_coeffs is None and (accel_on or omega == "auto"):
        cheby_coeffs = async_ams_eigs(A_dev, ams, smoothed_transfers)
    if omega == "auto":
        omega = _auto_omega(cheby_coeffs)
    acc = _Accel(accel, Lg, float(cheby_coeffs.mu), float(cheby_coeffs.delta) * cheby_damp,
                 cheby_grid, b, restart=cheby_restart) if accel_on else None

    r0n = float(torch.linalg.norm(b - A_dev @ x0))
    safe = 1.0 if r0n == 0.0 else r0n
    ring = x0.unsqueeze(0).repeat(W, 1)
    x = x0
    hist = [1.0]
    rel, k = 1.0, 0
    while k < max_cycles and rel > tol and rel < 1e3:
        fire, cols = _fire_and_cols(draws, Lg, fire_prob, sim_read_delay, k)
        g_scale = acc.scales() if accel_on else np.full(Lg, omega)
        c = torch.zeros_like(x)
        for g in np.flatnonzero(fire):
            r_g = b - A_dev @ ring[cols[g] % W]
            c = c + float(g_scale[g]) * _group_correction(ams, cfg, int(g), r_g)
        if accel_on:
            c = acc.finish(c, fire)
        x = x + c
        rel = float(torch.linalg.norm(b - A_dev @ x)) / safe
        hist.append(rel)
        k += 1
        ring[k % W] = x
    return SolveResult(x=x, iters=k, rel_resnorm=torch.tensor(rel, dtype=dtype),
                       history=nan_padded(hist, max_cycles + 1, dtype, device))


def plan_ams_groups(ams: AMSData, num_devices: int):
    """The work model's assignment of the AMS correction groups to the
    shards of a mesh (the AssignProcs analog, src/DMEM_Setup.cpp:1638-1759),
    the reference's: the edge smoother weighs the edge count, an auxiliary
    level k the nnz of one transfer per chain level above it, halved, plus
    its A's nnz, at least 1. Device matrices carry no `nnz` in either
    package, so every auxiliary level weighs 1, and the work goes to the
    assignment unnormalised, so with more groups than shards every group
    lands on the last shard (ROADMAP F13). Returns (groups_of, scale),
    scale[g] = 1 / (the shards sharing group g)."""
    from amg_tpu_torch.parallel.partition import assign_levels_to_devices

    def level_work(hier):
        out = []
        for k in range(hier.num_levels):
            w = 0.0
            for j in range(k):
                lv = hier.levels[j]
                for f in ("R_s", "R", "P_s", "P"):
                    op = getattr(lv, f, None)
                    if op is not None and hasattr(op, "nnz"):
                        w += op.nnz / 2.0  # one R and one P walk the chain
                        break
            w += getattr(hier.levels[k].A, "nnz", 0) or 0
            out.append(max(w, 1.0))
        return out

    work = [float(ams.inv_wscale.shape[0])] + level_work(ams.node_hier)
    if ams.pi_hier is not None:
        work += level_work(ams.pi_hier)
    assignment = assign_levels_to_devices(np.asarray(work), num_devices)
    groups_of = [[] for _ in range(num_devices)]
    scale = np.zeros(len(work))
    for g, (s, e) in enumerate(assignment):
        e = max(e, s + 1)
        scale[g] = 1.0 / (e - s)
        for d in range(s, min(e, num_devices)):
            groups_of[d].append(g)
    return tuple(tuple(gs) for gs in groups_of), scale


def _ams_owned_rows(ams: AMSData, groups_of, cfg_add: CycleConfig):
    """Per shard, the operator fields its AMS groups read: the edge scale
    (group 0); G, G^T and the node hierarchy's chain down to its level with
    that level's A and smoother, or the coarse inverse (node groups); Pi,
    Pi^T and the vector-nodal chain likewise (Pi groups). Every group owns
    its copies, the reference's redistributed gridk ownership."""
    nL = ams.node_hier.num_levels

    def chain_fields(tag, hier, k, row):
        for j in range(k):
            lv = hier.levels[j]
            if cfg_add.use_smoothed_transfers and lv.R_s is not None:
                row[(tag, j, "R_s")] = lv.R_s
            else:
                row[(tag, j, "R")] = lv.R
            if cfg_add.use_smoothed_transfers and lv.P_s is not None:
                row[(tag, j, "P_s")] = lv.P_s
            else:
                row[(tag, j, "P")] = lv.P
        if k == hier.num_levels - 1:
            row[(tag, "coarse")] = hier.coarse_Ainv
        else:
            row[(tag, k, "A")] = hier.levels[k].A
            row[(tag, k, "sm")] = hier.levels[k].sm

    rows = []
    for gs in groups_of:
        row = {}
        for g in gs:
            if g == 0:
                row[("edge", "inv_wscale")] = ams.inv_wscale
            elif g <= nL:
                row[("G",)] = ams.G
                row[("Gt",)] = ams.Gt
                chain_fields("n", ams.node_hier, g - 1, row)
            else:
                row[("Pi",)] = ams.Pi
                row[("Pit",)] = ams.Pit
                chain_fields("p", ams.pi_hier, g - 1 - nL, row)
        rows.append(row)
    return rows


def _ams_view(ams: AMSData, row: dict):
    """A shard's AMS view from its owned row (its values on the solve's
    device): the edge scale, G / G^T, Pi / Pi^T and the two auxiliary
    hierarchies' views, each raising on a field the shard does not own."""
    from amg_tpu_torch.parallel.grid import LEVEL_FIELDS, OwnedFields, OwnedView

    def hier_view(tag, hier):
        if hier is None:
            return None
        levels = []
        for j, lv in enumerate(hier.levels):
            levels.append(OwnedFields(f"{tag} level {j}", {
                f: row.get((tag, j, f)) for f in LEVEL_FIELDS
                if (tag, j, f) in row or getattr(lv, f) is None}))
        return OwnedView(levels, row.get((tag, "coarse")), (tag, "coarse") in row)

    top = {"node_hier": hier_view("n", ams.node_hier), "pi_hier": hier_view("p", ams.pi_hier)}
    for key, name in ((("edge", "inv_wscale"), "inv_wscale"), (("G",), "G"), (("Gt",), "Gt"),
                      (("Pi",), "Pi"), (("Pit",), "Pit")):
        if key in row:
            top[name] = row[key]
    return OwnedFields("the AMS groups", top)


def ams_grid_parallel_solve(
    A_dev,
    ams: AMSData,
    mesh,
    b,
    x0: Optional[torch.Tensor] = None,
    draws: Optional[AMSDrawSource] = None,
    seed: int = 0,
    fire_prob: float = 0.8,
    sim_read_delay: int = 2,
    tol: float = 1e-6,
    max_cycles: int = 600,
    cheby_coeffs=None,
):
    """The asynchronous additive Maxwell solve over the shards of `mesh`
    (a RowMesh; its device runs the solve): `ams_async_additive_solve`'s
    groups and draws, but shard d computes only its groups of
    `plan_ams_groups`, each scaled by 1 / (the shards sharing it), from the
    operator fields it owns; the fine edge operator is replicated. omega is
    "auto", from cheby_coeffs (None: `async_ams_eigs`). A
    superstep sums the shards' partial corrections once, in shard order,
    and the shards' row-range partials of the residual norm once (across
    processes: one all-gather each, then the same sums). Stops at
    rel <= tol, after max_cycles, or at rel >= 1e3 (divergence).
    draws=None takes GeneratorAMSDraws(seed). Returns (SolveResult,
    owned_bytes), the bytes of each shard's owned fields."""
    from amg_tpu_torch.parallel.grid import (
        _gathered,
        _seq_sum,
        _shard_norm_partials,
        _shard_sum,
        field_bytes,
        on_device,
    )

    D = mesh.n_devices
    device = mesh.device
    dtype = ams.inv_wscale.dtype
    b = torch.as_tensor(b).to(device=device, dtype=dtype)
    x0 = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0).to(b)
    if draws is None:
        draws = GeneratorAMSDraws(seed)
    Lg, cfg_add = _num_groups(ams), _group_cfg(True)
    W = sim_read_delay + 1
    groups_of, gscale = plan_ams_groups(ams, D)
    omega = _auto_omega(cheby_coeffs if cheby_coeffs is not None
                        else async_ams_eigs(A_dev, ams))

    rows = _ams_owned_rows(ams, groups_of, cfg_add)
    owned_bytes = [sum(field_bytes(v) for v in row.values()) for row in rows]
    local = list(range(mesh.first_shard, mesh.first_shard + mesh.local_devices))
    memo = {}
    A = on_device(A_dev, device, memo)
    views = {d: _ams_view(ams, {k: on_device(v, device, memo) for k, v in rows[d].items()})
             for d in local}

    def norm(r):
        part = _shard_norm_partials(r, D)[mesh.first_shard: mesh.first_shard + len(local)]
        return float(np.sqrt(_seq_sum(_gathered(mesh, part.unsqueeze(1))[:, 0])))

    r0n = norm(b - A @ x0)
    safe = 1.0 if r0n == 0.0 else r0n
    ring = x0.unsqueeze(0).repeat(W, 1)
    x = x0
    hist = [1.0]
    rel, k = 1.0, 0
    while k < max_cycles and rel > tol and rel < 1e3:
        fire, cols = _fire_and_cols(draws, Lg, fire_prob, sim_read_delay, k)
        working = [d for d in range(D) if any(fire[g] for g in groups_of[d])]
        c_part = {}
        for d in local:
            if d not in working:
                continue
            c = None
            for g in groups_of[d]:
                if fire[g]:
                    r_g = b - A @ ring[cols[g] % W]
                    cg_ = float(gscale[g]) * _group_correction(views[d], cfg_add, g, r_g)
                    c = cg_ if c is None else c + cg_
            c_part[d] = c
        if working:
            x = x + omega * _shard_sum(mesh, c_part, working, b)
        rel = norm(b - A @ x) / safe
        hist.append(rel)
        k += 1
        ring[k % W] = x
    return SolveResult(x=x, iters=k, rel_resnorm=torch.tensor(rel, dtype=dtype),
                       history=nan_padded(hist, max_cycles + 1, dtype, device)), owned_bytes
