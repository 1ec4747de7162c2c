"""AMG hierarchy construction and its containers (counterpart of
amg_tpu/setup/hierarchy.py).

Host phase (float64 numpy/scipy and the port's native setup library, once
per matrix): strength -> C/F split (PMIS/HMIS) -> interpolation (direct or
ext+i, truncated) -> explicit R = P^T -> Galerkin RAP -> recurse; plus the
smoothed transfers, the injection and AFACj ideal interpolants, and the
per-level smoother weights.

Device phase (`device_hierarchy`): every level's A, P and R become float64
array dicts in the format `_format_converter` picks (ELL, or the reference's
cost-model BSR tile; level 0 keeps its stencil or DIA operator), and so do
the additive cycles' transfers (smoothed P~/R~, AFACj ideal P_id/R_id);
`convert.hierarchy_from_arrays` puts them on the device in the solve dtype;
the coarsest A becomes a dense inverse applied by one matmul. The injection
restriction R_inj stays on the host: no correction reads it, the
grid-parallel ones included.

Every set-up is timed by phase (`utils/tracing.py::setup_span`), per level:
`setup.rho` (the smoother weight's spectral radius), `setup.strength`,
`setup.coarsen` (the C/F split, or SA's aggregation), `setup.interp` (the
interpolant with its truncation and its transpose, or SA's tentative and
smoothed prolongator), `setup.ideal` (R_inj, P_id/R_id), `setup.transfers`
(the smoothed P~/R~) and `setup.rap`; once, `setup.device` (the device
formats, their upload and the coarse inverse, synchronised).
`Level`/`Hierarchy` hold the device side of both this builder and the
structured ones (`setup/structured.py`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from amg_tpu_torch.setup.coarsen import C_PT, COARSENING, F_PT
from amg_tpu_torch.setup.interp import (
    direct_interpolation,
    extended_i_interpolation,
    truncate_interpolation,
)
from amg_tpu_torch.setup.rap import estimate_rho_dinv_a, galerkin_product, smoothed_transfer
from amg_tpu_torch.setup.strength import strength_graph
from amg_tpu_torch.smooth.smoothers import SmootherData, SmootherType, make_smoother_data
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import setup_span


@dataclass(frozen=True)
class HierarchyParams:
    """Setup knobs of the classical and smoothed-aggregation hierarchies (the
    reference's, with a torch `dtype`)."""

    strong_threshold: float = 0.25
    coarsen_type: str = "hmis"  # a key of setup.coarsen.COARSENING
    interp_type: str = "ext+i"  # "direct" | "ext+i"
    trunc_factor: float = 0.0
    p_max_elmts: int = 4
    max_levels: int = 25
    max_coarse_size: int = 64
    seed: int = 0
    num_functions: int = 1  # >1: unknown-based systems AMG (elasticity)
    smoother: SmootherType = SmootherType.L1_JACOBI
    smooth_weight: Optional[float] = None  # None -> 1/rho(S^-1 A) per level
    block_size: int = 128
    build_smoothed_transfers: bool = True  # multadd P~/R~
    dtype: Any = torch.float64
    keep_stencil_fine: bool = True  # level 0 keeps the stencil / DIA operator
    # device operator format: "ell", "bsr_auto" (the reference's cost-model
    # BSR tile) or "auto" (the port's rule, _format_converter)
    device_format: str = "auto"
    # aggressive coarsening on the first agg_num_levels levels: the C/F split
    # is coarsened a second time and the interpolant composed through the
    # intermediate grid, P = P1 P2
    agg_num_levels: int = 0
    # truncation of the additive smoothed transfers
    add_trunc_factor: float = 0.0
    add_p_max_elmts: int = 0
    # setup family: "classical" (PMIS/HMIS + ext+i) or "sa" (smoothed
    # aggregation on near-nullspace candidates, setup/aggregation.py)
    setup_type: str = "classical"
    sa_theta: float = 0.0  # SA symmetric strength threshold
    sa_omega: float = 4.0 / 3.0  # prolongator smoothing: omega / rho(D^-1 A)
    # hybrid-JGS damping: None = undamped, "auto" = damp only if the sweep
    # diverges (1/rho(M^-1 A)), or a float weight
    jgs_weight: Any = "auto"


class Level(NamedTuple):
    """One device-side level. P maps level k+1 -> k; R maps k -> k+1 (both
    None on the coarsest level). The additive cycles' transfers are None
    where the host built none (the structured builders build none): the
    smoothed P~/R~ of the multadd chains and the AFACj ideal interpolant
    P_id = [-D_ff^-1 A_fc; I] with its transpose R_id."""

    A: Any  # StencilOperator | VarStencilOperator | DiaKernelOperator | ELLMatrix | BSRMatrix
    P: Optional[Any]  # StructuredProlong | MaskedTransfer | ELLMatrix | BSRMatrix
    R: Optional[Any]
    sm: SmootherData
    P_s: Optional[Any] = None  # ELLMatrix | BSRMatrix
    R_s: Optional[Any] = None
    P_id: Optional[Any] = None
    R_id: Optional[Any] = None


class Hierarchy(NamedTuple):
    levels: Tuple[Level, ...]
    # dense inverse of the coarsest operator (parallel.dist.GatheredOperator
    # on a mesh that spans processes)
    coarse_Ainv: Any
    # the parallel.dist.RowMesh of a row-sharded hierarchy (None: one device);
    # its solves take their dots and norms from it
    mesh: Any = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.coarse_Ainv.device

    @property
    def dtype(self) -> torch.dtype:
        return self.coarse_Ainv.dtype


@dataclass
class HostLevel:
    A: CSRMatrix
    P: Optional[CSRMatrix] = None
    R: Optional[CSRMatrix] = None
    P_s: Optional[CSRMatrix] = None
    R_s: Optional[CSRMatrix] = None
    R_inj: Optional[CSRMatrix] = None  # injection C-point restriction
    P_id: Optional[CSRMatrix] = None  # AFACj ideal interpolant (diag-Schur)
    R_id: Optional[CSRMatrix] = None
    cf: Optional[np.ndarray] = None
    weight: float = 1.0


@dataclass
class HostHierarchy:
    levels: List[HostLevel] = field(default_factory=list)
    params: Optional[HierarchyParams] = None
    # (level dicts, coarse_Ainv): the float64 arrays that
    # convert.hierarchy_from_arrays turns into a device Hierarchy of any dtype
    arrays: Optional[tuple] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def stats(self) -> dict:
        ns = [lv.A.n_rows for lv in self.levels]
        nnzs = [lv.A.nnz for lv in self.levels]
        return {
            "num_levels": len(ns),
            "n": ns,
            "nnz": nnzs,
            "operator_complexity": sum(nnzs) / nnzs[0] if nnzs else 0.0,
            "grid_complexity": sum(ns) / ns[0] if ns else 0.0,
        }


def _l1_smoother(smoother) -> bool:
    return smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI)


def _same_function(S, func) -> sp.csr_matrix:
    """S without its cross-function couplings (by the tracked function of
    each dof: component identity is positional only on the finest grid)."""
    S = S.tocoo()
    same = func[S.row] == func[S.col]
    return sp.coo_matrix((S.data[same], (S.row[same], S.col[same])), shape=S.shape).tocsr()


def build_host_hierarchy(A: CSRMatrix, params: HierarchyParams) -> HostHierarchy:
    """The classical hierarchy on the host, level by level as the reference
    builds it."""
    tracing.begin_setup()
    hh = HostHierarchy(params=params)
    coarsen = COARSENING[params.coarsen_type]
    interp = {"direct": direct_interpolation, "ext+i": extended_i_interpolation}[
        params.interp_type
    ]
    level_A = A
    # unknown-based systems AMG: each dof's function (component), interleaved
    # on the fine grid, restricted through the C/F splits
    func = np.arange(A.n_rows) % max(params.num_functions, 1)
    for lvl in range(params.max_levels):
        hl = HostLevel(A=level_A)
        if params.smooth_weight is not None:
            hl.weight = params.smooth_weight
        else:
            # per-level damping w ~ 1 / rho(S^-1 A), S the smoother's scaling
            with setup_span("rho", lvl):
                scale = level_A.l1_row_norms() if _l1_smoother(params.smoother) else None
                hl.weight = 1.0 / max(
                    estimate_rho_dinv_a(level_A, seed=params.seed, scale=scale), 1e-12
                )
        hh.levels.append(hl)
        if level_A.n_rows <= params.max_coarse_size or lvl == params.max_levels - 1:
            break
        with setup_span("strength", lvl):
            if params.num_functions > 1:
                S = _same_function(strength_graph(level_A, params.strong_threshold,
                                                  num_functions=1), func)
            else:
                S = strength_graph(level_A, params.strong_threshold)
        with setup_span("coarsen", lvl):
            cf = coarsen(S, seed=params.seed)
        nc = int((cf == C_PT).sum())
        if nc == 0 or nc == level_A.n_rows:
            break  # coarsening stalled
        with setup_span("interp", lvl):
            P = interp(level_A, S, cf)
            P = truncate_interpolation(P, params.trunc_factor, params.p_max_elmts)
        if lvl < params.agg_num_levels:
            # aggressive coarsening: coarsen the first-pass coarse grid again
            # and compose the interpolant through it (two-stage P = P1 P2
            # over the Galerkin intermediate operator)
            with setup_span("rap", lvl):
                A_mid = galerkin_product(P.transpose(), level_A, P)
            crows1 = np.flatnonzero(cf == C_PT)
            with setup_span("strength", lvl):
                if params.num_functions > 1:
                    S2 = _same_function(strength_graph(A_mid, params.strong_threshold,
                                                       num_functions=1), func[crows1])
                else:
                    S2 = strength_graph(A_mid, params.strong_threshold)
            with setup_span("coarsen", lvl):
                cf2 = coarsen(S2, seed=params.seed)
            nc2 = int((cf2 == C_PT).sum())
            if 0 < nc2 < A_mid.n_rows:
                with setup_span("interp", lvl):
                    P2 = interp(A_mid, S2, cf2)
                    P2 = truncate_interpolation(P2, params.trunc_factor, params.p_max_elmts)
                    P = CSRMatrix.from_scipy((P.to_scipy() @ P2.to_scipy()).tocsr())
                # composite C/F split: the second-pass C-points mapped back to
                # this level's rows
                cf_comp = np.full(level_A.n_rows, F_PT, dtype=cf.dtype)
                cf_comp[crows1[np.flatnonzero(cf2 == C_PT)]] = C_PT
                cf = cf_comp
                nc = nc2
        with setup_span("interp", lvl):
            R = P.transpose()
        hl.P, hl.R, hl.cf = P, R, cf
        with setup_span("ideal", lvl):
            hl.R_inj, hl.P_id, hl.R_id = _ideal_transfers(level_A, cf, nc)
        if params.build_smoothed_transfers:
            with setup_span("transfers", lvl):
                scale = (
                    level_A.l1_row_norms()
                    if _l1_smoother(params.smoother)
                    else np.where(level_A.diagonal() == 0.0, 1.0, level_A.diagonal())
                )
                hl.P_s, hl.R_s = smoothed_transfer(level_A, P, scale, hl.weight)
                if params.add_trunc_factor > 0.0 or params.add_p_max_elmts > 0:
                    P_t = truncate_interpolation(hl.P_s, params.add_trunc_factor,
                                                 params.add_p_max_elmts)
                    hl.P_s, hl.R_s = P_t, P_t.transpose()
        with setup_span("rap", lvl):
            level_A = galerkin_product(R, level_A, P)
        func = func[cf == C_PT]
    return hh


def _ideal_transfers(level_A: CSRMatrix, cf: np.ndarray, nc: int) -> tuple:
    """(R_inj, P_id, R_id) of a level: the injection restriction (identity
    on the C-points) and the AFACj ideal interpolant P_id = [-D_ff^-1 A_fc;
    I], from A's COO, with its transpose."""
    crows = np.flatnonzero(cf == C_PT)
    R_inj = CSRMatrix.from_scipy(
        sp.coo_matrix((np.ones(nc), (np.arange(nc), crows)),
                      shape=(nc, level_A.n_rows)).tocsr()
    )
    n_rows = level_A.n_rows
    cmap = np.full(n_rows, -1, np.int64)
    cmap[crows] = np.arange(nc)
    Aco = level_A.to_scipy().tocoo()
    diag = level_A.diagonal()
    diag = np.where(diag == 0.0, 1.0, diag)
    fc = (cf[Aco.row] != C_PT) & (cf[Aco.col] == C_PT)
    pid_rows = np.concatenate([Aco.row[fc], crows])
    pid_cols = np.concatenate([cmap[Aco.col[fc]], np.arange(nc)])
    pid_data = np.concatenate([-Aco.data[fc] / diag[Aco.row[fc]], np.ones(nc)])
    P_id_sp = sp.coo_matrix((pid_data, (pid_rows, pid_cols)), shape=(n_rows, nc)).tocsr()
    return R_inj, CSRMatrix.from_scipy(P_id_sp), CSRMatrix.from_scipy(P_id_sp.T.tocsr())


# the host transfers that go to the device; R_inj stays on the host (no
# correction reads it)
DEVICE_TRANSFERS = ("P", "R", "P_s", "R_s", "P_id", "R_id")


def _csr_dict(m: CSRMatrix, kind: str, **extra) -> dict:
    return {"kind": kind, "indptr": m.indptr, "indices": m.indices, "data": m.data,
            "shape": tuple(m.shape), **extra}


def _format_converter(params: HierarchyParams):
    """The device format of every generic matrix: a callable csr -> matrix
    dict for `convert` (None -> None).

    "auto" is the port's rule: ELL, on the CPU and on the card. The
    reference's "auto" picks the cost-model BSR tile ("bsr_auto") on any
    accelerator, a rule tuned on the TPU v5e's gather costs; `chip_smoke.py`
    times ELL, BSR at that tile and cuSPARSE CSR on this path's coarse
    levels on the H100, and PERF.md records the times that set this rule.
    The reference's fixed-tile "bsr" is not ported: BSR loses to ELL on the
    card at every shape timed."""
    from amg_tpu_torch.sparse.bsr import choose_bsr_shape

    fmt = params.device_format
    if fmt == "auto":
        fmt = "ell"

    def convert(m):
        if m is None:
            return None
        if fmt == "bsr_auto":
            shape, _ = choose_bsr_shape(m)
            if shape is not None:
                return _csr_dict(m, "bsr", bm=shape[0], bn=shape[1])
        return _csr_dict(m, "ell")

    if fmt not in ("ell", "bsr_auto"):
        raise ValueError(f"unknown device_format {params.device_format!r} "
                         "(the port has 'auto', 'ell' and 'bsr_auto')")
    return convert


def dia_kind(device: torch.device, dtype, grid_shape) -> str:
    """The device form of a variable-coefficient (DIA) fine operator: K5's
    DiaKernelOperator ("dia") on the card in a dtype other than float64,
    where the reference takes its Pallas kernel; else the plain
    VarStencilOperator ("var"), as the reference keeps it on the CPU and in
    float64."""
    if device.type == "cuda" and dtype != torch.float64 and len(grid_shape) == 3:
        return "dia"
    return "var"


def device_hierarchy(
    hh: HostHierarchy,
    params: HierarchyParams,
    fine_stencil=None,
    device=None,
):
    """The device Hierarchy of a host hierarchy on `device` (None: the CUDA
    device; raises without one)."""
    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.dtypes import resolve_device
    from amg_tpu_torch.setup.structured import VarStencilOperator

    device = resolve_device(device)
    with setup_span("device", sync=device):
        dtype = params.dtype
        convert = _format_converter(params)
        levels = []
        for k, hl in enumerate(hh.levels):
            if k == 0 and fine_stencil is not None and params.keep_stencil_fine:
                meta = {"offsets": tuple(tuple(o) for o in fine_stencil.offsets),
                        "grid_shape": tuple(fine_stencil.grid_shape)}
                if isinstance(fine_stencil, VarStencilOperator):
                    A = {"kind": dia_kind(device, dtype, fine_stencil.grid_shape),
                         "coeffs": fine_stencil.coeffs.detach().cpu().numpy(), **meta}
                else:
                    A = {"kind": "stencil",
                         "weights": fine_stencil.weights.detach().cpu().numpy(), **meta}
            else:
                A = convert(hl.A)
            lv = {"A": A, "transfer": None,
                  "sm": make_smoother_data(hl.A, params.smoother, w=hl.weight,
                                           block_size=params.block_size,
                                           jgs_weight=params.jgs_weight)}
            for name in DEVICE_TRANSFERS:
                lv[name] = convert(getattr(hl, name))
            levels.append(lv)
        coarse_Ainv = np.linalg.inv(hh.levels[-1].A.to_dense())
        hh.arrays = (levels, coarse_Ainv)
        return hierarchy_from_arrays(levels, coarse_Ainv, dtype=dtype, device=device)


def build_hierarchy(
    A: CSRMatrix,
    params: HierarchyParams = HierarchyParams(),
    fine_stencil=None,
    near_nullspace=None,
    device=None,
):
    """Full setup: (HostHierarchy, device Hierarchy) on `device` (None: the
    CUDA device; raises without one). params.setup_type selects the classical
    or the smoothed-aggregation host setup; `near_nullspace` feeds the SA
    candidates (e.g. Problem.near_nullspace)."""
    from amg_tpu_torch.dtypes import resolve_device

    device = resolve_device(device)
    if params.setup_type == "sa":
        from amg_tpu_torch.setup.aggregation import build_sa_host_hierarchy

        hh = build_sa_host_hierarchy(A, params, B=near_nullspace)
    elif params.setup_type == "classical":
        hh = build_host_hierarchy(A, params)
    else:
        raise ValueError(f"unknown setup_type {params.setup_type!r}")
    return hh, device_hierarchy(hh, params, fine_stencil, device)
