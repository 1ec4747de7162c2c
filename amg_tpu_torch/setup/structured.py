"""Structured (geometric) multigrid hierarchy (counterpart of
amg_tpu/setup/structured.py).

  * coarsening: every other point per axis, (s+1)//2 coarse points;
  * P: separable trilinear interpolation, R = P^T (full weighting), applied
    per axis as a contraction with the 1-D transfer matrix;
  * A_c = R A P computed on the host (scipy, float64) and stored as a
    variable-coefficient stencil, or — `coarse_op="auto"` on levels with min
    side >= 32, or `"const"` — as the constant stencil of its interior row;
  * the coarsest level is a dense inverse.

`build_dia_structured_hierarchy` is the same construction for a variable-
coefficient operator with interleaved dofs on a structured node grid (the
identity-BC elasticity beam): every level is a DIA operator
(`csr_to_dia_stencil`) whose device form is `DiaKernelOperator` (kernel K5),
transfers are node-separable with an identity component axis, graded-end
coarsening on even axes, and Dirichlet masks (`MaskedTransfer`).

The host part builds float64 arrays; `amg_tpu_torch.convert` turns them into
the device `Hierarchy`, the same route that carries a reference hierarchy
across.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from amg_tpu_torch.dtypes import SETUP_DTYPE, resolve_device
from amg_tpu_torch.ops.var_stencil import (
    MAX_OFFSETS,
    halos_of,
    var_from_padded,
    var_stencil_kernel_padded,
    var_to_padded,
)
from amg_tpu_torch.setup.hierarchy import HostHierarchy, HostLevel
from amg_tpu_torch.setup.rap import estimate_rho_dinv_a
from amg_tpu_torch.smooth.smoothers import SmootherType, make_smoother_data
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.stencil import StencilOperator, stencil_to_csr, tap_sum
from amg_tpu_torch.utils import tracing
from amg_tpu_torch.utils.tracing import setup_span


@dataclass
class VarStencilOperator:
    """Variable-coefficient stencil: coeffs[t] is the grid-shaped array of
    coefficients for offset t.

        y[i] = sum_t coeffs[t][i] * x[i + offset_t]   (zero outside the grid)
    """

    coeffs: torch.Tensor  # (m, *grid_shape)
    offsets: Tuple[Tuple[int, ...], ...]
    grid_shape: Tuple[int, ...]

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.n_rows)

    def diagonal(self) -> torch.Tensor:
        for t, off in enumerate(self.offsets):
            if all(d == 0 for d in off):
                return self.coeffs[t].reshape(-1)
        return torch.zeros(self.n_rows, dtype=self.coeffs.dtype, device=self.coeffs.device)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        # the diagonals in list order, as K5 sums them: every DIA form (K5,
        # its plain version, this one, its plane halo) rounds alike
        tracing.count("spmv.var_stencil")
        return tap_sum(x.reshape(self.grid_shape), self.coeffs, self.offsets).reshape(x.shape)

    def __matmul__(self, x):
        return self.matvec(x)


@dataclass
class DiaKernelOperator:
    """Variable-coefficient (DIA) operator whose applications run through
    kernel K5 (`ops.var_stencil`): the coefficient planes of the interior
    grid, (m, Z, Y, X); a flat-vector matvec pads and unpads the operand
    around one launch. The device format of every level of
    `build_dia_structured_hierarchy`. On CPU tensors the same methods run
    K5's plain version."""

    coeffs: torch.Tensor  # (m, Z, Y, X) coefficient planes
    diag: torch.Tensor  # flat diagonal
    offsets: Tuple[Tuple[int, ...], ...]
    grid_shape: Tuple[int, ...]
    halos: Tuple[int, ...]
    # a narrow copy of the planes (with_sweep_dtype) that only the smoother's
    # sweeps stream; matvec and residual, against which convergence is
    # measured, keep the full-precision planes
    coeffs_sweep: Optional[torch.Tensor] = None

    @classmethod
    def from_var_stencil(cls, vs: VarStencilOperator) -> "DiaKernelOperator":
        if len(vs.grid_shape) != 3:
            raise ValueError(f"the DIA kernel takes 3-D grids, got {vs.grid_shape}")
        halos = halos_of(vs.offsets)
        return cls(
            coeffs=vs.coeffs.reshape((len(vs.offsets),) + tuple(vs.grid_shape)).contiguous(),
            diag=vs.diagonal().clone(),
            offsets=tuple(tuple(int(d) for d in o) for o in vs.offsets),
            grid_shape=tuple(vs.grid_shape),
            halos=halos,
        )

    @property
    def n_rows(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def shape(self) -> tuple:
        return (self.n_rows, self.n_rows)

    def diagonal(self) -> torch.Tensor:
        return self.diag

    def _to_kernel(self, x: torch.Tensor) -> torch.Tensor:
        return var_to_padded(x, self.grid_shape, self.halos)

    def _from_kernel(self, xp: torch.Tensor) -> torch.Tensor:
        return var_from_padded(xp, self.grid_shape, self.halos)

    def with_sweep_dtype(self, dtype) -> "DiaKernelOperator":
        """The operator whose fused_jacobi_sweeps streams the coefficient
        planes at `dtype` (torch.bfloat16: half the bytes of float32). The
        smoother is perturbed by O(2^-8) relative on each matrix entry;
        matvec and residual stay exact. None, or the planes' own dtype,
        drops any narrow copy (a true revert)."""
        if dtype is None or dtype == self.coeffs.dtype:
            return self if self.coeffs_sweep is None else replace(self, coeffs_sweep=None)
        return replace(self, coeffs_sweep=self.coeffs.to(dtype))

    def _apply(self, u_pad, b_pad=None, scale_pad=None, mode="spmv", coeffs=None):
        """One K5 application on padded operands, of the full-precision
        planes unless `coeffs` is given (the single place the operator
        reaches its kernel)."""
        tracing.count("spmv.dia")
        return var_stencil_kernel_padded(
            u_pad, self.coeffs if coeffs is None else coeffs, self.offsets, self.grid_shape,
            b_pad=b_pad, scale_pad=scale_pad, mode=mode,
        )

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return self._from_kernel(self._apply(self._to_kernel(x))).reshape(x.shape)

    def residual(self, u: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """r = b - A u in one launch (b streams beside the matvec)."""
        rp = self._apply(self._to_kernel(u), self._to_kernel(b), mode="residual")
        return self._from_kernel(rp).reshape(u.shape)

    def fused_jacobi_sweeps(self, u, f, inv_wscale, num_sweeps: int, zero_guess: bool = False):
        """num_sweeps (L1-)Jacobi sweeps u <- u + s (f - A u), s = inv_wscale:
        one pad/unpad pair around the chain and one K5 `sweep` launch per
        sweep; the kernel re-zeroes the shell every launch, so the chained
        iterates stay in the padded layout. With zero_guess the chain starts
        from u = 0 (u is not read). The sweeps stream `coeffs_sweep` when it
        is set."""
        n = self.n_rows
        bp = self._to_kernel(f)
        sp_ = self._to_kernel(
            torch.broadcast_to(torch.as_tensor(inv_wscale, dtype=f.dtype, device=f.device), (n,))
        )
        up = torch.zeros_like(bp) if zero_guess else self._to_kernel(u)
        for _ in range(int(num_sweeps)):
            up = self._apply(up, bp, sp_, mode="sweep", coeffs=self.coeffs_sweep)
        return self._from_kernel(up).reshape(f.shape)

    def __matmul__(self, x):
        return self.matvec(x)


@functools.lru_cache(maxsize=64)
def _axis_transfer_np(sf: int, sc: int) -> np.ndarray:
    """1-D linear-interpolation transfer matrix S (sf x sc): S[2c,c]=1,
    S[2c±1,c]=1/2 (clipped at the boundary). Restriction contracts the fine
    axis with S; prolongation contracts the coarse axis with S^T. Two more
    axis kinds: sf == sc is an untouched axis (the component axis of an
    interleaved vector field), the identity; sf == 2 sc - 2 is the graded-end
    coarsening of an even axis, coarse nodes on fine {0, 2, ..., sf-2, sf-1},
    whose last interval has length 1 so that every fine row still sums to 1
    (constants and rigid-body modes stay in range(P))."""
    if sf == sc:
        return np.eye(sf)
    if sf == 2 * sc - 2:
        S = np.zeros((sf, sc))
        c = np.arange(sc - 1)
        S[2 * c, c] = 1.0
        S[sf - 1, sc - 1] = 1.0
        odd = np.arange(1, sf - 1, 2)
        S[odd, odd // 2] = 0.5
        S[odd, odd // 2 + 1] = 0.5
        return S
    if sc != (sf + 1) // 2:
        raise ValueError(
            f"coarse side {sc} is neither (s+1)//2, s nor s/2+1 of fine side {sf}"
        )
    S = np.zeros((sf, sc))
    c = np.arange(sc)
    S[2 * c, c] = 1.0
    lo, hi = 2 * c - 1, 2 * c + 1
    m = lo >= 0
    S[lo[m], c[m]] = 0.5
    m = hi < sf
    S[hi[m], c[m]] = 0.5
    return S


def _transfer_axis(g: torch.Tensor, S: torch.Tensor, axis: int, to_coarse: bool):
    """Contract axis `axis` of g with the 1-D transfer matrix S (fine x
    coarse): with S to coarsen, with S^T to refine."""
    M = S if to_coarse else S.T
    return torch.movedim(torch.tensordot(g, M, dims=([axis], [0])), -1, axis)


def _axis_mats(fine_shape, coarse_shape, dtype, device):
    """Per-axis transfer matrices; None on an identity axis (skipped)."""
    return tuple(
        None if sf == sc
        else torch.as_tensor(_axis_transfer_np(sf, sc)).to(device=device, dtype=dtype)
        for sf, sc in zip(fine_shape, coarse_shape)
    )


@dataclass
class StructuredProlong:
    """Trilinear prolongation coarse -> fine, one axis at a time."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mats: Tuple[torch.Tensor, ...]  # per-axis (sf x sc) matrices, None: identity

    @classmethod
    def build(cls, fine_shape, coarse_shape, dtype, device):
        return cls(
            tuple(fine_shape), tuple(coarse_shape),
            _axis_mats(fine_shape, coarse_shape, dtype, device),
        )

    @property
    def shape(self):
        return (int(np.prod(self.fine_shape)), int(np.prod(self.coarse_shape)))

    def __matmul__(self, xc: torch.Tensor):
        tracing.count("spmv.transfer")
        g = xc.reshape(self.coarse_shape)
        for d in range(g.ndim):
            if self.mats[d] is not None:
                g = _transfer_axis(g, self.mats[d], d, to_coarse=False)
        return g.reshape(-1)


@dataclass
class StructuredRestrict:
    """Full-weighting restriction fine -> coarse: P^T, one axis at a time."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mats: Tuple[torch.Tensor, ...]

    @classmethod
    def build(cls, fine_shape, coarse_shape, dtype, device):
        return cls(
            tuple(fine_shape), tuple(coarse_shape),
            _axis_mats(fine_shape, coarse_shape, dtype, device),
        )

    @property
    def shape(self):
        return (int(np.prod(self.coarse_shape)), int(np.prod(self.fine_shape)))

    def __matmul__(self, rf: torch.Tensor):
        tracing.count("spmv.transfer")
        g = rf.reshape(self.fine_shape)
        for d in range(g.ndim):
            if self.mats[d] is not None:
                g = _transfer_axis(g, self.mats[d], d, to_coarse=True)
        return g.reshape(-1)


def _smoother_weight(A_csr: CSRMatrix, smoother) -> float:
    """Jacobi damping 1 / rho(D^-1 A), with the l1 row norms as D for the
    L1 smoothers."""
    scale = None
    if smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI):
        scale = A_csr.l1_row_norms()
    return 1.0 / max(estimate_rho_dinv_a(A_csr, scale=scale), 1e-12)


def _params_overrides(params):
    """What a HierarchyParams sets in the structured builders, as the
    reference's do: (dtype, smoother, smooth_weight, max_levels,
    max_coarse_size), the last at least 8."""
    return (params.dtype, params.smoother, params.smooth_weight, params.max_levels,
            max(params.max_coarse_size, 8))


def _smoother_kw(params) -> dict:
    """The block smoothers' block_size and jgs_weight: the params', else 128
    and "auto" (the divergence guard of hybrid JGS)."""
    if params is None:
        return {"block_size": 128, "jgs_weight": "auto"}
    return {"block_size": params.block_size, "jgs_weight": params.jgs_weight}


def _coarse_shape(shape):
    return tuple((s + 1) // 2 for s in shape)


@dataclass
class MaskedTransfer:
    """Transfer composed with Dirichlet masks: out_mask * (T @ (in_mask * x)).
    Decouples identity-BC (clamped) dofs from the coarse correction."""

    inner: object  # StructuredProlong | StructuredRestrict
    in_mask: torch.Tensor
    out_mask: torch.Tensor

    @property
    def shape(self):
        return self.inner.shape

    def __matmul__(self, x: torch.Tensor):
        return self.out_mask * (self.inner @ (self.in_mask * x))


def _identity_row_mask(As) -> np.ndarray:
    """Boolean mask of exact unit-diagonal-only rows (Dirichlet identity rows
    of the bc='identity' convention): a_ii == 1 and no off-diagonals."""
    As = As.tocsr()
    n = As.shape[0]
    nnz_row = np.diff(As.indptr)
    mask = np.zeros(n, dtype=bool)
    single = nnz_row == 1
    idx = As.indptr[:-1][single]
    mask[single] = (As.indices[idx] == np.flatnonzero(single)) & (As.data[idx] == 1.0)
    return mask


def _structured_P_csr(fine_shape, coarse_shape) -> CSRMatrix:
    """Assemble the trilinear P as host CSR (for RAP and validation)."""
    import scipy.sparse as sp

    for sf, sc in zip(fine_shape, coarse_shape):
        if sc not in ((sf + 1) // 2, sf) and not (sf % 2 == 0 and sc == sf // 2 + 1):
            raise ValueError(
                f"coarse side {sc} is neither (s+1)//2, s nor s/2+1 of fine side {sf}"
            )
    nd = len(fine_shape)
    nf = int(np.prod(fine_shape))
    nc = int(np.prod(coarse_shape))
    cid = np.arange(nc).reshape(coarse_shape)
    rows, cols, vals = [], [], []
    fidx = np.stack(
        np.meshgrid(*[np.arange(s) for s in fine_shape], indexing="ij"), axis=-1
    ).reshape(-1, nd)
    fid = np.arange(nf)
    # per axis: even f -> (f//2, weight 1); odd f -> ((f-1)/2, .5) and
    # ((f+1)/2, .5), the latter clipped past the last coarse point; an
    # untouched axis is the identity; a graded-end axis puts its last coarse
    # node on the last fine node
    per_axis = []
    for d in range(nd):
        f = fidx[:, d]
        sf, sc = fine_shape[d], coarse_shape[d]
        if sc == sf:
            per_axis.append([
                (f, np.ones(nf), np.ones(nf, dtype=bool)),
                (f, np.zeros(nf), np.zeros(nf, dtype=bool)),
            ])
        elif sf == 2 * sc - 2:
            last = f == sf - 1
            even = (f % 2 == 0) | last
            per_axis.append([
                (np.where(last, sc - 1, f // 2), np.where(even, 1.0, 0.5),
                 np.ones(nf, dtype=bool)),
                (f // 2 + 1, np.where(even, 0.0, 0.5), (~even) & (f // 2 + 1 <= sc - 1)),
            ])
        else:
            even = f % 2 == 0
            per_axis.append([
                (f // 2, np.where(even, 1.0, 0.5), np.ones(nf, dtype=bool)),
                ((f + 1) // 2, np.where(even, 0.0, 0.5),
                 (~even) & ((f + 1) // 2 < sc)),
            ])
    for combo in itertools.product(range(2), repeat=nd):
        w = np.ones(nf)
        cmulti = np.zeros((nf, nd), dtype=np.int64)
        valid = np.ones(nf, dtype=bool)
        for d in range(nd):
            ci, wd, vd = per_axis[d][combo[d]]
            w = w * wd
            cmulti[:, d] = ci
            valid &= vd
        valid &= w != 0.0
        if not valid.any():
            continue
        rows.append(fid[valid])
        cols.append(cid[tuple(cmulti[valid].T)])
        vals.append(w[valid])
    p = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nf, nc),
    )
    return CSRMatrix.from_scipy(p)


def _csr_to_var_stencil(A: CSRMatrix, grid_shape) -> VarStencilOperator:
    """Re-express a CSR operator on a structured grid as a float64 CPU
    variable stencil over the full ±1 box. Raises if any entry falls outside
    it."""
    nd = len(grid_shape)
    n = int(np.prod(grid_shape))
    if A.n_rows != n:
        raise ValueError(f"{A.n_rows} rows for a grid of {n} points")
    strides = np.array(
        [int(np.prod(grid_shape[d + 1:])) for d in range(nd)], dtype=np.int64
    )
    offsets = [o for o in itertools.product((-1, 0, 1), repeat=nd)]
    coeffs = np.zeros((len(offsets), n), dtype=SETUP_DTYPE)
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    rmulti = np.stack([(rows // strides[d]) % grid_shape[d] for d in range(nd)], axis=1)
    cmulti = np.stack([(cols // strides[d]) % grid_shape[d] for d in range(nd)], axis=1)
    delta = cmulti - rmulti
    if np.abs(delta).max() > 1:
        bad = np.abs(delta).max(axis=1) > 1
        raise ValueError(
            f"operator not ±1-stencil-closed: {bad.sum()} entries reach "
            f"distance {np.abs(delta).max()}"
        )
    # offsets enumerate (-1, 0, 1)^nd in product order: the tap index of a
    # delta is its base-3 number
    tidx = (delta + 1) @ (3 ** np.arange(nd - 1, -1, -1))
    coeffs[tidx, rows] = A.data
    return VarStencilOperator(
        coeffs=torch.from_numpy(coeffs.reshape((len(offsets),) + tuple(grid_shape))),
        offsets=tuple(offsets),
        grid_shape=tuple(grid_shape),
    )


def build_structured_hierarchy(
    fine: StencilOperator,
    params=None,
    max_levels: int = 25,
    max_coarse_size: int = 600,
    dtype=torch.float64,
    smoother=None,
    smooth_weight=None,
    coarse_op: str = "auto",  # auto | var (exact RAP) | const
    device=None,
):
    """Geometric hierarchy for a stencil problem: (HostHierarchy, Hierarchy).

    Level 0 keeps the constant StencilOperator; coarse levels carry the exact
    RAP as a VarStencilOperator, except that `coarse_op="const"` — and
    `"auto"` on levels with min side >= 32 — stores the RAP's interior row as
    a constant StencilOperator (the outermost cell layer is the only
    approximation, guarded below). The device hierarchy lives on `device`
    (None: the CUDA device; raises without one). A `HierarchyParams`
    `params` overrides the keywords (see `_params_overrides`); a given
    `smooth_weight` replaces every level's 1 / rho(S^-1 A)."""
    # convert.py imports this module's operator classes
    from amg_tpu_torch.convert import hierarchy_from_arrays

    device = resolve_device(device)
    if params is not None:
        dtype, smoother, smooth_weight, max_levels, max_coarse_size = _params_overrides(params)
    if smoother is None:
        smoother = SmootherType.L1_JACOBI
    sm_kw = _smoother_kw(params)

    tracing.begin_setup()
    hh = HostHierarchy(params=params)
    shapes = [tuple(fine.grid_shape)]
    A_csr = stencil_to_csr(fine)
    A_arr = {
        "kind": "stencil",
        "weights": fine.weights.detach().cpu().numpy().astype(np.float64),
        "offsets": tuple(tuple(o) for o in fine.offsets),
        "grid_shape": tuple(fine.grid_shape),
    }
    levels = []
    lvl = 0
    while True:
        shape = shapes[-1]
        hl = HostLevel(A=A_csr)
        if smooth_weight is not None:
            hl.weight = smooth_weight
        else:
            with setup_span("rho", lvl):
                hl.weight = _smoother_weight(A_csr, smoother)
        hh.levels.append(hl)
        sm = make_smoother_data(A_csr, smoother, w=hl.weight, **sm_kw)
        n = A_csr.n_rows
        if n <= max_coarse_size or lvl == max_levels - 1 or min(shape) < 5:
            levels.append({"A": A_arr, "sm": sm, "transfer": None})
            break
        cshape = _coarse_shape(shape)
        P_csr = _structured_P_csr(shape, cshape)
        R_csr = P_csr.transpose()
        hl.P, hl.R = P_csr, R_csr
        with setup_span("rap", lvl):
            acs = R_csr.matmul(A_csr).matmul(P_csr).to_scipy()
            # drop numerically-zero fill
            acs.data[np.abs(acs.data) < 1e-14 * np.abs(acs.data).max()] = 0.0
            acs.eliminate_zeros()
            Ac_csr = CSRMatrix.from_scipy(acs)
        levels.append(
            {"A": A_arr, "sm": sm,
             "transfer": {"fine_shape": shape, "coarse_shape": cshape}}
        )
        A_csr = Ac_csr
        var = _csr_to_var_stencil(Ac_csr, cshape)
        c = var.coeffs.numpy()
        A_arr = {"kind": "var", "coeffs": c, "offsets": var.offsets,
                 "grid_shape": cshape}
        # "auto" takes the constant form only where the coefficient stream
        # matters (min side >= 32); the boundary-shell approximation grows as
        # levels shrink
        if coarse_op == "const" or (coarse_op == "auto" and min(cshape) >= 32):
            center = tuple(s // 2 for s in cshape)
            w = c[(slice(None),) + center]
            # guard the constancy claim: everything off the outer shell must
            # match the center row ("auto" keeps the exact VarStencil,
            # "const" fails loudly)
            ok = True
            if min(cshape) >= 5:
                inner = c[(slice(None),) + tuple(slice(1, -1) for _ in cshape)]
                dev = np.abs(inner - w.reshape((-1,) + (1,) * len(cshape)))
                ok = bool(dev.max() <= 1e-10 * np.abs(w).max())
                if not ok and coarse_op == "const":
                    raise ValueError(
                        "RAP interior is not constant — coarse_op='const' "
                        "does not apply to this transfer pair"
                    )
            if ok:
                A_arr = {"kind": "stencil", "weights": w, "offsets": var.offsets,
                         "grid_shape": cshape}
        shapes.append(cshape)
        lvl += 1
    with setup_span("device", sync=device):
        coarse_Ainv = np.linalg.inv(hh.levels[-1].A.to_dense())
        hh.arrays = (levels, coarse_Ainv)
        return hh, hierarchy_from_arrays(levels, coarse_Ainv, dtype=dtype, device=device)


def _dia_arrays(A: CSRMatrix, grid_shape):
    """(coeffs (m, *grid_shape) float64, offsets) of a translation-structured
    CSR operator on a logical grid, with the offset set discovered from the
    matrix (generalized diagonals, any reach) in lexicographic order. m is
    at most what kernel K5 takes (`var_stencil.MAX_OFFSETS`)."""
    n = A.n_rows
    nd = len(grid_shape)
    if int(np.prod(grid_shape)) != n:
        raise ValueError(f"{n} rows for a grid of shape {tuple(grid_shape)}")
    strides = np.array(
        [int(np.prod(grid_shape[d + 1:])) for d in range(nd)], dtype=np.int64
    )
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices.astype(np.int64)
    rmulti = np.stack([(rows // strides[d]) % grid_shape[d] for d in range(nd)], axis=1)
    cmulti = np.stack([(cols // strides[d]) % grid_shape[d] for d in range(nd)], axis=1)
    delta = cmulti - rmulti
    # scalar-encode the offset tuples so the census is a 1-D unique; the
    # ascending code order is the lexicographic order of the tuples
    enc_base = np.asarray([2 * int(s) + 1 for s in grid_shape], dtype=np.int64)
    enc = np.zeros(delta.shape[0], dtype=np.int64)
    for d in range(nd):
        enc = enc * enc_base[d] + (delta[:, d] + int(grid_shape[d]))
    uniq_enc, tidx = np.unique(enc, return_inverse=True)
    if len(uniq_enc) > MAX_OFFSETS:
        raise ValueError(
            f"operator needs {len(uniq_enc)} generalized diagonals "
            f"(> {MAX_OFFSETS}): not translation-structured on {tuple(grid_shape)}"
        )
    uniq = np.zeros((len(uniq_enc), nd), dtype=np.int64)
    rem = uniq_enc.copy()
    for d in range(nd - 1, -1, -1):
        uniq[:, d] = rem % enc_base[d] - int(grid_shape[d])
        rem //= enc_base[d]
    coeffs = np.zeros((len(uniq), n), dtype=SETUP_DTYPE)
    coeffs[tidx.reshape(-1), rows] = A.data
    offsets = tuple(tuple(int(v) for v in o) for o in uniq)
    return coeffs.reshape((len(uniq),) + tuple(grid_shape)), offsets


def csr_to_dia_stencil(A: CSRMatrix, grid_shape, dtype=torch.float64) -> VarStencilOperator:
    """Re-express any translation-structured CSR operator on a logical grid
    as a CPU variable stencil with a discovered offset set (DIA form). An
    interleaved Q1 elasticity operator on an (nx+1, ny+1, nz+1) node grid
    with d dofs per node is such an operator on (nx+1, ny+1, d (nz+1)): 99
    diagonals for d = 3."""
    coeffs, offsets = _dia_arrays(A, grid_shape)
    return VarStencilOperator(
        coeffs=torch.from_numpy(coeffs).to(dtype), offsets=offsets,
        grid_shape=tuple(grid_shape),
    )


def _axis_pos(sf: int, sc: int) -> np.ndarray:
    """Fine position of each coarse node along one axis: c itself on an
    identity axis, {0, 2, ..., sf-2, sf-1} on a graded-end axis, 2c else."""
    if sf == sc:
        return np.arange(sf)
    if sf == 2 * sc - 2:
        return np.append(np.arange(0, sf - 1, 2), sf - 1)
    return 2 * np.arange(sc)


def build_dia_structured_hierarchy(
    A: CSRMatrix,
    node_shape: Tuple[int, ...],
    num_functions: int = 1,
    params=None,
    max_levels: int = 25,
    max_coarse_size: int = 600,
    dtype=torch.float64,
    smoother=None,
    smooth_weight=None,
    device=None,
    sweep_coef_dtype=None,
    use_kernel: bool = True,
):
    """Geometric hierarchy for a variable-coefficient operator on a structured
    node grid with `num_functions` interleaved dofs per node (the identity-BC
    elasticity beam): (HostHierarchy, Hierarchy).

    Every level's operator is a DIA `DiaKernelOperator` (kernel K5 on CUDA,
    its plain version on CPU tensors); transfers are node-wise separable
    (tri)linear interpolation times the identity on the component axis,
    with Dirichlet masks where the operator has identity rows. On such grids
    odd axes coarsen vertex-centered and even axes with the graded-end
    transfer (constants stay in range(P), or the rigid-body modes escape it
    and the V-cycle rate goes to ~1); P's rows of clamped fine dofs and
    columns of clamped coarse dofs are zeroed and the clamped coarse diagonal
    is pinned back to 1. The device hierarchy lives on `device` (None: the
    CUDA device; raises without one). With `sweep_coef_dtype` (e.g.
    torch.bfloat16) every level's smoother sweeps stream their coefficient
    planes at that dtype (`DiaKernelOperator.with_sweep_dtype`). A
    `HierarchyParams` `params` overrides the keywords and gives the block
    smoothers their block_size and jgs_weight (`_params_overrides`); a given
    `smooth_weight` replaces every level's 1 / rho(S^-1 A). use_kernel=False
    keeps every level the plain VarStencilOperator (no K5), as the
    reference's multi-device runs keep its XLA form."""
    import scipy.sparse as sp

    from amg_tpu_torch.convert import hierarchy_from_arrays

    device = resolve_device(device)
    if params is not None:
        dtype, smoother, smooth_weight, max_levels, max_coarse_size = _params_overrides(params)
    if smoother is None:
        smoother = SmootherType.L1_JACOBI
    sm_kw = _smoother_kw(params)
    d = max(num_functions, 1)

    def dia_shape(ns):
        return tuple(ns[:-1]) + (ns[-1] * d,)

    tracing.begin_setup()
    hh = HostHierarchy(params=params)
    node_shapes = [tuple(node_shape)]
    A_csr = A
    levels = []
    lvl = 0
    while True:
        ns = node_shapes[-1]
        coeffs, offsets = _dia_arrays(A_csr, dia_shape(ns))
        A_arr = {"kind": "dia" if use_kernel else "var", "coeffs": coeffs, "offsets": offsets,
                 "grid_shape": dia_shape(ns)}
        hl = HostLevel(A=A_csr)
        if smooth_weight is not None:
            hl.weight = smooth_weight
        else:
            with setup_span("rho", lvl):
                hl.weight = _smoother_weight(A_csr, smoother)
        hh.levels.append(hl)
        sm = make_smoother_data(A_csr, smoother, w=hl.weight, **sm_kw)
        n = A_csr.n_rows
        mask_f = _identity_row_mask(A_csr.to_scipy())
        if mask_f.any():
            cns_try = tuple((s + 1) // 2 if s % 2 == 1 else s // 2 + 1 for s in ns)
        else:
            cns_try = _coarse_shape(ns)
        if n <= max_coarse_size or lvl == max_levels - 1 or min(ns) < 5 or cns_try == ns:
            levels.append({"A": A_arr, "sm": sm, "transfer": None})
            break
        cns = cns_try
        Ps = _structured_P_csr(ns, cns).to_scipy()
        if d > 1:
            Ps = sp.kron(Ps, sp.eye(d), format="csr")
        transfer = {"fine_shape": ns + (d,), "coarse_shape": cns + (d,)}
        if mask_f.any():
            # a coarse node sits on the fine node of its 1-D positions and
            # inherits that dof's Dirichlet status
            pos = [_axis_pos(ns[ax], cns[ax]) for ax in range(len(ns))]
            pos.append(np.arange(d))
            mask_c = mask_f.reshape(ns + (d,))[np.ix_(*pos)].reshape(-1)
            keep_f = sp.diags((~mask_f).astype(np.float64))
            keep_c = sp.diags((~mask_c).astype(np.float64))
            Ps = (keep_f @ Ps @ keep_c).tocsr()
            Ps.eliminate_zeros()
            transfer["fine_mask"] = (~mask_f).astype(np.float64)
            transfer["coarse_mask"] = (~mask_c).astype(np.float64)
        P_csr = CSRMatrix.from_scipy(Ps.tocsr())
        hl.P, hl.R = P_csr, P_csr.transpose()
        with setup_span("rap", lvl):
            Ac = (Ps.T @ A_csr.to_scipy() @ Ps).tocsr()
            Ac.data[np.abs(Ac.data) < 1e-14 * np.abs(Ac.data).max()] = 0.0
            Ac.eliminate_zeros()
            if mask_f.any() and mask_c.any():
                Ac = (Ac + sp.diags(mask_c.astype(np.float64))).tocsr()
        levels.append({"A": A_arr, "sm": sm, "transfer": transfer})
        A_csr = CSRMatrix.from_scipy(Ac)
        node_shapes.append(cns)
        lvl += 1
    with setup_span("device", sync=device):
        coarse_Ainv = np.linalg.inv(hh.levels[-1].A.to_dense())
        hh.arrays = (levels, coarse_Ainv)
        hier = hierarchy_from_arrays(levels, coarse_Ainv, dtype=dtype, device=device)
    if sweep_coef_dtype is not None:
        if not use_kernel:
            raise ValueError("sweep_coef_dtype narrows K5's sweep planes: it needs use_kernel")
        hier = hier._replace(levels=tuple(
            lv._replace(A=lv.A.with_sweep_dtype(sweep_coef_dtype)) for lv in hier.levels))
    return hh, hier
