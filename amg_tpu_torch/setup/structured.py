"""Structured (geometric) multigrid hierarchy (counterpart of
amg_tpu/setup/structured.py).

  * coarsening: every other point per axis, (s+1)//2 coarse points;
  * P: separable trilinear interpolation, R = P^T (full weighting), applied
    per axis as a contraction with the 1-D transfer matrix;
  * A_c = R A P computed on the host (scipy, float64) and stored as a
    variable-coefficient stencil, or — `coarse_op="auto"` on levels with min
    side >= 32, or `"const"` — as the constant stencil of its interior row;
  * the coarsest level is a dense inverse.

The host part builds float64 arrays; `amg_tpu_torch.convert` turns them into
the device `Hierarchy`, the same route that carries a reference hierarchy
across.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from amg_tpu_torch.dtypes import SETUP_DTYPE, resolve_device
from amg_tpu_torch.setup.hierarchy import HostHierarchy, HostLevel
from amg_tpu_torch.setup.rap import estimate_rho_dinv_a
from amg_tpu_torch.smooth.smoothers import SmootherType, make_smoother_data
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.stencil import StencilOperator, stencil_to_csr


def _shifted_stack(grid: torch.Tensor, offsets) -> torch.Tensor:
    """(m, *grid.shape) stack of grid shifted by each offset, zero outside
    (the Dirichlet truncation): one pad and one stack instead of m passes."""
    nd = grid.ndim
    reach = [max(abs(o[d]) for o in offsets) for d in range(nd)]
    pad = []
    for d in reversed(range(nd)):
        pad += [reach[d], reach[d]]
    padded = F.pad(grid, pad)
    return torch.stack(
        [
            padded[
                tuple(
                    slice(reach[d] + o[d], reach[d] + o[d] + grid.shape[d])
                    for d in range(nd)
                )
            ]
            for o in offsets
        ]
    )


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
        shifted = _shifted_stack(x.reshape(self.grid_shape), self.offsets)
        return (self.coeffs * shifted).sum(0).reshape(x.shape)

    def __matmul__(self, x):
        return self.matvec(x)


@functools.lru_cache(maxsize=64)
def _axis_transfer_np(sf: int, sc: int) -> np.ndarray:
    """1-D linear-interpolation transfer matrix S (sf x sc): S[2c,c]=1,
    S[2c±1,c]=1/2 (clipped at the boundary). Restriction contracts the fine
    axis with S; prolongation contracts the coarse axis with S^T. Only the
    standard (s+1)//2 coarsening is ported (the reference's identity and
    graded-end axes belong to the DIA slice)."""
    if sc != (sf + 1) // 2:
        raise ValueError(f"coarse side {sc} is not (s+1)//2 of fine side {sf}")
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
    return tuple(
        torch.as_tensor(_axis_transfer_np(sf, sc)).to(device=device, dtype=dtype)
        for sf, sc in zip(fine_shape, coarse_shape)
    )


@dataclass
class StructuredProlong:
    """Trilinear prolongation coarse -> fine, one axis at a time."""

    fine_shape: Tuple[int, ...]
    coarse_shape: Tuple[int, ...]
    mats: Tuple[torch.Tensor, ...]  # per-axis (sf x sc) transfer matrices

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
        g = xc.reshape(self.coarse_shape)
        for d in range(g.ndim):
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
        g = rf.reshape(self.fine_shape)
        for d in range(g.ndim):
            g = _transfer_axis(g, self.mats[d], d, to_coarse=True)
        return g.reshape(-1)


def _coarse_shape(shape):
    return tuple((s + 1) // 2 for s in shape)


def _structured_P_csr(fine_shape, coarse_shape) -> CSRMatrix:
    """Assemble the trilinear P as host CSR (for RAP and validation)."""
    import scipy.sparse as sp

    for sf, sc in zip(fine_shape, coarse_shape):
        if sc != (sf + 1) // 2:
            raise ValueError(f"coarse side {sc} is not (s+1)//2 of fine side {sf}")
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
    # ((f+1)/2, .5), the latter clipped past the last coarse point
    per_axis = []
    for d in range(nd):
        f = fidx[:, d]
        even = f % 2 == 0
        per_axis.append([
            (f // 2, np.where(even, 1.0, 0.5), np.ones(nf, dtype=bool)),
            ((f + 1) // 2, np.where(even, 0.0, 0.5),
             (~even) & ((f + 1) // 2 < coarse_shape[d])),
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
    (None: the CUDA device; raises without one)."""
    # convert.py imports this module's operator classes
    from amg_tpu_torch.convert import hierarchy_from_arrays

    device = resolve_device(device)
    if smoother is None:
        smoother = SmootherType.L1_JACOBI

    hh = HostHierarchy()
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
            scale = None
            if smoother in (SmootherType.L1_JACOBI, SmootherType.SYM_L1_JACOBI):
                scale = A_csr.l1_row_norms()
            hl.weight = 1.0 / max(estimate_rho_dinv_a(A_csr, scale=scale), 1e-12)
        hh.levels.append(hl)
        sm = make_smoother_data(A_csr, smoother, w=hl.weight)
        n = A_csr.n_rows
        if n <= max_coarse_size or lvl == max_levels - 1 or min(shape) < 5:
            levels.append({"A": A_arr, "sm": sm, "transfer": None})
            break
        cshape = _coarse_shape(shape)
        P_csr = _structured_P_csr(shape, cshape)
        R_csr = P_csr.transpose()
        hl.P, hl.R = P_csr, R_csr
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
    coarse_Ainv = np.linalg.inv(hh.levels[-1].A.to_dense())
    hh.arrays = (levels, coarse_Ainv)
    return hh, hierarchy_from_arrays(levels, coarse_Ainv, dtype=dtype, device=device)
