"""Device-side BSR (blocked-ELL) sparse matrix (counterpart of
amg_tpu/sparse/bsr.py).

Rows are grouped into bm-row blocks and columns into bn-wide blocks; every
row-block holds `kb` dense bm x bn tiles (block col 0, tile 0 where padded).
The spmv gathers one bn-segment of x per tile, then contracts each row
block's tiles with its segments. The port keeps the tiles of a row block
side by side, (nrb, bm, kb * bn), so that contraction is one batched
matrix-vector product (`torch.bmm`) with no copy of the tiles.

`choose_bsr_shape` keeps the reference's cost model, which is the TPU v5e's
(gather ns per index, HBM bytes per ns), so that "bsr_auto" picks the
reference's tile; the port's own format rule is in
`setup/hierarchy.py::_format_converter`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from amg_tpu_torch.dtypes import INDEX_DTYPE
from amg_tpu_torch.utils import tracing


@dataclass
class BSRMatrix:
    """block_cols: (nrb, kb) int32; tiles: (nrb, bm, kb * bn); shape: the
    true (n_rows, n_cols)."""

    block_cols: torch.Tensor
    tiles: torch.Tensor
    shape: tuple

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def shape_cols(self) -> int:
        return self.shape[1]

    @property
    def nrb(self) -> int:
        return self.block_cols.shape[0]

    @property
    def kb(self) -> int:
        return self.block_cols.shape[1]

    @property
    def bm(self) -> int:
        return self.tiles.shape[1]

    @property
    def bn(self) -> int:
        return self.tiles.shape[2] // self.kb

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return bsr_spmv(self, x)

    def __matmul__(self, x):
        return bsr_spmv(self, x)


def bsr_arrays(csr, bm: int = 8, bn: int = 8):
    """(block_cols (nrb, kb) int32, blocks (nrb, kb, bm, bn) float64) numpy
    arrays of the blocked-ELL form of a host CSRMatrix."""
    n, m = csr.shape
    nrb = -(-n // bm)
    ncb = -(-m // bn)
    if csr.nnz:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr).astype(np.int64))
        cols = csr.indices.astype(np.int64)
        rb = rows // bm
        cb = cols // bn
        key = rb * ncb + cb
        uk = np.unique(key)
        ub_rb = uk // ncb
        counts_per_rb = np.bincount(ub_rb, minlength=nrb)
        kb = max(int(counts_per_rb.max()), 1)
        # slot of each unique block within its row-block (uk is sorted, so
        # the blocks of one rb are contiguous)
        first = np.searchsorted(ub_rb, np.arange(nrb))
        slot_of_block = np.arange(len(uk)) - first[ub_rb]
        block_cols = np.zeros((nrb, kb), dtype=INDEX_DTYPE)
        block_cols[ub_rb, slot_of_block] = uk % ncb
        blocks = np.zeros((nrb, kb, bm, bn), dtype=np.float64)
        g = np.searchsorted(uk, key)  # global block id per nnz
        blocks[rb, slot_of_block[g], rows % bm, cols % bn] = csr.data
    else:
        block_cols = np.zeros((nrb, 1), dtype=INDEX_DTYPE)
        blocks = np.zeros((nrb, 1, bm, bn), dtype=np.float64)
    return block_cols, blocks


def bsr_from_csr(csr, bm: int = 8, bn: int = 8, dtype=torch.float64, device="cpu") -> BSRMatrix:
    """Convert a host CSRMatrix to blocked-ELL on `device`, tiling by bm x bn."""
    block_cols, blocks = bsr_arrays(csr, bm, bn)
    nrb, kb = block_cols.shape
    tiles = np.ascontiguousarray(blocks.transpose(0, 2, 1, 3)).reshape(nrb, bm, kb * bn)
    return BSRMatrix(
        block_cols=torch.from_numpy(block_cols).to(device),
        tiles=torch.from_numpy(tiles).to(device=device, dtype=dtype),
        shape=tuple(csr.shape),
    )


def bsr_fill_stats(csr, bm: int = 8, bn: int = 8) -> dict:
    """Storage diagnostics for the format choice: the zero fill bm x bn
    tiling introduces, and the gather-index counts of BSR and ELL."""
    n, m = csr.shape
    ncb = -(-m // bn)
    nrb = -(-n // bm)
    if csr.nnz == 0:
        return {"padded": nrb * bm * bn, "nnz": 0, "blowup": np.inf,
                "gathers_bsr": nrb, "gathers_ell": n}
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr).astype(np.int64))
    key = (rows // bm) * ncb + csr.indices.astype(np.int64) // bn
    uk = np.unique(key)
    counts = np.bincount(uk // ncb, minlength=nrb)
    kb = max(int(counts.max()), 1)
    padded = nrb * kb * bm * bn
    k_ell = max(int(np.diff(csr.indptr).max()), 1)
    return {
        "padded": padded,
        "nnz": csr.nnz,
        "blowup": padded / csr.nnz,
        "kb": kb,
        "gathers_bsr": nrb * kb,
        "gathers_ell": n * k_ell,
    }


# The reference's cost model, measured on a TPU v5e (tools/bench_formats.py
# there): ~2 ns per gather index in the blocked layout, ~7.3 ns per element
# in the scalar ELL layout, tile data at ~819 GB/s. Kept as it is so that
# "bsr_auto" picks the reference's tile; it says nothing about the H100.
_GATHER_NS_BSR = 2.0
_GATHER_NS_ELL = 7.3
_HBM_BYTES_PER_NS = 819.0


def choose_bsr_shape(
    csr,
    candidates=((8, 8), (16, 8), (8, 16), (16, 16), (8, 32)),
    itemsize: int = 4,
):
    """The (bm, bn) tile minimizing the modeled spmv cost: ((bm, bn),
    model_ns), or (None, ell_ns) when scalar ELL wins the model."""
    ell_ns = csr.n_rows * max(csr.max_row_nnz, 1) * _GATHER_NS_ELL
    best, best_ns = None, ell_ns
    for bm, bn in candidates:
        st = bsr_fill_stats(csr, bm=bm, bn=bn)
        ns = st["gathers_bsr"] * _GATHER_NS_BSR + st["padded"] * itemsize / _HBM_BYTES_PER_NS
        if ns < best_ns:
            best, best_ns = (bm, bn), ns
    return best, best_ns


def bsr_spmv(a: BSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: block gather, then one batched tile-by-segment product."""
    tracing.count("spmv.bsr")
    n, m = a.shape
    bn = a.bn
    ncb = -(-m // bn)
    xp = torch.nn.functional.pad(x, (0, ncb * bn - m)) if ncb * bn != m else x
    g = torch.index_select(xp.view(ncb, bn), 0, a.block_cols.reshape(-1))  # (nrb*kb, bn)
    y = torch.bmm(a.tiles, g.view(a.nrb, a.kb * bn, 1)).reshape(-1)
    return y[:n] if y.shape[0] != n else y
