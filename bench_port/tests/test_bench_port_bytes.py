"""The rooflines' byte counts against a hand count, and the peaks table."""

import numpy as np
import pytest
import scipy.sparse as sp

from bench_port import roofline


def test_stencil_bytes_hand_count():
    # 96^3 float64: x read once (884,736 x 8 B) and y written once
    assert roofline.stencil_bytes(884736, 8) == 884736 * 8 + 884736 * 8 == 14155776


def test_spmv_bytes_hand_count():
    # a 3 x 4 matrix with 5 nonzeros: 5 x (8 B value + 4 B index), x 4 x 8 B, y 3 x 8 B
    m = sp.csr_matrix(np.array([[1.0, 0, 2, 0], [0, 0, 0, 3], [4, 5, 0, 0]]))
    assert roofline.spmv_bytes(3, 4, m.nnz, 8, 4) == 5 * 12 + 32 + 24 == 116
    # the 96^3 level 1 of the classical hierarchy: 110,592 rows, 7,598,160 nonzeros
    assert roofline.spmv_bytes(110592, 110592, 7598160) == 7598160 * 12 + 2 * 110592 * 8


def test_share_against_the_peak():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.peak_bytes_per_s(kind) == 3.35e12
    # 3.35 GB moved in 2 ms is half of the bound's 1 ms
    assert roofline.share_percent(3_350_000_000, 2e-3, kind) == pytest.approx(50.0)
    assert roofline.share_percent(10, 1.0, "NVIDIA H100 PCIe") is None
    assert roofline.share_percent(10, 0.0, kind) is None
