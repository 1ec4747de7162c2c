"""The port's ELL and BSR formats and its device hierarchy against the JAX
package's, on the CPU in float64.

The host arrays of both formats must be identical (ELL cols/vals, BSR block
columns and tiles), both spmvs must agree with the reference's to 1e-13
relative to the largest entry of the result, `choose_bsr_shape` must pick
the reference's tile, and `device_hierarchy` must put the same matrices on
each level: the reference chooses ELL on the CPU, so both sides are built
with device_format="ell", then with "bsr_auto" (the reference's accelerator
default; its fixed-tile "bsr" is not ported, and the port refuses it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.problems import laplacian_3d_27pt
from amg_tpu.problems.elasticity import elasticity_beam
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.sparse import bsr as rbsr
from amg_tpu.sparse import ell as rell
from amg_tpu_torch.ops.vector import residual
from amg_tpu_torch.setup import hierarchy as phi
from amg_tpu_torch.sparse import bsr as pbsr
from amg_tpu_torch.sparse import ell as pell
from amg_tpu_torch.sparse.csr import CSRMatrix
from torch_parity import GENERIC_MATRICES as GENERIC
from torch_parity import (bsr_blocks, export_jax_hierarchy, launches, level_sizes,
                          port_host_hierarchy)

torch.set_num_threads(1)

TOL = 1e-13


def port_csr(m) -> CSRMatrix:
    return CSRMatrix(indptr=np.asarray(m.indptr), indices=np.asarray(m.indices),
                     data=np.asarray(m.data), shape=tuple(m.shape))


@pytest.fixture(scope="module")
def mats():
    """Of a 27-point 14^3 classical host hierarchy of the reference: square
    coarse operators, a rectangular P and R, a smoothed transfer; and an
    elasticity beam operator."""
    lv = rhi.build_host_hierarchy(laplacian_3d_27pt(14).A, rhi.HierarchyParams()).levels
    return {"A1": lv[1].A, "A2": lv[2].A, "P0": lv[0].P, "R0": lv[0].R,
            "P_s1": lv[1].P_s, "beam": elasticity_beam(16, 4, 4).A}


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", ["A1", "A2", "P0", "R0", "P_s1", "beam"])
def test_ell_matches(mats, name):
    m = mats[name]
    cols, vals = pell.ell_arrays(port_csr(m))
    want = rell.ell_from_csr(m)
    np.testing.assert_array_equal(cols, np.asarray(want.cols))
    np.testing.assert_array_equal(vals, np.asarray(want.vals))
    x = np.random.default_rng(1).random(m.shape[1])
    before = launches("spmv.ell", "ell_spmv.launches")
    got = pell.ell_from_csr(port_csr(m)) @ torch.from_numpy(x)
    # on the CPU the product is the plain version: one spmv.ell, no launch
    assert launches("spmv.ell", "ell_spmv.launches") == (before[0] + 1, before[1])
    assert got.shape == (m.shape[0],)
    assert _rel(got, rell.ell_spmv(want, jnp.asarray(x))) <= TOL
    r = residual(pell.ell_from_csr(port_csr(m)), torch.from_numpy(x), got)
    assert float(r.abs().max()) == 0.0


@pytest.mark.parametrize("tile", [(8, 8), (16, 8), (8, 32), (3, 5)])
@pytest.mark.parametrize("name", ["A1", "P0", "R0", "beam"])
def test_bsr_matches(mats, name, tile):
    m = mats[name]
    bm, bn = tile
    want = rbsr.bsr_from_csr(m, bm=bm, bn=bn)
    got = pbsr.bsr_from_csr(port_csr(m), bm=bm, bn=bn)
    np.testing.assert_array_equal(got.block_cols.numpy(), np.asarray(want.block_cols))
    np.testing.assert_array_equal(bsr_blocks(got).numpy(), np.asarray(want.blocks))
    assert (got.bm, got.bn, got.kb, got.nrb) == (want.bm, want.bn, want.kb, want.nrb)
    x = np.random.default_rng(2).random(m.shape[1])
    y = got @ torch.from_numpy(x)
    assert y.shape == (m.shape[0],)
    assert _rel(y, rbsr.bsr_spmv(want, jnp.asarray(x))) <= TOL


@pytest.mark.parametrize("name", ["A1", "A2", "P0", "R0", "P_s1", "beam"])
def test_choose_bsr_shape_and_fill_stats_match(mats, name):
    m = mats[name]
    assert pbsr.choose_bsr_shape(port_csr(m)) == rbsr.choose_bsr_shape(m)
    for tile in ((8, 8), (16, 16)):
        assert pbsr.bsr_fill_stats(port_csr(m), *tile) == rbsr.bsr_fill_stats(m, *tile)


def _same_matrix(got, want):
    if isinstance(want, rell.ELLMatrix):
        assert isinstance(got, pell.ELLMatrix) and got.shape_cols == want.shape_cols
        np.testing.assert_array_equal(got.cols.numpy(), np.asarray(want.cols))
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    else:
        assert isinstance(want, rbsr.BSRMatrix) and isinstance(got, pbsr.BSRMatrix)
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.block_cols.numpy(), np.asarray(want.block_cols))
        np.testing.assert_array_equal(bsr_blocks(got).numpy(), np.asarray(want.blocks))


@pytest.mark.parametrize("fmt", ["ell", "bsr_auto"])
def test_device_hierarchy_puts_the_same_matrices_on_each_level(fmt):
    """Both packages' device_hierarchy on one host hierarchy (the
    reference's, carried across: the formats, not the coarsening, are under
    test here; test_torch_amg_setup holds the coarsening), the stencil kept
    on level 0, in one format; and the reference's hierarchy carried across
    by tests/torch_parity.py equals the port's own."""
    prob = laplacian_3d_27pt(12)
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt as p27

    pprob = p27(12)
    hh_r, want = rhi.build_hierarchy(prob.A, rhi.HierarchyParams(device_format=fmt),
                                     fine_stencil=prob.stencil)
    hh_p = port_host_hierarchy(hh_r)
    got = phi.device_hierarchy(hh_p, phi.HierarchyParams(device_format=fmt),
                               fine_stencil=pprob.stencil, device="cpu")
    assert got.num_levels == want.num_levels and level_sizes(got) == want.level_sizes()
    for k, (g, w) in enumerate(zip(got.levels, want.levels)):
        if k == 0:
            np.testing.assert_array_equal(g.A.weights.numpy(), np.asarray(w.A.weights))
        else:
            _same_matrix(g.A, w.A)
        for name in GENERIC:
            if getattr(w, name) is None:
                assert getattr(g, name) is None
            else:
                _same_matrix(getattr(g, name), getattr(w, name))
        np.testing.assert_array_equal(g.sm.inv_wscale.numpy(), np.asarray(w.sm.inv_wscale))
    np.testing.assert_allclose(got.coarse_Ainv.numpy(), np.asarray(want.coarse_Ainv),
                               rtol=0, atol=1e-14 * float(np.abs(want.coarse_Ainv).max()))
    # the exporter's arrays are the port builder's own
    levels, _ = export_jax_hierarchy(want, host=hh_r)
    for lv_x, lv_p in zip(levels[1:], hh_p.arrays[0][1:]):
        assert lv_x["A"]["kind"] == lv_p["A"]["kind"]
        np.testing.assert_array_equal(lv_x["A"]["data"], lv_p["A"]["data"])


def test_dia_fine_operator_takes_k5_only_on_the_card_below_float64():
    """The reference's DIA branch (a VarStencilOperator fine operator): K5's
    DiaKernelOperator on an accelerator in a dtype other than float64, the
    plain VarStencilOperator otherwise."""
    from amg_tpu_torch.problems.elasticity import elasticity_beam as pbeam
    from amg_tpu_torch.setup.structured import VarStencilOperator, csr_to_dia_stencil

    cuda = torch.device("cuda", 0)
    assert phi.dia_kind(cuda, torch.float32, (4, 5, 6)) == "dia"
    assert phi.dia_kind(cuda, torch.float64, (4, 5, 6)) == "var"
    assert phi.dia_kind(cuda, torch.float32, (4, 5)) == "var"
    assert phi.dia_kind(torch.device("cpu"), torch.float32, (4, 5, 6)) == "var"
    prob = pbeam(8, 3, 3, bc="identity")
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape)
    hh, hier = phi.build_hierarchy(prob.A, phi.HierarchyParams(num_functions=3),
                                   fine_stencil=vs, device="cpu")
    assert isinstance(hier.levels[0].A, VarStencilOperator)
    assert hh.arrays[0][0]["A"]["kind"] == "var"
    x = torch.from_numpy(np.random.default_rng(3).random(prob.n))
    y = hier.levels[0].A @ x
    want = prob.A @ x.numpy()
    assert float(np.abs(y.numpy() - want).max()) <= TOL * float(np.abs(want).max())


@pytest.mark.parametrize("fmt", ["bsr", "csr"])
def test_device_hierarchy_refuses_an_unported_format(fmt):
    """The reference's fixed-tile "bsr" (and any unknown name) raises rather
    than falling back to another format."""
    prob = laplacian_3d_27pt(6)
    hh = phi.build_host_hierarchy(port_csr(prob.A), phi.HierarchyParams())
    with pytest.raises(ValueError, match="device_format"):
        phi.device_hierarchy(hh, phi.HierarchyParams(device_format=fmt), device="cpu")
