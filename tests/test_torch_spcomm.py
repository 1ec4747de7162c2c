"""The port's halo operators (amg_tpu_torch/parallel/spcomm.py) against the
JAX package's on the same padded CSR matrices, on the CPU in float64, over
an 8-shard mesh (the reference on its 8 virtual devices, the port in one
process).

  * the exchange pattern of HaloELL in ppermute and all_to_all mode and of
    HaloBSR: send_idx, ghost_map, offsets, perms, the remapped columns and
    values, the wire and payload counts and the comm bytes, exactly;
  * the halo spmv in every mode within 1e-14 of the reference's halo_spmv
    (relative to the largest entry);
  * the reference's operators carried across (convert.halo_from_arrays)
    equal the port's own builds; comm_trace logs one entry per matvec.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amg_tpu.parallel import make_row_mesh as r_mesh
from amg_tpu.parallel import spcomm as rsp
from amg_tpu.parallel.dist import _pad_csr as r_pad
from amg_tpu.problems import laplacian_2d_5pt, laplacian_3d_27pt
from amg_tpu.problems.elasticity import elasticity_beam
from amg_tpu.setup import hierarchy as rhi
from amg_tpu_torch.convert import halo_from_arrays
from amg_tpu_torch.parallel import make_row_mesh
from amg_tpu_torch.parallel import spcomm as psp
from amg_tpu_torch.parallel.dist import _pad_csr
from torch_parity import halo_arrays, halo_reference_layout, port_csr

torch.set_num_threads(1)

D = 8
TOL = 1e-14


def _padded(m, unit=D):
    rows, cols = -(-m.shape[0] // unit) * unit, -(-m.shape[1] // unit) * unit
    return r_pad(m, rows, cols, unit_diag_from=m.shape[0] if rows == cols else -1)


@pytest.fixture(scope="module")
def mats():
    """Padded host CSR matrices: a 27-point and a 5-point Laplacian, the
    27-point problem's first P and R (rectangular), an elasticity beam."""
    lv = rhi.build_host_hierarchy(laplacian_3d_27pt(10).A, rhi.HierarchyParams()).levels
    out = {
        "27pt12": _padded(laplacian_3d_27pt(12).A),
        "5pt20": _padded(laplacian_2d_5pt(20).A),
        "P0": _padded(lv[0].P),
        "R0": _padded(lv[0].R),
        "beam": _padded(elasticity_beam(16, 4, 4).A, unit=8 * D),
    }
    return out


@pytest.fixture(scope="module")
def meshes():
    return r_mesh(D), make_row_mesh(D, "cpu")


# the reference's default choice (a few offset classes ship one segment
# each, more go dense) and the dense mode forced
MODES = {"ppermute": None, "all_to_all": 0}


def _same_pattern(got, want):
    assert got.offsets == tuple(want.offsets)
    assert got.perms == tuple(want.perms)
    np.testing.assert_array_equal(got.send_idx.numpy(), np.asarray(want.send_idx))
    np.testing.assert_array_equal(got.ghost_map.numpy(), np.asarray(want.ghost_map))
    assert got.comm_bytes_per_matvec() == want.comm_bytes_per_matvec()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["27pt12", "5pt20", "P0", "R0", "beam"])
def test_halo_ell_pattern_equals_the_reference(mats, meshes, name, mode):
    m = mats[name]
    want = rsp.build_halo_ell(m, meshes[0], max_ppermute_offsets=MODES[mode])
    got = psp.build_halo_ell(port_csr(m), meshes[1], max_ppermute_offsets=MODES[mode])
    _same_pattern(got, want)
    if mode == "all_to_all":
        assert got.offsets == () and got.send_idx.shape[:2] == (D, D)
    elif name in ("27pt12", "5pt20"):
        assert got.offsets  # banded: a few offset classes
    np.testing.assert_array_equal(halo_reference_layout(got), np.asarray(want.cols))
    np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))
    assert (got.shape, got.n_loc, got.n_loc_c) == (tuple(want.shape), want.n_loc, want.n_loc_c)
    assert got.wire_send == tuple(want.wire_send)
    assert got.payload_send == tuple(want.payload_send)
    assert got.comm_payload_bytes_per_matvec() == want.comm_payload_bytes_per_matvec()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["27pt12", "5pt20", "P0", "R0", "beam"])
def test_halo_spmv_equals_the_reference(mats, meshes, name, mode):
    m = mats[name]
    x = np.random.default_rng(1).random(m.shape[1])
    want = np.asarray(rsp.build_halo_ell(m, meshes[0], max_ppermute_offsets=MODES[mode])
                      @ jnp.asarray(x))
    got = psp.build_halo_ell(port_csr(m), meshes[1], max_ppermute_offsets=MODES[mode]) \
        @ torch.from_numpy(x)
    assert got.shape == (m.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["27pt12", "beam"])
def test_halo_bsr_equals_the_reference(mats, meshes, name, mode):
    m = _padded(mats[name], unit=8 * D)
    want = rsp.build_halo_bsr(m, meshes[0], bm=8, bn=8, max_ppermute_offsets=MODES[mode])
    got = psp.build_halo_bsr(port_csr(m), meshes[1], bm=8, bn=8,
                             max_ppermute_offsets=MODES[mode])
    _same_pattern(got, want)
    block_cols, blocks = halo_reference_layout(got)
    np.testing.assert_array_equal(block_cols, np.asarray(want.block_cols))
    np.testing.assert_array_equal(blocks, np.asarray(want.blocks))
    x = np.random.default_rng(2).random(m.shape[1])
    w = np.asarray(want @ jnp.asarray(x))
    np.testing.assert_allclose((got @ torch.from_numpy(x)).numpy(), w, rtol=0,
                               atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("kind", ["halo_ell", "halo_bsr"])
def test_the_reference_operators_carry_across(mats, meshes, kind):
    m = mats["27pt12"]
    if kind == "halo_ell":
        want, own = rsp.build_halo_ell(m, meshes[0]), psp.build_halo_ell(port_csr(m), meshes[1])
    else:
        m = _padded(m, unit=8 * D)
        want = rsp.build_halo_bsr(m, meshes[0])
        own = psp.build_halo_bsr(port_csr(m), meshes[1])
    got = halo_from_arrays(halo_arrays(want), meshes[1])
    assert type(got) is type(own)
    _same_pattern(got, own)
    x = torch.from_numpy(np.random.default_rng(3).random(m.shape[1]))
    assert torch.equal(got @ x, own @ x)


def test_comm_trace_logs_every_halo_matvec(mats, meshes):
    mesh = meshes[1]
    a = psp.build_halo_ell(port_csr(mats["5pt20"]), mesh)
    x = torch.ones(a.shape[1], dtype=torch.float64)
    with psp.comm_trace(mesh) as log:
        a @ (a @ x)
    assert log == [a.comm_bytes_per_matvec()] * 2
    assert mesh.trace is None
    a @ x  # nothing logs outside a trace


def test_builders_refuse_a_shape_that_does_not_split(meshes):
    A = laplacian_2d_5pt(5).A  # 25 rows
    with pytest.raises(ValueError, match="divisible"):
        psp.build_halo_ell(port_csr(A), meshes[1])
    with pytest.raises(ValueError, match="D\\*bm"):
        psp.build_halo_bsr(port_csr(_padded(A)), meshes[1])


def test_pad_csr_equals_the_reference(mats):
    A = laplacian_2d_5pt(5).A
    for rows, cols, diag in ((32, 32, 25), (32, 40, -1)):
        want = r_pad(A, rows, cols, unit_diag_from=diag)
        got = _pad_csr(port_csr(A), rows, cols, unit_diag_from=diag)
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)))
        assert got.shape == tuple(want.shape)
