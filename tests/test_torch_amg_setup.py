"""The port's classical AMG setup against the JAX package's, on the CPU.

The port's copy of the native setup library (`amg_tpu_torch/native/
amg_setup.cpp`, built by `amg_tpu_torch.native_backend` with the reference's
compiler and flags) must equal the reference's library bit for bit; strength
graphs and C/F splits must be identical on both routes (the native default,
and the numpy one that AMG_TPU_NATIVE=0 with a numpy coarsening selects);
interpolation, Galerkin products, smoothed transfers and whole host
hierarchies must have identical sparsity and values within 1e-14 (relative
to the largest entry). The reference's library must load: its `"hmis"`
would otherwise fall back to numpy silently, and a different hierarchy
would pass for a fault of the port.
"""

import numpy as np
import pytest
import torch

from amg_tpu import native_backend as rnb
from amg_tpu.problems import laplacian_2d_5pt, laplacian_3d_27pt
from amg_tpu.problems.elasticity import elasticity_beam
from amg_tpu.setup import coarsen as rco
from amg_tpu.setup import hierarchy as rhi
from amg_tpu.setup import interp as rin
from amg_tpu.setup import rap as rrap
from amg_tpu.setup.strength import strength_graph as r_strength
from amg_tpu.smooth import SmootherType as RSm
from amg_tpu_torch import native_backend as pnb
from amg_tpu_torch.setup import coarsen as pco
from amg_tpu_torch.setup import hierarchy as phi
from amg_tpu_torch.setup import interp as pin
from amg_tpu_torch.setup import rap as prap
from amg_tpu_torch.setup.strength import strength_graph as p_strength
from amg_tpu_torch.smooth.smoothers import SmootherType as PSm
from amg_tpu_torch.sparse.csr import CSRMatrix
from torch_parity import reference_native

torch.set_num_threads(1)

TOL = 1e-14
PROBLEMS = {
    "5pt32": lambda: laplacian_2d_5pt(32),
    "27pt12": lambda: laplacian_3d_27pt(12),
    "27pt16": lambda: laplacian_3d_27pt(16),
    "beam2d": lambda: elasticity_beam(24, 6, 0),  # 2 interleaved functions
    "beam3d": lambda: elasticity_beam(8, 3, 3),  # 3
}


@pytest.fixture(scope="module", autouse=True)
def reference_library():
    # loads the JAX package's library, building it again where its first
    # build raced (ROADMAP F11); asserts that it loaded
    reference_native()


def port_csr(m) -> CSRMatrix:
    return CSRMatrix(indptr=np.asarray(m.indptr), indices=np.asarray(m.indices),
                     data=np.asarray(m.data), shape=tuple(m.shape))


def assert_same_csr(got, want, exact=False):
    """Identical shape and sparsity; values within TOL of the largest entry
    (or bit for bit)."""
    g, w = got.to_scipy().tocsr(), want.to_scipy().tocsr()
    g.sort_indices()
    w.sort_indices()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g.indptr, w.indptr)
    np.testing.assert_array_equal(g.indices, w.indices)
    if exact:
        np.testing.assert_array_equal(g.data, w.data)
    else:
        scale = max(float(np.abs(w.data).max()), 1e-300) if w.nnz else 1.0
        assert float(np.abs(g.data - w.data).max(initial=0.0)) <= TOL * scale


def _split(problem):
    prob = PROBLEMS[problem]()
    S = r_strength(prob.A)
    cf = rco.hmis_native(S)
    return prob, S, cf


@pytest.mark.parametrize("problem", ["5pt32", "27pt12", "27pt16"])
@pytest.mark.parametrize("op", ["spgemm", "transpose", "pmis", "hmis", "direct", "ext+i"])
def test_native_copy_equals_the_reference_library(problem, op):
    """Every entry of the port's library returns the reference library's
    arrays bit for bit."""
    prob, S, cf = _split(problem)
    A = prob.A
    if op == "spgemm":
        P = rin.extended_i_interpolation(A, S, cf)
        args = (A.indptr, A.indices, A.data, P.indptr, P.indices, P.data, A.shape, P.shape)
        got, want = pnb.spgemm(*args), rnb.spgemm(*args)
    elif op == "transpose":
        P = rin.extended_i_interpolation(A, S, cf)
        got = pnb.transpose(P.indptr, P.indices, P.data, P.shape)
        want = rnb.transpose(P.indptr, P.indices, P.data, P.shape)
    elif op in ("pmis", "hmis"):
        got = getattr(pnb, op)(S.indptr, S.indices, S.shape[0], 3)
        want = getattr(rnb, op)(S.indptr, S.indices, S.shape[0], 3)
        got, want = (got,), (want,)
    else:
        cmap = rin._coarse_map(cf).astype(np.int32)
        args = (op, A.indptr, A.indices, A.data, S.indptr, S.indices,
                (cf == rco.C_PT).astype(np.int8), cmap, A.n_rows, int(cf.sum()))
        got, want = pnb.interpolation(*args), rnb.interpolation(*args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


ROUTES = {
    # key: (port COARSENING key, AMG_TPU_NATIVE)
    "hmis": ("hmis", "1"),
    "pmis_native": ("pmis_native", "1"),
    "pmis": ("pmis", "0"),
    "hmis_py": ("hmis_py", "0"),
    "hmis_exact": ("hmis_exact", "0"),
}


@pytest.mark.parametrize("problem", ["5pt32", "27pt12"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_strength_and_splits_are_identical(monkeypatch, problem, route):
    key, native = ROUTES[route]
    monkeypatch.setenv("AMG_TPU_NATIVE", native)
    prob = PROBLEMS[problem]()
    S_r = r_strength(prob.A, 0.25)
    S_p = p_strength(port_csr(prob.A), 0.25)
    assert (S_r != S_p).nnz == 0 and S_r.nnz == S_p.nnz
    np.testing.assert_array_equal(pco.COARSENING[key](S_p, seed=0),
                                  rco.COARSENING[key](S_r, seed=0))


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("kind", ["direct", "ext+i", "ext+i truncated"])
def test_interpolation_matches(monkeypatch, kind, native):
    monkeypatch.setenv("AMG_TPU_NATIVE", native)
    prob, S, cf = _split("27pt12")
    fn_r = rin.direct_interpolation if kind == "direct" else rin.extended_i_interpolation
    fn_p = pin.direct_interpolation if kind == "direct" else pin.extended_i_interpolation
    want = fn_r(prob.A, S, cf)
    got = fn_p(port_csr(prob.A), S, cf)
    if kind.endswith("truncated"):
        want = rin.truncate_interpolation(want, 0.1, 4)
        got = pin.truncate_interpolation(got, 0.1, 4)
    assert_same_csr(got, want)


@pytest.mark.parametrize("native", ["1", "0"])
def test_galerkin_product_and_smoothed_transfers_match(monkeypatch, native):
    monkeypatch.setenv("AMG_TPU_NATIVE", native)
    prob, S, cf = _split("27pt12")
    P = rin.truncate_interpolation(rin.extended_i_interpolation(prob.A, S, cf), 0.0, 4)
    Pp, Ap = port_csr(P), port_csr(prob.A)
    assert_same_csr(Pp.transpose(), P.transpose(), exact=True)
    assert_same_csr(prap.galerkin_product(Pp.transpose(), Ap, Pp),
                    rrap.galerkin_product(P.transpose(), prob.A, P))
    scale = prob.A.l1_row_norms()
    for got, want in zip(prap.smoothed_transfer(Ap, Pp, scale, 0.7),
                         rrap.smoothed_transfer(prob.A, P, scale, 0.7)):
        assert_same_csr(got, want)


HOST_CASES = {
    # name: (problem, params, AMG_TPU_NATIVE)
    "default 27pt": ("27pt12", {}, "1"),
    "default 5pt": ("5pt32", {}, "1"),
    "agg_num_levels=1": ("27pt16", {"agg_num_levels": 1}, "1"),
    "num_functions=2": ("beam2d", {"num_functions": 2}, "1"),
    "num_functions=3, agg_num_levels=1": ("beam3d", {"num_functions": 3, "agg_num_levels": 1}, "1"),
    "direct, jacobi, add_p_max_elmts": (
        "27pt12", {"interp_type": "direct", "smoother": "jacobi", "add_p_max_elmts": 3}, "1"),
    "numpy hmis_py": ("27pt12", {"coarsen_type": "hmis_py"}, "0"),
    "numpy pmis": ("5pt32", {"coarsen_type": "pmis", "trunc_factor": 0.1}, "0"),
}


def _params(pkg, kw):
    kw = dict(kw)
    if "smoother" in kw:
        kw["smoother"] = (RSm if pkg is rhi else PSm)(kw["smoother"])
    return pkg.HierarchyParams(**kw)


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_build_host_hierarchy_matches_level_by_level(monkeypatch, case):
    problem, kw, native = HOST_CASES[case]
    monkeypatch.setenv("AMG_TPU_NATIVE", native)
    prob = PROBLEMS[problem]()
    want = rhi.build_host_hierarchy(prob.A, _params(rhi, kw))
    got = phi.build_host_hierarchy(port_csr(prob.A), _params(phi, kw))
    assert got.stats() == want.stats()
    assert got.num_levels >= 2, got.stats()
    for g, w in zip(got.levels, want.levels):
        assert g.weight == pytest.approx(w.weight, rel=TOL)
        assert_same_csr(g.A, w.A)
        if w.cf is None:
            assert g.cf is None and g.P is None
            continue
        np.testing.assert_array_equal(g.cf, w.cf)
        for name in ("P", "R", "P_s", "R_s", "R_inj", "P_id", "R_id"):
            assert_same_csr(getattr(g, name), getattr(w, name))


@pytest.mark.parametrize("native", ["1", "0"])
def test_csr_helpers_match(monkeypatch, native):
    """from_scipy (against the reference's from_coo), the size properties,
    and transpose / matmul on the route AMG_TPU_NATIVE selects."""
    import scipy.sparse as sp

    from amg_tpu.sparse.csr import CSRMatrix as RCSR

    monkeypatch.setenv("AMG_TPU_NATIVE", native)
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 30, 200), rng.integers(0, 20, 200)
    vals = rng.standard_normal(200)
    got = CSRMatrix.from_scipy(sp.coo_matrix((vals, (rows, cols)), shape=(30, 20)))
    want = RCSR.from_coo(rows, cols, vals, (30, 20))
    assert_same_csr(got, want, exact=True)
    assert (got.nnz, got.n_cols, got.max_row_nnz) == (want.nnz, want.n_cols, want.max_row_nnz)
    assert_same_csr(got.transpose(), want.transpose(), exact=True)
    assert_same_csr(got.matmul(got.transpose()), want.matmul(want.transpose()), exact=True)


def test_numpy_route_gives_the_other_hierarchy_f6():
    """ROADMAP F6: the native and numpy HMIS pick different C-points in 3-D;
    the goldens pin the native one (config2's level_n)."""
    prob = laplacian_3d_27pt(12)
    n_native = phi.build_host_hierarchy(port_csr(prob.A), phi.HierarchyParams()).stats()["n"]
    n_numpy = phi.build_host_hierarchy(
        port_csr(prob.A), phi.HierarchyParams(coarsen_type="hmis_py")).stats()["n"]
    assert n_native == [1728, 216, 62]
    assert n_numpy == [1728, 216, 53]


def test_sa_setup_names_its_later_slice():
    """setup_type="sa" raised NotImplementedError, naming its later slice,
    until that slice ported smoothed aggregation; now it builds the
    reference's hierarchy (tests/test_torch_aggregation.py holds it step by
    step), and an unknown setup_type is refused."""
    prob = laplacian_2d_5pt(8)
    hh, hier = phi.build_hierarchy(port_csr(prob.A),
                                   phi.HierarchyParams(setup_type="sa", max_coarse_size=10),
                                   device="cpu")
    want = rhi.build_hierarchy(prob.A, rhi.HierarchyParams(setup_type="sa",
                                                           max_coarse_size=10))[0]
    assert hh.stats()["n"] == want.stats()["n"] and hier.num_levels >= 2
    with pytest.raises(ValueError, match="setup_type"):
        phi.build_hierarchy(port_csr(prob.A), phi.HierarchyParams(setup_type="none"),
                            device="cpu")
