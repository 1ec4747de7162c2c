"""The port's copies of the runner's other problem generators and of the
matrix file I/O against the JAX package's, on the CPU: the CSR arrays
exactly (indptr, indices and data bit for bit), numpy only.

  * `difconv_3d` in all four discretisations of the convection term, with
    anisotropic diffusion and signed velocities, and its constant stencil;
  * `vardifconv_3d` (random coefficients from the seed);
  * `laplacian_graded` and `amr_refine_loop` (rounds 0-2: every round's
    matrix, mesh, indicators and solve);
  * binary triplets written by either package and read by the other, the
    text <-> binary round-trip, `rcm_reorder`, and `problem_from_file`
    with disconnected and empty rows removed.
"""

import numpy as np
import pytest

from amg_tpu.problems import amr as ramr
from amg_tpu.problems import io as rio
from amg_tpu.problems import laplacian as rlap
from amg_tpu_torch.problems import amr, io
from amg_tpu_torch.problems import laplacian as lap


def assert_same_csr(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    for name in ("indptr", "indices", "data"):
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name


DIFCONV = {
    f"atype {a} {tag}": dict(atype=a, **kw)
    for a in (lap.DIFCONV_FORWARD, lap.DIFCONV_BACKWARD, lap.DIFCONV_UPWIND,
              lap.DIFCONV_CENTERED)
    for tag, kw in (("defaults", {}),
                    ("anisotropic signed", dict(eps=0.3, cx=2.0, cy=0.5, cz=1e-2,
                                                ax=-1.5, ay=3.0, az=-0.25)))
}


@pytest.mark.parametrize("name", list(DIFCONV))
def test_difconv_equals_the_reference(name):
    kw = DIFCONV[name]
    got, want = lap.difconv_3d(5, 4, 6, **kw), rlap.difconv_3d(5, 4, 6, **kw)
    assert got.name == want.name and got.grid_shape == want.grid_shape
    assert_same_csr(got.A, want.A)
    assert got.stencil.offsets == want.stencil.offsets
    assert np.array_equal(got.stencil.weights.numpy(), np.asarray(want.stencil.weights))
    assert (lap.DIFCONV_FORWARD, lap.DIFCONV_BACKWARD, lap.DIFCONV_UPWIND,
            lap.DIFCONV_CENTERED) == (0, 1, 2, 3)


def test_difconv_refuses_an_unknown_scheme():
    with pytest.raises(ValueError, match="unknown difconv atype"):
        lap.difconv_3d(4, atype=7)


@pytest.mark.parametrize("seed,eps", [(0, 1.0), (5, 0.25)])
def test_vardifconv_equals_the_reference(seed, eps):
    got = lap.vardifconv_3d(6, 5, 7, eps=eps, seed=seed)
    want = rlap.vardifconv_3d(6, 5, 7, eps=eps, seed=seed)
    assert got.stencil is None and got.grid_shape == want.grid_shape == (6, 5, 7)
    assert_same_csr(got.A, want.A)


@pytest.mark.parametrize("n,ny,gamma", [(12, None, 2.5), (9, 14, 1.0)])
def test_graded_equals_the_reference(n, ny, gamma):
    got, want = amr.laplacian_graded(n, ny, gamma=gamma), ramr.laplacian_graded(n, ny, gamma=gamma)
    assert got.name == "graded" and got.grid_shape == want.grid_shape
    assert_same_csr(got.A, want.A)


def test_amr_refine_loop_equals_the_reference():
    got = amr.amr_refine_loop(n0=6, rounds=2, theta=0.4)
    want = ramr.amr_refine_loop(n0=6, rounds=2, theta=0.4)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_csr(g["problem"].A, w["problem"].A)
        assert g["problem"].grid_shape == w["problem"].grid_shape
        assert np.array_equal(g["problem"].rhs, w["problem"].rhs)
        for key in ("xs", "ys", "eta_x", "eta_y", "u"):
            assert np.array_equal(g[key], w[key]), key
    assert got[-1]["problem"].n > got[0]["problem"].n  # the mesh was refined


def test_binary_triplets_cross_between_the_packages(tmp_path):
    A = lap.laplacian_3d_7pt(4, 3, 5).A
    mine, theirs = str(tmp_path / "mine.bin"), str(tmp_path / "theirs.bin")
    io.write_binary_triplets(mine, A)
    rio.write_binary_triplets(theirs, rlap.laplacian_3d_7pt(4, 3, 5).A)
    assert open(mine, "rb").read() == open(theirs, "rb").read()
    for sym in (False, True):
        assert_same_csr(io.read_binary_triplets(theirs, symmetrize=sym),
                        rio.read_binary_triplets(mine, symmetrize=sym))
    assert_same_csr(io.read_binary_triplets(mine), A)


def test_text_and_binary_round_trip(tmp_path):
    A = lap.laplacian_2d_5pt(5, 4).A
    b1 = str(tmp_path / "a.bin")
    io.write_binary_triplets(b1, A)
    txt, rtxt = str(tmp_path / "a.txt"), str(tmp_path / "r.txt")
    io.bin_to_text(b1, txt)
    rio.bin_to_text(b1, rtxt)
    assert open(txt).read() == open(rtxt).read()
    b2 = io.text_to_bin(txt)
    assert b2 == txt + ".bin"
    assert open(b1, "rb").read() == open(b2, "rb").read()
    assert open(rio.text_to_bin(rtxt, str(tmp_path / "r.bin")), "rb").read() == \
        open(b1, "rb").read()


def test_rcm_reorder_equals_the_reference():
    A = lap.vardifconv_3d(5, 4, 3, seed=1).A
    (got, gperm), (want, wperm) = io.rcm_reorder(A), rio.rcm_reorder(
        rlap.vardifconv_3d(5, 4, 3, seed=1).A)
    assert np.array_equal(gperm, wperm)
    assert_same_csr(got, want)


def test_problem_from_file_removes_disconnected_rows(tmp_path):
    import scipy.sparse as sp

    from amg_tpu_torch.sparse.csr import CSRMatrix

    m = sp.lil_matrix((7, 7))
    for i in range(7):
        m[i, i] = 2.0 + i
    for i, j in ((0, 1), (1, 3), (3, 6), (6, 0)):
        m[i, j] = m[j, i] = -1.0
    m[5, 5] = 0.0  # an empty row beside a diagonal-only one (2, 4)
    path = str(tmp_path / "d.bin")
    io.write_binary_triplets(path, CSRMatrix.from_scipy(m.tocsr()))
    for remove in (False, True):
        for reorder in (False, True):
            got = io.problem_from_file(path, remove_disconnected=remove, reorder=reorder)
            want = rio.problem_from_file(path, remove_disconnected=remove, reorder=reorder)
            assert got.name == "file" and got.stencil is None and got.grid_shape is None
            assert_same_csr(got.A, want.A)
            assert got.n == (4 if remove else 7)
    with pytest.raises(ValueError, match="empty matrix file"):
        open(str(tmp_path / "e.bin"), "wb").close()
        io.read_binary_triplets(str(tmp_path / "e.bin"))
