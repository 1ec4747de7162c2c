"""The frozen generators against matrices built by hand."""

import itertools

import numpy as np

from bench_port.reference.generators import elasticity_beam, laplacian_27pt


def test_27pt_laplacian_on_3_cubed():
    n = 3
    want = np.zeros((27, 27))
    for i, j, k in itertools.product(range(n), repeat=3):
        for a, b, c in itertools.product(range(n), repeat=3):
            if max(abs(i - a), abs(j - b), abs(k - c)) <= 1:
                want[(i * n + j) * n + k, (a * n + b) * n + c] = 26.0 if (i, j, k) == (a, b, c) else -1.0
    got = laplacian_27pt.generate(3)
    A = got["A"]
    assert A.has_sorted_indices and A.nnz == np.count_nonzero(want)
    np.testing.assert_array_equal(A.toarray(), want)
    st = got["stencil"]
    assert st["grid_shape"] == (3, 3, 3) and len(st["offsets"]) == 27
    assert sum(st["weights"]) == 0.0


def _hex_stiffness(h, lam, mu):
    """The Q1 hexahedron's 24 x 24 stiffness by B^T D B (Voigt notation),
    2 x 2 x 2 Gauss points: another route to the same matrix."""
    D = np.zeros((6, 6))
    D[:3, :3] = lam
    D[np.arange(3), np.arange(3)] += 2 * mu
    D[np.arange(3, 6), np.arange(3, 6)] = mu
    K = np.zeros((24, 24))
    g = 1 / np.sqrt(3)
    corners = list(itertools.product((0, 1), repeat=3))
    for xi in itertools.product((-g, g), repeat=3):
        B = np.zeros((6, 24))
        for a, c in enumerate(corners):
            s = [2 * ci - 1 for ci in c]
            f = [0.5 * (1 + s[d] * xi[d]) for d in range(3)]
            grad = [0.5 * s[d] * np.prod([f[e] for e in range(3) if e != d]) * 2 / h[d]
                    for d in range(3)]
            B[0, 3 * a], B[1, 3 * a + 1], B[2, 3 * a + 2] = grad
            B[3, 3 * a], B[3, 3 * a + 1] = grad[1], grad[0]  # gamma_xy
            B[4, 3 * a], B[4, 3 * a + 2] = grad[2], grad[0]  # gamma_xz
            B[5, 3 * a + 1], B[5, 3 * a + 2] = grad[2], grad[1]  # gamma_yz
        K += B.T @ D @ B * np.prod(h) / 8
    return K


def test_beam_4x2x2_against_a_hand_assembly():
    nx, ny, nz, L, H, E, nu, contrast = 4, 2, 2, 8.0, 1.0, 1.0, 0.3, 50.0
    h = (L / nx, H / ny, H / nz)
    lam0, mu0 = E * nu / ((1 + nu) * (1 - 2 * nu)), E / (2 * (1 + nu))
    node = lambda i, j, k: (i * (ny + 1) + j) * (nz + 1) + k
    N = (nx + 1) * (ny + 1) * (nz + 1) * 3
    K = np.zeros((N, N))
    for i, j, k in itertools.product(range(nx), range(ny), range(nz)):
        scale = contrast if (i + 0.5) / nx >= 0.75 else 1.0
        Ke = _hex_stiffness(h, scale * lam0, scale * mu0)
        dofs = [3 * node(i + a, j + b, k + c) + d
                for a, b, c in itertools.product((0, 1), repeat=3) for d in range(3)]
        K[np.ix_(dofs, dofs)] += Ke
    free = np.ones(N, bool)
    for j, k in itertools.product(range(ny + 1), range(nz + 1)):
        free[3 * node(0, j, k):3 * node(0, j, k) + 3] = False
    want = K[np.ix_(free, free)]
    got = elasticity_beam.generate(nx, ny, nz)
    A = got["A"].toarray()
    assert A.shape == (4 * 3 * 3 * 3, 4 * 3 * 3 * 3) == want.shape
    np.testing.assert_allclose(A, want, rtol=0, atol=1e-12 * np.abs(want).max())
    # rigid-body modes: translations 1 on their component; the (x, y)
    # rotation of node (1, 0, 0) is (-(y - ybar), x - xbar, 0)
    B = got["near_nullspace"]
    assert B.shape == (A.shape[0], 6)
    np.testing.assert_array_equal(B[0::3, 0], 1.0)
    first = 3 * (node(1, 0, 0) - (ny + 1) * (nz + 1))  # the first free node's dofs
    np.testing.assert_allclose(B[first:first + 3, 3], [0.5, 2.0 - 4.0, 0.0])
