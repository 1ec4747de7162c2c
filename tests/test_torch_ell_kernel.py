"""The ELL spmv kernel (`amg_tpu_torch/csrc/ell_spmv.cu`, wrapper
`amg_tpu_torch/ops/ell.py`) against its plain PyTorch version.

On the CPU: the rule that picks the lanes of a row from its width, the
wrapper's widths and unroll against the kernel source's, the CPU path of
`ell_spmv` (the plain version, counted once as `spmv.ell`, no launch) and
its refusal of an x of another length than the matrix's columns. The same
path against the JAX package is `test_torch_formats.py::test_ell_matches`.

On the card (marked `cuda`; they skip without one): the kernel in float64
and float32 at every row width the benchmark's operators span, at row
counts that do not fill a block, with zero-padded slots and n_cols on both
sides of n_rows, and an empty matrix; equal bits over two launches; the
refusals of the wrapper; and every ELL product of short SA-PCG and sync
MULTADD solves launching the kernel once.

    python -m pytest tests/test_torch_ell_kernel.py -q -m cuda --noconftest

Tolerance: the kernel sums a row with fused multiply-adds and a shuffle
tree, the plain version with a multiply and PyTorch's reduction; each is
within k eps sum_j |a_ij x_j| of the exact sum, so they are held to
k eps max_i sum_j |a_ij x_j| of each other.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from amg_tpu_torch.ops import ell as oell
from amg_tpu_torch.ops.ell import ell_spmv_plain
from amg_tpu_torch.sparse.ell import ELLMatrix, ell_spmv

from torch_parity import launches

# the widths of the benchmark's operators (PERF.md §4), from 1 to 948
WIDTHS = [1, 4, 23, 48, 73, 81, 186, 429, 948]
DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def random_ell(n, n_cols, k, dtype, device, seed):
    """An (n, k) ELL matrix with random row lengths (the first row full),
    the rest of each row zero-padded (col 0, val 0), and an x of n_cols."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, k + 1, n)
    lengths[:1] = k
    live = np.arange(k)[None, :] < lengths[:, None]
    cols = np.where(live, rng.integers(0, n_cols, (n, k)), 0).astype(np.int32)
    vals = np.where(live, rng.standard_normal((n, k)), 0.0)
    x = rng.standard_normal(n_cols)
    a = ELLMatrix(cols=torch.from_numpy(cols).to(device),
                  vals=torch.from_numpy(vals).to(device=device, dtype=dtype), shape_cols=n_cols)
    return a, torch.from_numpy(x).to(device=device, dtype=dtype)


def tolerance(a, x):
    """k eps max_i sum_j |a_ij x_j|."""
    absum = ell_spmv_plain(a.cols, a.vals.abs(), x.abs())
    return max(a.k, 1) * torch.finfo(x.dtype).eps * float(absum.max())


def test_lanes_for_is_a_power_of_two_in_range_and_never_decreasing():
    got = [oell.lanes_for(k) for k in range(1, 2049)]
    assert all(lanes in oell.LANE_WIDTHS for lanes in got)
    assert all(b >= a for a, b in zip(got, got[1:]))
    for k, lanes in zip(range(1, 2049), got):
        # the smallest width whose one pass covers the row, or 32
        assert lanes * oell.SLOTS_PER_LANE >= k or lanes == 32
        assert lanes == 4 or (lanes // 2) * oell.SLOTS_PER_LANE < k
    assert [oell.lanes_for(k) for k in (16, 17, 32, 33, 64, 65)] == [4, 8, 8, 16, 16, 32]


def test_lane_widths_and_unroll_are_the_kernels():
    """LANE_WIDTHS are the cases of the source's `launch_lanes`, and
    SLOTS_PER_LANE its kUnroll: lanes_for picks only widths the library has."""
    src = (Path(oell.__file__).parent.parent / "csrc" / "ell_spmv.cu").read_text()
    cases = [int(a) for a, b in re.findall(r"case (\d+): return launch<T, (\d+)>", src)
             if a == b]
    assert tuple(cases) == oell.LANE_WIDTHS
    assert re.findall(r"constexpr int kUnroll = (\d+);", src) == [str(oell.SLOTS_PER_LANE)]


@pytest.mark.parametrize("extra", [-1, 1], ids=["short", "long"])
def test_ell_spmv_refuses_an_x_of_another_length(extra):
    """The kernel gathers x with no bounds check, so `ell_spmv` holds x to
    the matrix's columns before it counts or launches anything."""
    a, x = random_ell(37, 29, 23, torch.float64, "cpu", 1)
    x = torch.cat([x, x])[:29 + extra]
    before = launches("spmv.ell", "ell_spmv.launches")
    with pytest.raises(ValueError, match="29 columns"):
        ell_spmv(a, x)
    assert launches("spmv.ell", "ell_spmv.launches") == before


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_cpu_ell_spmv_is_the_plain_version_counted_once(dtype):
    a, x = random_ell(37, 29, 23, dtype, "cpu", 1)
    before = launches("spmv.ell", "ell_spmv.launches")
    y = ell_spmv(a, x)
    assert launches("spmv.ell", "ell_spmv.launches") == (before[0] + 1, before[1])
    assert y.dtype == dtype and torch.equal(y, ell_spmv_plain(a.cols, a.vals, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("k", WIDTHS)
def test_kernel_equals_the_plain_version(device, k, dtype):
    """2,051 rows (no block width divides them), 2,368 columns."""
    a, x = random_ell(2051, 2368, k, dtype, device, k)
    before = launches("spmv.ell", "ell_spmv.launches")
    got = a @ x
    again = a @ x
    assert launches("spmv.ell", "ell_spmv.launches") == (before[0] + 2, before[1] + 2)
    want = ell_spmv_plain(a.cols, a.vals, x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2051,)
    assert float((got - want).abs().max()) <= tolerance(a, x)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n, n_cols, k", [(1, 1, 1), (5, 300, 7), (300, 5, 40),
                                          (257, 64, 130), (63, 1000, 17)])
def test_kernel_shapes(device, n, n_cols, k):
    a, x = random_ell(n, n_cols, k, torch.float64, device, n + k)
    got = a @ x
    want = ell_spmv_plain(a.cols, a.vals, x)
    assert got.shape == (n,)
    assert float((got - want).abs().max()) <= tolerance(a, x)


@pytest.mark.cuda
def test_empty_matrix_launches_nothing(device):
    a = ELLMatrix(cols=torch.zeros((0, 4), dtype=torch.int32, device=device),
                  vals=torch.zeros((0, 4), dtype=torch.float64, device=device), shape_cols=9)
    before = launches("spmv.ell", "ell_spmv.launches")
    y = a @ torch.ones(9, dtype=torch.float64, device=device)
    assert y.shape == (0,) and y.dtype == torch.float64
    assert launches("spmv.ell", "ell_spmv.launches") == (before[0] + 1, before[1])


@pytest.mark.cuda
def test_kernel_refusals(device):
    a, x = random_ell(40, 50, 9, torch.float64, device, 2)
    with pytest.raises(ValueError, match="one dtype"):
        a @ x.float()
    with pytest.raises(ValueError, match="contiguous"):
        a @ torch.stack([x, x], dim=1)[:, 0]
    with pytest.raises(ValueError, match="int32"):
        ELLMatrix(cols=a.cols.long(), vals=a.vals, shape_cols=50) @ x
    with pytest.raises(ValueError, match="1-D"):
        a @ x[:, None]
    with pytest.raises(ValueError, match="one dtype"):
        ELLMatrix(cols=a.cols, vals=a.vals.half(), shape_cols=50) @ x.half()


def _sa_pcg(device):
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import solve

    prob = elasticity_beam(16, 4, 4)
    _, hier = build_hierarchy(prob.A, HierarchyParams(num_functions=3, setup_type="sa"),
                              near_nullspace=prob.near_nullspace, device=device)
    b = torch.from_numpy(prob.rhs / np.linalg.norm(prob.rhs))
    return lambda: solve(hier, CycleConfig(), b, tol=1e-8, outer="pcg", device=device)


def _sync_multadd(device):
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
    from amg_tpu_torch.solve.driver import solve

    prob = laplacian_3d_27pt(16)
    _, hier = build_hierarchy(prob.A, HierarchyParams(), fine_stencil=prob.stencil,
                              device=device)
    cfg = CycleConfig(cycle=CycleType.MULTADD, use_smoothed_transfers=True)
    b = torch.from_numpy(np.random.default_rng(3).random(prob.n))
    return lambda: solve(hier, cfg, b, tol=1e-8, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [_sa_pcg, _sync_multadd], ids=["sa_pcg", "sync_multadd"])
def test_every_ell_product_of_a_solve_launches_the_kernel(device, path):
    run = path(device)
    before = launches("spmv.ell", "ell_spmv.launches")
    res = run()
    after = launches("spmv.ell", "ell_spmv.launches")
    assert float(res.rel_resnorm) <= 1e-8
    assert after[0] - before[0] > 0 and after[1] - before[1] == after[0] - before[0]


def test_prefetch_starts_one_build_that_build_waits_for(tmp_path, monkeypatch):
    """`_build.prefetch` (which a CUDA set-up calls for the ELL library)
    starts nvcc once and returns; the next build() waits for that process
    and installs its output, and starts no second one."""
    from amg_tpu_torch.ops import _build

    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    fake.write_text("#!/usr/bin/env python3\nimport sys, time\n"
                    f"open({str(calls)!r}, 'a').write('x')\ntime.sleep(0.5)\n"
                    "a = sys.argv\nopen(a[a.index('-o') + 1], 'w').write('lib')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "_pending", {})
    _build.prefetch(["ell_spmv"])
    _build.prefetch(["ell_spmv"])
    assert list(_build._pending) == ["ell_spmv"] and not _build._target("ell_spmv").exists()
    path = _build.build(["ell_spmv"])["ell_spmv"]
    assert _build._pending == {} and Path(path).read_text() == "lib"
    assert calls.read_text() == "x"
    _build.prefetch(["ell_spmv"])
    assert _build._pending == {}
