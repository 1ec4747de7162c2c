"""Shared helpers of the tests/test_torch_*.py parity tests: carry a hierarchy
built by the JAX package across to the PyTorch port as plain numpy arrays
(the format of amg_tpu_torch.convert), and run Pallas kernels in interpret
mode."""

import numpy as np
import torch

# the matrices of a generic level that cross over to the port
GENERIC_MATRICES = ("P", "R", "P_s", "R_s", "P_id", "R_id")


def interp(fn, *args, **kw):
    """Run a Pallas entry point in interpret mode on the CPU."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        return fn(*args, **kw)




def f64(a):
    return np.asarray(a, dtype=np.float64)


def gs_scan_sweep(ell, diag, u, f):
    """Exact sequential Gauss-Seidel over the rows of the port's ELLMatrix,
    one row at a time: the oracle of the GS smoother (O(n) steps)."""
    u = u.clone()
    for i in range(ell.n_rows):
        acc = torch.sum(ell.vals[i] * u[ell.cols[i].long()]) - diag[i] * u[i]
        u[i] = (f[i] - acc) / diag[i]
    return u


def bsr_blocks(m):
    """The port's BSR tiles, (nrb, bm, kb * bn), as the reference's
    (nrb, kb, bm, bn) layout."""
    return m.tiles.view(m.nrb, m.bm, m.kb, m.bn).permute(0, 2, 1, 3)


def level_sizes(hier):
    """The rows of every level's operator (the reference's
    Hierarchy.level_sizes)."""
    return tuple(lv.A.shape[0] for lv in hier.levels)


def _matrix(dev, csr):
    """A JAX ELLMatrix / BSRMatrix as the CSR arrays it was built from (the
    host level's matrix) and its device format."""
    from amg_tpu.sparse.bsr import BSRMatrix
    from amg_tpu.sparse.ell import ELLMatrix

    if dev is None:
        return None
    d = {"indptr": np.asarray(csr.indptr), "indices": np.asarray(csr.indices),
         "data": f64(csr.data), "shape": tuple(csr.shape)}
    if isinstance(dev, ELLMatrix):
        d.update(kind="ell", k=int(dev.k))
    elif isinstance(dev, BSRMatrix):
        d.update(kind="bsr", bm=int(dev.bm), bn=int(dev.bn))
    else:
        raise TypeError(type(dev).__name__)
    return d


def export_jax_hierarchy(hier, dia=False, host=None):
    """(levels, coarse_Ainv) of a JAX Hierarchy, as float64 numpy arrays and
    dicts for amg_tpu_torch.convert.hierarchy_from_arrays. With dia=True (a
    hierarchy of build_dia_structured_hierarchy, whose CPU levels are
    VarStencilOperators) the levels become the port's DIA operators, and
    masked transfers carry their masks. A generic (classical) hierarchy needs
    its HostHierarchy `host`: each ELL/BSR matrix goes across as the host
    CSR matrix it was built from, with its device format (ELL width, BSR
    tile), and block smoothers carry their block inverses."""
    from amg_tpu.setup.structured import (
        MaskedTransfer,
        StructuredRestrict,
        VarStencilOperator,
    )
    from amg_tpu.sparse.stencil import StencilOperator

    levels = []
    for k, lv in enumerate(hier.levels):
        A = lv.A
        if isinstance(A, StencilOperator):
            Ad = {"kind": "stencil", "weights": f64(A.weights),
                  "offsets": A.offsets, "grid_shape": A.grid_shape}
        elif isinstance(A, VarStencilOperator):
            Ad = {"kind": "dia" if dia else "var", "coeffs": f64(A.coeffs),
                  "offsets": A.offsets, "grid_shape": A.grid_shape}
        else:
            Ad = _matrix(A, host.levels[k].A)
        sm = {"scale": f64(lv.sm.scale), "inv_wscale": f64(lv.sm.inv_wscale), "w": f64(lv.sm.w)}
        if lv.sm.block_inv is not None:
            sm.update(block_inv=f64(lv.sm.block_inv), block_inv_bwd=f64(lv.sm.block_inv_bwd))
        if host is not None:
            hl = host.levels[k]
            levels.append({"A": Ad, "sm": sm, "transfer": None,
                           **{name: _matrix(getattr(lv, name), getattr(hl, name))
                              for name in GENERIC_MATRICES}})
            continue
        transfer = None
        if isinstance(lv.R, MaskedTransfer):
            assert isinstance(lv.R.inner, StructuredRestrict)
            transfer = {"fine_shape": lv.R.inner.fine_shape,
                        "coarse_shape": lv.R.inner.coarse_shape,
                        "fine_mask": f64(lv.R.in_mask), "coarse_mask": f64(lv.R.out_mask)}
        elif lv.R is not None:
            assert isinstance(lv.R, StructuredRestrict)
            transfer = {"fine_shape": lv.R.fine_shape, "coarse_shape": lv.R.coarse_shape}
        levels.append({"A": Ad, "sm": sm, "transfer": transfer})
    return levels, f64(hier.coarse_Ainv)


def port_hierarchy(jax_hier, dtype=None, dia=False, host=None):
    """The port's CPU Hierarchy carried across from a JAX hierarchy (a
    generic one with its HostHierarchy `host`)."""
    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays

    levels, ainv = export_jax_hierarchy(jax_hier, dia=dia, host=host)
    return hierarchy_from_arrays(
        levels, ainv, dtype=dtype or torch.float64, device="cpu"
    )


# ---------------------------------------------------------------------------
# The JAX package's random draws, replayed into the port's async loops. The
# reference draws with jax.random inside its jitted loops; these sources walk
# the same key chains eagerly and hand the port the raw numbers of each step,
# so a replayed run follows the reference's history step for step.


def _jr():
    import jax

    return jax.random


class JaxAsyncDraws:
    """async_sim.async_solve's draws for PRNGKey(seed): the wait-counter
    split first (only when the loop asks for it), then split(key, 3 + L) a
    step into the firing key, the permutation key and one read key per
    level (amg_tpu/solve/async_sim.py:225,228-236,198-209,272,363-368)."""

    def __init__(self, seed=0):
        self.key = _jr().PRNGKey(seed)
        self.kreads = None

    def wait_uniforms(self, L):
        self.key, kw = _jr().split(self.key)
        return f64(_jr().uniform(kw, (L,)))

    def step(self, L):
        self.key, kf, kp, *self.kreads = _jr().split(self.key, 3 + L)
        return f64(_jr().uniform(kf, (L,))), np.asarray(_jr().permutation(kp, L))

    def read_scalar(self, lvl):
        return float(_jr().uniform(self.kreads[lvl], ()))

    def read_rows(self, lvl, n, dtype, device):
        u = torch.tensor(f64(_jr().uniform(self.kreads[lvl], (n,))))
        return u.to(device=device, dtype=dtype)

    def record(self, L, steps):
        """Every draw of `steps` steps in SEMI mode (the scalar read of every
        level), as the lists tools/torch_async_reference.py stores."""
        fire, perm, reads = [], [], []
        for _ in range(steps):
            u, p = self.step(L)
            fire.append(u.tolist())
            perm.append(p.tolist())
            reads.append([self.read_scalar(lvl) for lvl in range(L)])
        return {"fire": fire, "perm": perm, "reads": reads}


class JaxSmoothDraws:
    """async_smooth_solve's draws for PRNGKey(seed): split(key) a step, then
    (B,) uniforms (amg_tpu/solve/async_smooth.py:105,127)."""

    def __init__(self, seed=0):
        self.key = _jr().PRNGKey(seed)

    def step(self, B, dtype, device):
        self.key, kf = _jr().split(self.key)
        return torch.tensor(f64(_jr().uniform(kf, (B,)))).to(device=device, dtype=dtype)


class JaxExtDraws:
    """ext_solve's draws for PRNGKey(seed): split(key, 3) a step into the
    firing and the read key, (L,) uniforms each
    (amg_tpu/solve/extended.py:322-329)."""

    def __init__(self, seed=0):
        self.key = _jr().PRNGKey(seed)

    def step(self, L):
        self.key, kf, kr = _jr().split(self.key, 3)
        return f64(_jr().uniform(kf, (L,))), f64(_jr().uniform(kr, (L,)))

    def record(self, L, steps):
        """Every draw of `steps` steps, as tools/torch_async_reference.py
        stores them."""
        fire, read = zip(*(self.step(L) for _ in range(steps)))
        return {"fire": [u.tolist() for u in fire], "read": [u.tolist() for u in read]}


def async_options(hier, cfg, cheby_setup, async_type="full", sim_read_delay=4,
                  accel="richardson", comm_every=1, cheby_grid=0, **kw):
    """The AsyncConfig keywords that the runner derives for an async additive
    solve, for either package (`cheby_setup` is that package's): the bounds
    of cheby_setup(num_iters=20) on the MULTADD cfg through the port's
    runner (`amg_tpu_torch/utils/runner.py::async_accel_options`)."""
    from amg_tpu_torch.utils.runner import async_accel_options

    kw = dict(kw, async_type=async_type, sim_read_delay=sim_read_delay, comm_every=comm_every)
    if accel not in ("cheby", "richardson"):
        return kw
    coeffs = cheby_setup(hier, cfg, num_iters=20)
    return dict(kw, **async_accel_options(coeffs, accel, async_type, sim_read_delay,
                                          comm_every, cheby_grid))


class JaxAMSDraws:
    """ams_async_additive_solve's draws for PRNGKey(seed): split(key, 3) a
    step into the firing and the column key, (Lg,) uniforms each
    (amg_tpu/solve/ams.py:337-343)."""

    def __init__(self, seed=0):
        self.key = _jr().PRNGKey(seed)

    def step(self, Lg):
        import jax.numpy as jnp

        self.key, kf, kr = _jr().split(self.key, 3)
        return f64(_jr().uniform(kf, (Lg,), jnp.float64)), f64(_jr().uniform(kr, (Lg,)))

    def record(self, Lg, steps):
        """Every draw of `steps` steps, as tools/torch_elasticity_reference.py
        stores them."""
        fire, cols = zip(*(self.step(Lg) for _ in range(steps)))
        return {"fire": [u.tolist() for u in fire], "cols": [u.tolist() for u in cols]}


def jax_build_ams_with_hosts(monkeypatch, A, G, Pi=None, **kw):
    """The JAX package's build_ams, with the HostHierarchy of each nodal
    hierarchy it builds (its build_hierarchy calls, recorded): (AMSData, cfg,
    [node host, Pi host])."""
    import amg_tpu.solve.ams as rams

    hosts = []
    inner = rams.build_hierarchy

    def recording(*a, **k):
        hh, hier = inner(*a, **k)
        hosts.append(hh)
        return hh, hier

    monkeypatch.setattr(rams, "build_hierarchy", recording)
    ams, cfg = rams.build_ams(A, G, Pi=Pi, **kw)
    return ams, cfg, hosts


def export_jax_ams(ams, hosts, G, Pi=None):
    """The arrays of amg_tpu_torch.convert.ams_from_arrays for a JAX AMSData
    built from the reference CSR matrices G and Pi, with the HostHierarchy of
    its nodal hierarchies (`jax_build_ams_with_hosts`)."""
    out = {"G": _matrix(ams.G, G), "Gt": _matrix(ams.Gt, G.transpose()),
           "inv_wscale": f64(ams.inv_wscale),
           "node": export_jax_hierarchy(ams.node_hier, host=hosts[0])}
    if ams.pi_hier is not None:
        out.update(Pi=_matrix(ams.Pi, Pi), Pit=_matrix(ams.Pit, Pi.transpose()),
                   pi=export_jax_hierarchy(ams.pi_hier, host=hosts[1]))
    return out


def jax_async_ams_eigs(A_dev, ams, smoothed_transfers=True):
    """The eigenvalue bounds ams_async_additive_solve estimates for omega="auto"
    and its accelerations: estimate_cycle_eigs(num_iters=20) of the summed
    group corrections (amg_tpu/solve/ams.py:283-303)."""
    import jax.numpy as jnp

    from amg_tpu.smooth import SmootherType
    from amg_tpu.solve.accel import estimate_cycle_eigs
    from amg_tpu.solve.cycles import CycleConfig, CycleType, additive_correction

    nL = ams.node_hier.num_levels
    Lg = 1 + nL + (ams.pi_hier.num_levels if ams.pi_hier is not None else 0)
    cfg = CycleConfig(cycle=CycleType.MULTADD, smoother=SmootherType.L1_JACOBI,
                      use_smoothed_transfers=smoothed_transfers)

    def group(g, r):
        if g == 0:
            return ams.inv_wscale * r
        if g <= nL:
            return ams.G @ additive_correction(ams.node_hier, cfg, ams.Gt @ r, g - 1)
        return ams.Pi @ additive_correction(ams.pi_hier, cfg, ams.Pit @ r, g - 1 - nL)

    def minv_a(u):
        r = A_dev @ u
        c = jnp.zeros_like(u)
        for g in range(Lg):
            c = c + group(g, r)
        return c

    return estimate_cycle_eigs(minv_a, A_dev.shape[0], jnp.float64, num_iters=20)
