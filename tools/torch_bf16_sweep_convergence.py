#!/usr/bin/env python3
"""How the smoother's bf16 coefficient planes (`build_dia_structured_hierarchy(
sweep_coef_dtype=torch.bfloat16)`, the reference's narrow sweep stream) move
the elasticity solve: `mixed_pcg` (float64 PCG, one float32 V(2,2)
L1-Jacobi cycle as preconditioner, tol 1e-5, at most 60 iterations) on
identity-BC beams of growing size, with float32 planes everywhere, bf16
planes on every level, and bf16 planes on the fine level alone.

    python3 tools/torch_bf16_sweep_convergence.py                 # CPU
    python3 tools/torch_bf16_sweep_convergence.py --device cuda   # the card's kernels
    python3 tools/torch_bf16_sweep_convergence.py --reference 0 1 # + the JAX package
    python3 tools/torch_bf16_sweep_convergence.py --beams 2 --reference 2

Each line gives the iterations, the true float64 CSR residual and the first
residual norms of the history, and each hierarchy the levels whose sweeps
stream bf16 planes. `--beams` picks the beams the port solves (indices into
BEAMS; all by default). With `--reference` the JAX package's own mixed_pcg
solves the beams given, with and without its bf16 stream (its kernel
operators in Pallas interpret mode on the CPU: about a minute each at 7,203
dofs, growing with the size); that option needs the JAX package and is the
only part of this script that imports it.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from amg_tpu_torch.problems.elasticity import elasticity_beam  # noqa: E402
from amg_tpu_torch.setup.structured import (  # noqa: E402
    DiaKernelOperator,
    VarStencilOperator,
    build_dia_structured_hierarchy,
    csr_to_dia_stencil,
)
from amg_tpu_torch.smooth.smoothers import SmootherType  # noqa: E402
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType  # noqa: E402
from amg_tpu_torch.solve.mixed import mixed_pcg  # noqa: E402

BEAMS = ((48, 6, 6), (96, 12, 12), (144, 18, 18))
CFG = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
                  num_pre_sweeps=2, num_post_sweeps=2)


def report(who, cells, n, variant, iters, true_rel, hist, seconds):
    print(f"{who} beam {cells} ({n} dofs) {variant:22s} iterations {iters:2d}, true rel_res "
          f"{true_rel:.3e}, history {[float(f'{h:.3g}') for h in hist[:5]]}, {seconds:.1f} s",
          flush=True)


def narrow_levels(who, cells, levels):
    """Print each level's operator type, with the dtype of its narrow sweep
    copy where it has one."""
    parts = []
    for k, lv in enumerate(levels):
        c = getattr(lv.A, "coeffs_sweep", getattr(lv.A, "c_sweep", None))
        parts.append(f"{k}:{type(lv.A).__name__}" + ("" if c is None else f"+{c.dtype}"))
    print(f"{who} beam {cells} levels (narrow sweep copy after +): {', '.join(parts)}",
          flush=True)


def port(cells, device):
    prob = elasticity_beam(*cells, bc="identity")
    nodes = tuple(c + 1 for c in cells)
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape)
    A64 = DiaKernelOperator.from_var_stencil(VarStencilOperator(
        coeffs=vs.coeffs.to(device), offsets=vs.offsets, grid_shape=vs.grid_shape))
    b = prob.rhs / np.linalg.norm(prob.rhs)
    _, hier = build_dia_structured_hierarchy(prob.A, nodes, num_functions=3,
                                             dtype=torch.float32, device=device)
    levels = range(hier.num_levels)
    for variant, narrow in (("float32 planes", ()), ("bf16 planes, all levels", levels),
                            ("bf16 planes, fine level", (0,))):
        h = hier._replace(levels=tuple(
            lv._replace(A=lv.A.with_sweep_dtype(torch.bfloat16)) if k in narrow else lv
            for k, lv in enumerate(hier.levels)))
        if narrow == levels:
            narrow_levels("port", cells, h.levels)
        t0 = time.perf_counter()
        res = mixed_pcg(h, A64, CFG, b, tol=1e-5, max_cycles=60, device=device)
        x = res.x.cpu().numpy()
        report("port", cells, prob.n, variant, res.iters,
               float(np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b)), res.history_list(),
               time.perf_counter() - t0)


def reference(cells):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from amg_tpu.problems.elasticity import elasticity_beam as jax_beam
    from amg_tpu.setup import structured as jst
    from amg_tpu.smooth import SmootherType as JaxSmoother
    from amg_tpu.solve.cycles import CycleConfig as JaxCycleConfig
    from amg_tpu.solve.cycles import CycleType as JaxCycleType
    from amg_tpu.solve.mixed import mixed_pcg as jax_mixed_pcg

    prob = jax_beam(*cells, bc="identity")
    nodes = tuple(c + 1 for c in cells)
    b = prob.rhs / np.linalg.norm(prob.rhs)
    pair = jst.csr_to_dia_stencil(prob.A, prob.grid_shape, jnp.float32, return_lo=True)
    cfg = JaxCycleConfig(cycle=JaxCycleType.MULT, smoother=JaxSmoother.L1_JACOBI,
                         num_pre_sweeps=2, num_post_sweeps=2)
    for variant, dtype in (("float32 planes", None), ("bf16 planes, all levels", jnp.bfloat16)):
        t0 = time.perf_counter()
        _, hier = jst.build_dia_structured_hierarchy(prob.A, nodes, num_functions=3,
                                                     dtype=jnp.float32, use_kernel=True,
                                                     sweep_coef_dtype=dtype)
        if dtype is not None:
            narrow_levels("reference", cells, hier.levels)
        with pltpu.force_tpu_interpret_mode():
            res = jax_mixed_pcg(hier, pair, cfg, jnp.asarray(b, jnp.float32), tol=1e-5,
                                max_cycles=60, fused=False)
        x = np.asarray(res.x, np.float64) + np.asarray(res.x_lo, np.float64)
        report("reference", cells, prob.A.shape[0], variant, int(res.iters),
               float(np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b)),
               [float(h) for h in np.asarray(res.history)], time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--beams", type=int, nargs="*", default=list(range(len(BEAMS))),
                    help="indices into BEAMS that the port solves")
    ap.add_argument("--reference", type=int, nargs="*", default=[],
                    help="indices into BEAMS that the JAX package also solves")
    args = ap.parse_args()
    torch.set_num_threads(4)
    for k in args.beams:
        port(BEAMS[k], torch.device(args.device))
    for k in args.reference:
        reference(BEAMS[k])
    return 0


if __name__ == "__main__":
    sys.exit(main())
