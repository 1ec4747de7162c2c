#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`amg_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases (any failure exits non-zero and prints no result line):
  1. toolchain: torch, CUDA, nvcc, triton; the card's name and power limit;
  2. build: compiles every kernel (K1-K5 and the ELL kernel) from
     `amg_tpu_torch/csrc`, one nvcc per source, in parallel;
  3. kernels: K1 (all five modes), K3 and K4 (both zero_guess modes, scale
     and alpha) against their plain PyTorch versions on the card, at 126^3
     (the uniform box: K1 through the box march, `csrc/box_march.cu`) and at
     the coarse shapes 63^3 and 32^3 with the real RAP taps (K1 through the
     tap-list z-march, `csrc/tap_march.cu`, on its route for the 27 taps in
     product order, and on its route for any list with the same taps
     reversed), in float32 (max relative error <= 1e-5 on the interior) and
     float64 (<= 1e-12), shells exactly 0; for K1 on both of its kernels and
     for K4, also whether the kernel equals its plain version bit for bit
     (logged);
  4. K2 (the box march at K = 2..4): modes sweep2|3|4 and _vec at 126^3 and
     sweep3 at 190^3 (the JAX bench's headline shape), float32 and float64,
     against the plain version (the same tolerances) and bit for bit against
     K chained K1 launches;
  5. main path, V(1,1): `struct_solve` of the 27-point Laplacian at 126^3
     (2,000,376 dofs), L1-Jacobi, b = default_rng(0).random(n), float32,
     tol 1e-5 — must take 11-13 cycles to rel_res <= 1e-4 — with every
     kernel's launch counter set to 0 just before and read just after; the
     same solve in float64 to tol 1e-8 against the plain composition (a
     loop of `mult_vcycle`, no custom kernel): the same cycle count and x
     within 1e-10 relative;
  6. the V(3,3) path (K1 on both of its kernels, K3, K4; K2 where the port
     routes runs of box sweeps through it, `struct_cycle._k2_pays`): the
     same problem and counters (K1's tap-list launches counted apart),
     float32 to tol 1e-4 and float64 to 1e-8, each against the plain
     composition (the same cycle count; float64 x within 1e-10); per dtype
     the device time per cycle of `struct_timed_cycles` with every run of
     box sweeps through K2 and as K1 launches (bit-equal iterates) and the
     routing the port keeps; the host clock per cycle in float32;
  7. K5: spmv, residual and sweep on the 99-diagonal elasticity operators
     of 157,035 dofs (elasticity_beam(144, 18, 18)) and 361,875 dofs
     (elasticity_beam(192, 24, 24)), float32 and float64, against the plain
     version (1e-5 / 1e-12 relative, shells exactly 0), timed beside the
     byte bound, the plain version and the cuSPARSE CSR matvec of the same
     matrix (`torch.sparse`); the sweep also with bf16 coefficient planes
     beside both state dtypes (bit-equality logged), timed beside its byte
     bound and plain version;
  8. the elasticity path (K5): `build_dia_structured_hierarchy` of the 157k
     beam in float32, `mixed_pcg` (float64 state and operator, one float32
     V(2,2) L1-Jacobi cycle as preconditioner) to tol 1e-5 within 60
     iterations, judged by the float64 CSR residual on the host, with the
     counters reset just before and read just after, the device's busy time
     and idle share from torch.profiler; then the same solve with a float64
     preconditioner against the plain composition (K5's plain version in
     every operator): the same iterations and x within 1e-10;
  9. the elasticity solve with the smoother's planes as bf16
     (`build_dia_structured_hierarchy(sweep_coef_dtype=torch.bfloat16)`)
     on the 49,179-dof beam (elasticity_beam(96, 12, 12)), the largest of
     tools/torch_bf16_sweep_convergence.py's beams on which the JAX
     package's own bf16 stream converges: K5's bf16-plane sweep at each
     level's shape against its plain version (bit-equality logged); a true
     float64 residual <= 1e-5 within 60 iterations, in the reference's
     iteration count give or take one (32: the JAX package's own solve);
     K5's launches and its bf16-plane sweeps counted apart, ms per
     iteration and the device's busy time; against the plain composition
     on the same bf16 planes: the same iterations and x within 1e-6
     (bit-equality logged). On the 157k beam that stream does not converge
     (ROADMAP F5), so it is not a path here;
 10. the generic (algebraic) AMG path, no kernel of K1-K5 on it (their
     launch counts are logged; its ELL products run the ELL kernel,
     `csrc/ell_spmv.cu`): `build_hierarchy` of the 27-point Laplacian at 96^3
     (884,736 dofs) with the default HierarchyParams (HMIS through the
     port's native setup library, ext+i, p_max_elmts 4, L1-Jacobi, float64,
     the stencil on level 0), whose level_n and level_nnz must equal the
     JAX package's; `solve` MULT V(1,1) to tol 1e-8 from b =
     default_rng(0).random(n) in the JAX package's cycle count with a true
     float64 residual <= 1e-8 on the host CSR and the first five history
     entries the JAX package's to rtol 1e-10; the same hierarchy in
     float32 to tol 1e-4 within one cycle of the float64 history's first
     value <= 1e-4; the host clock per cycle, the device's busy time and
     idle share and its largest rows; every ELL product of the float64
     solve one launch of the ELL kernel; ELL, BSR (at choose_bsr_shape's
     tile) and cuSPARSE CSR spmv on levels 1 and 2 and on
     elasticity_beam(48, 12, 12), and ELL and cuSPARSE on level 0's P~ and
     R~, in both dtypes beside their byte bounds, the ELL kernel beside and
     against its plain version (k eps max_i sum_j |a_ij x_j|, equal bits
     over two launches; `spmv_timing`); at 48^3, hybrid JGS, Jacobi
     with Chebyshev after cheby_setup(num_iters=20), and PCG over an
     L1-Jacobi V(1,1), each to 1e-8 in the JAX package's cycle count
     (GENERIC_REF, from tools/torch_generic_reference.py);
 11. the additive and asynchronous solvers on the generic hierarchy, no
     kernel of K1-K5 on them (launch counts logged; their ELL products run
     the ELL kernel): on phase 10's 96^3
     float64 hierarchy, the device bytes of the additive transfers (P~,
     R~, P_id, R_id) and the async state; sync MULTADD (smoothed transfers,
     Chebyshev from cheby_setup) in the JAX package's cycle count, true
     residual <= 1e-8, history[:5] the reference's to rtol 1e-10; FULL
     async_multadd (Richardson, the runner's damping) on the port's own
     generators to 1e-8 within 1000 steps, true residual <= 1.1e-8, steps
     within +-25% of the reference's run, its grid waits; the host clock,
     device busy time, events and idle share per async step in float64
     and float32 and per sync cycle. At 48^3: sync multadd, afacx, bpx and
     mult_multadd in the reference's counts and afacj's 40 cycles at its
     history (rtol 1e-8; it stalls, ROADMAP F7); SEMI async_multadd, the
     reference's draws replayed: its steps, history (rtol 1e-8) and grid
     waits; FULL on the port's generators for seeds 0-4: the mean step
     count within the reference's five keys' range widened by 10%;
     async_smooth (southwell_exp) and the async implicit extended system,
     the reference's draws replayed: block updates / steps and histories
     (rtol 1e-8). The reference's numbers and draws: ASYNC_REF; then
     `mixed_solve` on the float32 96^3 hierarchy against the float64
     stencil to 1e-8: within one cycle of the JAX package's count (float32
     cycles may move it by one), true residual <= 1e-8 (ELAST_REF);
 12. the JAX bench's elasticity solve (`bench.py::aux_dia_elasticity`):
     phase 8 with hybrid JGS V(2,2), whose every sweep takes its residual
     from K5 and applies the block inverses with torch.bmm: K5 launched,
     the reference's level sizes and iterations +-1 (its Krylov state is
     double-single, here float64), true residual <= 1e-5, the float64
     preconditioner equal to its plain composition; the block solve timed
     beside the byte bound of its factor stream;
 13. goldens config10 and config11 (the 49,179-dof beam, L1-Jacobi and
     hybrid JGS) through the port's runner on the goldens' options: level_n
     and level_nnz the goldens', iterations within one, true residual <=
     1e-5, history[:5] to rtol 0.1 (their float32 histories moved on the
     reference itself across XLA builds, ROADMAP F1), K5 launched;
 14. SA-PCG (golden config8's recipe) on elasticity_beam(144, 18, 18),
     155,952 dofs: the reference's level sizes and nnz and float64
     iterations, rel_res <= 1e-8 and a true residual within 5% of the
     reference's own (1.12e-8: PCG's recursive residual drifts from the
     true one on this beam); the float32 hierarchy under mixed_pcg (plain
     float32 PCG does not converge here, in the reference either) to a
     true residual <= 1e-8; every ELL product of the float64 solve one
     launch of the ELL kernel; the peak memory of one ELL spmv above the
     live set (its output); the ELL kernel on level 0's A, P and R as in
     phase 10's `spmv_timing`;
 15. AMS-PCG on maxwell_curlcurl(40), 182,520 edges, float64, b =
     default_rng(0).random(n): the node and Pi hierarchies' level sizes and
     the iterations the reference's, true residual <= 1e-8; the async
     additive AMS solve on maxwell_curlcurl(8) on the reference's recorded
     draws: its steps and history (rtol 1e-8). The reference's numbers and
     draws of 12-15 and of phase 11's mixed_solve: ELAST_REF;
 16. timing with CUDA events: the V(1,1) per-cycle time of
     `struct_timed_cycles` (slope between two cycle counts) and K1, K3, K4
     at their 126^3 shapes beside their plain versions, their DRAM byte
     bound and, for K1, the `torch.nn.functional.conv3d` yardstick; K3's
     zero-guess launches at the path's 63^3 and 32^3 levels, with those
     levels' RAP taps and smoother scale (`make_coarse_specs`), beside
     their plain versions and byte bounds (b, s and rc once each,
     `ops/transfer.py::k3_bytes`), and K4's zero-guess launches there
     (b, s, ec and out once each, `k4_bytes`); K1's tap-list route in the
     sweeps of the V(3,3) path's 63^3 and 32^3 levels (their RAP taps and
     scale), float32 and float64, beside their bounds, plain versions and
     (float32) conv3d; K2 in sweep2_vec and sweep3_vec at 126^3 and
     sweep2_vec and sweep3 at 190^3 (the JAX bench's headline), each beside
     the chain of K1 launches that does the same sweeps.
 17. the drivers (`amg_tpu_torch/utils/runner.py::run_experiment`, as its
     halves setup_experiment / solve_experiment, which keep the hierarchy
     for the plain composition; every launch counter set to 0 just before
     each run and read just after): (a) the flagship, 27pt at 126^3 on the
     structured hierarchy (the runner's max_coarse_size 64), float64, tol
     1e-8, V(1,1) L1-Jacobi through struct_solve: K1 (box), K3 and K4
     launched, a true float64 residual <= 1e-8 on the host CSR, the cycles
     and x (1e-10) of the plain composition (driver.solve on the same
     hierarchy, no kernel launched); setup and solve times, host and
     device ms per cycle and the idle share; the same at V(3,3) by the
     sweep flags (K1's tap route launched); (b) the JAX bench's elasticity
     solve through the runner: config11's options (hybrid JGS, float32 DIA
     hierarchy under mixed_pcg, tol 1e-5) on the 157k beam with the bench's
     V(2,2): K5 launched, phase 12's level sizes, the reference's 14
     iterations +-1, true residual <= 1e-5; config10's options (L1-Jacobi)
     likewise in phase 8's 20 +-1; (c) the single-device goldens through
     the runner: config1/2/5/9 and config8 by count, shapes and history[:5]
     (rtol 1e-10), config3/13 on the port's generators converged in the
     golden's steps +-25% (config10/11: phase 13); (d) the CLI, `python3 -m
     amg_tpu_torch.utils.cli -problem 27pt -n 126 -hierarchy structured
     -oneline_output`, in its own process: (a)'s cycles, rel_res <= 1e-8;
     (e) `-print_level_stats` on the 96^3 generic MULT solve: the
     segmented profile's x after 5 cycles equals cycle_step's (1e-12), the
     per-level phase table; (f) vardifconv at 96^3 on the structured
     hierarchy (float64 DIA levels, K5; the generic cycle, ROADMAP F10): K5
     launched, rel_res <= 1e-8, the cycles of the plain composition (K5's
     plain version in every operator).
 18. the row-partitioned multi-device path (`amg_tpu_torch/parallel/`), one
     process, a mesh of 8 logical shards on the card; no kernel of K1-K5 on
     it, as in the reference (every counter of K1-K5 must read 0; the
     shards' plain ELL operators run the ELL kernel, its launches logged):
     (a) goldens config7 and config4 through run_experiment(num_devices=8):
     cycles, level_n, history[:5] to rtol 1e-10, rel_res <= tol; (b) phase
     10's 96^3 host
     hierarchy through build_dist_hierarchy(comm="halo"), 110,592 rows a
     shard, MULT V(1,1) float64 to 1e-8: the single-device 41 cycles, x
     within 1e-9 of phase 10's, a true residual <= 1e-8; the halo bytes
     and messages a cycle (comm_trace); host ms, device ms and events and
     the idle share a cycle; the same hierarchy on comm="gspmd" (the
     padded single-device computation): 41 cycles, x within 1e-9; (c)
     AMS-PCG row-sharded (build_sharded_ams / solve_sharded_ams_pcg, G and
     Pi) on maxwell_curlcurl(40), 182,520 edges, phase 15's b: the
     single-device 124 iterations +-1, a true residual <= 1e-8, host and
     device ms an iteration;
 19. grid (level) parallelism on the same mesh (`parallel.grid`), every
     K1-K5 counter 0 again: (a) goldens config6 and config12 through
     run_experiment(num_devices=8) on the port's generators: level_n and
     level_nnz, steps within +-25% of the golden's; (b) phase 11's 96^3
     FULL async_multadd over the work model's level groups of 8 shards
     (plan_grid_levels, grid_parallel_solve, owned storage) under the same
     GeneratorDraws(0): phase 11's step count (+-1 only where its history
     ends within 1e-12 of tol), x within 1e-9; host ms, device ms, events
     and idle a step; each shard's device time for one step's corrections
     beside the work model's share; (c) the grid-mapped extended system
     (explicit_ext_bpx, its AA a HaloELL over the shards) on the 27-point
     30^3 problem, the largest whose explicit AA fits the card, through the
     runner: rel_res <= 1e-8, its halo bytes a step, the device peak;
     (d) the async AMS groups on maxwell_curlcurl(40) for 100 steps
     against the single-device async AMS under the same draws: x within
     1e-9, the owned bytes a shard (the work model puts every group on
     one shard there), and the same at n = 6, where each group has a shard
     of its own; (e)
     dryrun_multichip(8) inside its gates, its row and grid parts. A {"grid": ...} line records it.
 20. every route across processes (ROADMAP item 11c): chip_smoke.py
     re-invokes itself as 2 workers (`--p20-worker`), NCCL with one card
     each where the machine shows two cards, else gloo on cuda:0 with the
     mesh staging each collective through host buffers (NCCL refuses two
     ranks on one device, `tools/torch_nccl_probe.py`); each holds 4 of the
     8 shards and prints its backend and device. Each route is held against
     the one-process 8-shard run of the same options (phase 18's / 19's x
     where they ran it): (a) gspmd on phase 10's 96^3 hierarchy; (b) FULL
     async_multadd (phase 11's options, the same seeded generators), (c)
     mixed_solve (float32 cycles, float64 halo operator) and (d) Chebyshev
     after cheby_setup by power (its bounds to 1e-12) on its halo
     hierarchy; (e) async_smooth for 100 steps on the 27-point 96^3 plane
     halo (its history to 1e-12); (f) the grid-mapped extended system at
     27pt 30^3; (g) config4's options with hybrid JGS on the 157k beam (PCG,
     x within 1e-10); (h) 126^3 on the structured hierarchy through the
     generic cycle in float64 and in float32 (tol 1e-4): x exactly the
     one-process run's (the plane-split levels 32^3, 16^3, 8^3 apply their
     operators in the global expression, the dots sum the shards' dots in
     shard order); (i) the identity-BC beam 143x18x18 (144 node planes,
     155,952 dofs; its level 0 plane-split) under -hierarchy structured
     -mixed_precision with config10's options (float32 DIA levels, the
     float64 outer operator): the same PCG count, x within 1e-10; the
     levels' layouts printed; elsewhere the same steps, x within 1e-12,
     every K1-K5 counter 0 in every process; host ms, device ms and events
     a step, and the bytes sent to the other process a step
     (`RowMesh.sent_bytes`). A {"routes": ...} line records it.
The last two lines are the `kernels` JSON object (K1 on both of its
kernels, K2-K5, K5's bf16-plane sweep, the ELL kernel) and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

N_SIDE = 126
SEED = 0
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores
TOL = {"float32": 1e-5, "float64": 1e-12}
BEAM = (144, 18, 18)  # the JAX bench's aux_dia_elasticity beam: 157,035 dofs
BEAM_LARGE = (192, 24, 24)  # the bench's larger DIA operator: 361,875 dofs
# the bf16 sweep planes' solve: 49,179 dofs, on which the JAX package's
# mixed_pcg with its bf16 stream (sweep_coef_dtype=jnp.bfloat16, Pallas in
# interpret mode on the CPU) takes BF16_REF_ITERS iterations to a true
# residual <= 1e-5 (tools/torch_bf16_sweep_convergence.py --reference 1).
# The port must take as many, give or take one: float32 summation order
# moves the count by one there (the port's own CPU run takes 31), as it
# moves the V(1,1) solve's stagnation guard
BEAM_BF16 = (96, 12, 12)
BF16_REF_ITERS = 32


def log(*a):
    print(*a, flush=True)


def toolchain():
    import torch

    log("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    from amg_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True)
    log("nvcc", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton

        log("triton", triton.__version__)
    except ImportError:
        log("triton not installed")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def build():
    from amg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"build: {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        entry = "?"
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:
                log(f"  ptxas[{name}] {entry[:70]}: {line.split(':', 1)[-1].strip()}")


def rand_pad(rng, gs, dtype, device):
    """Seeded random interior values in the padded layout (zero shell)."""
    import torch

    from amg_tpu_torch.ops.stencil import to_padded

    x = torch.from_numpy(rng.random(int(np.prod(gs)))).to(device=device, dtype=dtype)
    return to_padded(x, gs)


def compare(name, got, want, gs, dtype_name, errs):
    """Max relative error on the interior (max |got - want| / max |want|)
    and an exactly-zero shell; returns the failure text or None."""
    import torch

    from amg_tpu_torch.ops.stencil import from_padded

    gi, wi = from_padded(got, gs).double(), from_padded(want, gs).double()
    abs_err = float((gi - wi).abs().max())
    rel = abs_err / max(float(wi.abs().max()), 1e-300)
    shell = got.clone()
    Z, Y, X = gs
    shell[1:Z + 1, 1:Y + 1, 1:X + 1] = 0
    shell_ok = bool(torch.all(shell == 0))
    ok = rel <= TOL[dtype_name] and shell_ok and bool(torch.isfinite(gi).all())
    errs.append((name, dtype_name, abs_err, rel, ok))
    log(f"  {name:44s} {dtype_name} rel {rel:.3e} abs {abs_err:.3e} shell0 {shell_ok} "
        f"{'ok' if ok else 'FAIL'}")
    return None if ok else f"{name} {dtype_name}"


def kernel_phase(hier64, device):
    """Every kernel against its plain version at the main path's shapes."""
    import torch

    from amg_tpu_torch.ops.stencil import MODES, stencil_kernel_padded, stencil_plain, taps_of
    from amg_tpu_torch.ops.transfer import (
        coarse_shape_of,
        prolong_sweep_padded,
        prolong_sweep_plain,
        residual_restrict_padded,
        residual_restrict_plain,
    )
    from amg_tpu_torch.solve.struct_cycle import make_coarse_specs, make_struct_spec

    specs = {0: make_struct_spec(hier64)}
    specs.update(make_coarse_specs(hier64))
    rng = np.random.default_rng(SEED)
    errs, fails = [], []
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for lvl, spec in sorted(specs.items()):
            gs, w, off = spec.grid_shape, spec.weights, spec.offsets
            taps = taps_of(w, off)
            kind = "box" if lvl == 0 else "rap27"
            u, b = rand_pad(rng, gs, dtype, device), rand_pad(rng, gs, dtype, device)
            s = spec.scale_pad.to(dtype)
            alpha = float(hier64.levels[lvl].sm.inv_wscale.mean())
            for mode in MODES:
                k = stencil_kernel_padded(u, b, w, gs, off, alpha=alpha, scale_pad=s, mode=mode)
                p = stencil_plain(u, b, taps, gs, alpha, s if "vec" in mode else None, mode)
                if mode == "sweep_vec_norm":
                    (k, kn), (p, pn) = k, p
                    ks, ps = float(kn.double().sum()), float(pn.double().sum())
                    nrel = abs(ks - ps) / ps
                    nok = nrel <= TOL[dn]
                    log(f"  K1 {kind} {gs} norm partial sum            {dn} rel {nrel:.3e} "
                        f"{'ok' if nok else 'FAIL'}")
                    if not nok:
                        fails.append(f"K1 norm {gs} {dn}")
                fails.append(compare(f"K1 {mode} {kind} {gs}", k, p, gs, dn, errs))
                log(f"  K1 {mode} {kind} {gs} {dn}: equal to the plain version bit for bit: "
                    f"{bool(torch.equal(k, p))}")
            if kind == "rap27":
                # K1's route for any tap list: the same taps reversed
                rw, roff = tuple(reversed(w)), tuple(reversed(off))
                for mode in MODES:
                    k = stencil_kernel_padded(u, b, rw, gs, roff, alpha=alpha, scale_pad=s,
                                              mode=mode)
                    p = stencil_plain(u, b, taps_of(rw, roff), gs, alpha,
                                      s if "vec" in mode else None, mode)
                    if mode == "sweep_vec_norm":
                        (k, _), (p, _) = k, p
                    fails.append(compare(f"K1 {mode} list {gs}", k, p, gs, dn, errs))
                    log(f"  K1 {mode} list {gs} {dn}: equal to the plain version bit for bit: "
                        f"{bool(torch.equal(k, p))}")
            cs = coarse_shape_of(gs)
            for zg, a in ((False, 0.0), (True, 0.0), (True, alpha)):
                sa = None if a else s
                k = residual_restrict_padded(u, b, w, gs, off, zero_guess=zg, scale_pad=sa, alpha=a)
                p = residual_restrict_plain(u, b, taps, gs, zg, sa, a)
                tag = f"K3 zg={int(zg)} {'alpha' if a else 'scale'} {kind} {gs}"
                fails.append(compare(tag, k, p, cs, dn, errs))
            ec = rand_pad(rng, cs, dtype, device)
            for zg in (False, True):
                for a in (0.0, alpha):
                    sa = None if a else s
                    k = prolong_sweep_padded(u, b, ec, w, gs, off, alpha=a, scale_pad=sa, zero_guess=zg)
                    p = prolong_sweep_plain(u, b, ec, taps, gs, a, sa, zg)
                    tag = f"K4 zg={int(zg)} {'alpha' if a else 'scale'} {kind} {gs}"
                    fails.append(compare(tag, k, p, gs, dn, errs))
                    log(f"  {tag} {dn}: equal to the plain version bit for bit: "
                        f"{bool(torch.equal(k, p))}")
    torch.cuda.synchronize()
    fails = [f for f in fails if f]
    return errs, fails


def reset_counts():
    from amg_tpu_torch.utils import tracing

    tracing.reset()


def read_counts():
    from amg_tpu_torch.utils import tracing

    return {
        "K1": tracing.counter("stencil_kernel_padded.launches"),
        "K1 taps": tracing.counter("stencil_kernel_padded.tap_launches"),
        "K2": tracing.counter("stencil_kernel_padded.k2_launches"),
        "K3": tracing.counter("residual_restrict_padded.launches"),
        "K4": tracing.counter("prolong_sweep_padded.launches"),
        "K5": tracing.counter("var_stencil_kernel_padded.launches"),
        "K5 bf16": tracing.counter("var_stencil_kernel_padded.bf16_launches"),
        "ELL": tracing.counter("ell_spmv.launches"),
    }


def ported_launches(counts):
    """The launches of K1-K5, the kernels that port the reference's, out of
    read_counts(): what the paths that run none of them are held to. The
    ELL kernel runs on every path with an ELL operator on the card."""
    return {k: v for k, v in counts.items() if k != "ELL"}


def every_ell_product_launched(label, counts, fails):
    """Since the last reset_counts(): every ELL product (`spmv.ell`) was one
    launch of the ELL kernel, and there was one."""
    from amg_tpu_torch.utils import tracing

    products = tracing.counter("spmv.ell")
    if counts["ELL"] != products or products == 0:
        fails.append(f"{label}: {counts['ELL']} ELL kernel launches for {products} ELL products")


def true_rel_residual(prob, x, b):
    r = b - prob.A @ x
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def plain_solve(hier, cfg, b, tol, max_cycles):
    """The plain composition: mult_vcycle in plain PyTorch ops (no custom
    kernel) under struct_solve's stopping rule."""
    import torch

    from amg_tpu_torch.solve.cycles import mult_vcycle

    A0 = hier.levels[0].A
    r0 = torch.linalg.norm(b - A0 @ torch.zeros_like(b))
    x = torch.zeros_like(b)
    hist = [1.0]
    rel = math.inf
    k = 0
    while k < max_cycles and rel > tol and not (k >= 2 and rel > 0.99 * hist[k - 1]):
        x = mult_vcycle(hier, cfg, x, b)
        rel = float(torch.linalg.norm(b - A0 @ x) / r0)
        hist.append(rel)
        k += 1
    return x, k, hist


def cuda_time(fn, reps):
    """Mean device ms per call over `reps` calls after one warm-up, CUDA
    events. A ~50 ms spin kernel ahead of the start event lets the host queue
    every launch before the timed window opens, so the window holds device
    work and no host launch gaps."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cycle_phase(hier32, cfg, b32, device):
    """The per-cycle time of struct_timed_cycles (no host sync inside): the
    slope of the host clock between 10 and 60 cycles, best of 3 each; then
    the device's busy time per cycle, by kernel, as the slope between
    profiled runs of 10 and 20 cycles (the slopes drop the per-call set-up),
    and its idle share against the host-clock slope."""
    import torch

    from amg_tpu_torch.solve.struct_cycle import struct_timed_cycles

    def run(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        struct_timed_cycles(hier32, cfg, b32, k, device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    k0, k1 = 10, 60
    cycle_ms, s0, s1 = host_slope_ms(run, k0, k1)
    log(f"per-cycle time (struct_timed_cycles slope {k0}->{k1}, float32): {cycle_ms:.4f} ms; "
        f"samples {k0}: {[round(t * 1e3, 3) for t in s0]} ms, "
        f"{k1}: {[round(t * 1e3, 3) for t in s1]} ms")

    busy_ms, events, rows = device_per_cycle(
        lambda k: struct_timed_cycles(hier32, cfg, b32, k, device=device), 10, 20)
    if busy_ms > 0:
        idle = 1.0 - busy_ms / cycle_ms
        log(f"device busy per cycle (torch.profiler, slope 10->20 cycles): {busy_ms:.4f} ms "
            f"in {events:.1f} kernel and copy events; idle share against the host-clock "
            f"slope: {idle:.3f}")
        for ms, n, name in rows[:12]:
            log(f"  {ms:.4f} ms/cycle  {n:5.1f} launches/cycle  {name[:100]}")
    else:
        idle = None
        log("device busy per cycle: not measured (the profiler recorded no device time)")
    return {"cycle_ms": cycle_ms, "device_busy_ms": busy_ms or None,
            "device_events": events or None, "idle_share": idle}


def timing_phase(hier32, device, counts, iters):
    import torch
    import torch.nn.functional as F

    from amg_tpu_torch.ops.stencil import (
        k1_taps_plan,
        stencil_kernel_padded,
        stencil_plain,
        taps_of,
    )
    from amg_tpu_torch.ops.transfer import (
        coarse_shape_of,
        k3_bytes,
        k4_bytes,
        prolong_sweep_padded,
        prolong_sweep_plain,
        residual_restrict_padded,
        residual_restrict_plain,
    )
    from amg_tpu_torch.solve.struct_cycle import make_coarse_specs, make_struct_spec

    spec = make_struct_spec(hier32)
    gs, w, off = spec.grid_shape, spec.weights, spec.offsets
    taps = taps_of(w, off)
    cs = coarse_shape_of(gs)
    rng = np.random.default_rng(SEED + 1)
    # four input sets, cycled, so the working set (~134 MB) exceeds the 50 MB
    # L2 and each launch reads its inputs from device memory as the cycle does
    sets = [
        (rand_pad(rng, gs, torch.float32, device), rand_pad(rng, gs, torch.float32, device),
         rand_pad(rng, cs, torch.float32, device))
        for _ in range(4)
    ]
    s = spec.scale_pad
    state_bytes = sets[0][0].numel() * 4
    pts = int(np.prod(gs))
    nt = len(taps)
    results = {}

    k1_bytes = 4 * state_bytes  # u, b, s in; out
    k1_flops = 2 * nt * pts + 6 * pts
    # the taps as a 3x3x3 cross-correlation weight: conv3d of the padded u
    # is A u on the interior (the spmv arithmetic of K1), in full float32
    box = torch.zeros(3, 3, 3)
    for (dz, dy, dx, wt) in taps:
        box[dz + 1, dy + 1, dx + 1] = wt
    box = box.to(device)[None, None]
    results["K1"] = dict(
        ms=cuda_time(lambda i: stencil_kernel_padded(
            sets[i % 4][0], sets[i % 4][1], w, gs, off, scale_pad=s, mode="sweep_vec_norm"), 50),
        plain_ms=cuda_time(lambda i: stencil_plain(
            sets[i % 4][0], sets[i % 4][1], taps, gs, 0.0, s, "sweep_vec_norm"), 10),
        library_ms=cuda_time(lambda i: F.conv3d(sets[i % 4][0][None, None], box), 50),
        bytes=k1_bytes, flops=k1_flops,
    )
    k3_flops = 2 * nt * pts + pts + 2 * 27 * int(np.prod(cs))
    results["K3"] = dict(
        ms=cuda_time(lambda i: residual_restrict_padded(
            sets[i % 4][0], sets[i % 4][1], w, gs, off), 50),
        plain_ms=cuda_time(lambda i: residual_restrict_plain(
            sets[i % 4][0], sets[i % 4][1], taps, gs), 10),
        library_ms=None, bytes=k3_bytes(gs, torch.float32, False, False), flops=k3_flops,
    )
    # x, b, s, ec in; out. Operations per point on the box: the z-, y- and
    # x-sums 6, the combine 3, the update 3; u' = x + P ec at most 5 (the
    # add, the z-mean and the y- and x-means at most 2 each)
    k4_flops = (12 + 5) * pts
    results["K4"] = dict(
        ms=cuda_time(lambda i: prolong_sweep_padded(
            sets[i % 4][0], sets[i % 4][1], sets[i % 4][2], w, gs, off, scale_pad=s), 50),
        plain_ms=cuda_time(lambda i: prolong_sweep_plain(
            sets[i % 4][0], sets[i % 4][1], sets[i % 4][2], taps, gs, 0.0, s), 10),
        library_ms=None, bytes=k4_bytes(gs, torch.float32, False, True), flops=k4_flops,
    )
    for name, r in results.items():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"{name} at {gs} float32: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"{r['bytes'] / 1e6:.1f} MB), launches/cycle {counts[name] / iters:.3f}")
    # K3's zero-guess launches: each coarse level's down-visit, fed its rhs
    # (here random) with the level's own taps and scale, as the path runs it
    for lvl, cspec in sorted(make_coarse_specs(hier32).items()):
        cgs, cw, coff = cspec.grid_shape, cspec.weights, cspec.offsets
        sa = None if cspec.alpha != 0.0 else cspec.scale_pad
        bsets = [rand_pad(rng, cgs, torch.float32, device) for _ in range(4)]
        nbytes = k3_bytes(cgs, torch.float32, True, sa is not None)
        r = dict(
            ms=cuda_time(lambda i: residual_restrict_padded(
                None, bsets[i % 4], cw, cgs, coff, zero_guess=True, scale_pad=sa,
                alpha=cspec.alpha), 50),
            plain_ms=cuda_time(lambda i: residual_restrict_plain(
                None, bsets[i % 4], taps_of(cw, coff), cgs, True, sa, cspec.alpha), 10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes,
        )
        results[f"K3 zero-guess level {lvl}"] = r
        log(f"K3 zero-guess level {lvl} at {cgs} float32 ({'scale' if sa is not None else 'alpha'}"
            f", {len(coff)} RAP taps): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes, {nbytes / 1e6:.3f} MB: b, "
            f"{'s, ' if sa is not None else ''}rc once each)")
        # K1's tap-list route (csrc/tap_march.cu): the level's smoother sweep,
        # as the V(3,3) path chains it, in both dtypes
        mode = "sweep_vec" if sa is not None else "sweep"
        ctaps = taps_of(cw, coff)
        for dtype in (torch.float32, torch.float64):
            dn = str(dtype).split(".")[-1]
            usets = [(rand_pad(rng, cgs, dtype, device), rand_pad(rng, cgs, dtype, device))
                     for _ in range(4)]
            st = None if sa is None else sa.to(dtype)
            item = usets[0][0].element_size()
            # u, b (s) in; out; 2 operations a tap and 3 (2 without s) a point
            nbytes = (4 if st is not None else 3) * usets[0][0].numel() * item
            flops = (2 * len(coff) + 3) * int(np.prod(cgs))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / (F32_FLOPS if dtype == torch.float32 else F64_FLOPS) * 1e3
            r = dict(
                ms=cuda_time(lambda i: stencil_kernel_padded(
                    usets[i % 4][0], usets[i % 4][1], cw, cgs, coff, alpha=cspec.alpha,
                    scale_pad=st, mode=mode), 50),
                plain_ms=cuda_time(lambda i: stencil_plain(
                    usets[i % 4][0], usets[i % 4][1], ctaps, cgs, cspec.alpha, st, mode), 10),
                library_ms=None, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=nbytes,
            )
            if dtype == torch.float32:
                # conv3d of the padded u with the taps as a 3x3x3 weight: the spmv
                # arithmetic of the same launch, in full float32
                cbox = torch.zeros(3, 3, 3)
                for (dz, dy, dx, wt) in ctaps:
                    cbox[dz + 1, dy + 1, dx + 1] = wt
                cbox = cbox.to(device)[None, None]
                r["library_ms"] = cuda_time(
                    lambda i: F.conv3d(usets[i % 4][0][None, None], cbox), 50)
            results[f"K1 taps level {lvl} {dn}"] = r
            lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
            log(f"K1 tap-list route level {lvl} at {cgs} {dn} ({mode}, {len(coff)} RAP taps, "
                f"plan {k1_taps_plan(cgs)}): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library (conv3d, spmv only) {lib} ms, bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}, {nbytes / 1e6:.3f} MB)")
        # K4's zero-guess launch: the level's up-visit, u' = s*b + P ec and
        # one sweep, with a random coarse correction
        ecsets = [rand_pad(rng, coarse_shape_of(cgs), torch.float32, device) for _ in range(4)]
        nbytes = k4_bytes(cgs, torch.float32, True, sa is not None)
        r = dict(
            ms=cuda_time(lambda i: prolong_sweep_padded(
                None, bsets[i % 4], ecsets[i % 4], cw, cgs, coff, alpha=cspec.alpha,
                scale_pad=sa, zero_guess=True), 50),
            plain_ms=cuda_time(lambda i: prolong_sweep_plain(
                None, bsets[i % 4], ecsets[i % 4], taps_of(cw, coff), cgs, cspec.alpha, sa,
                True), 10),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes", bytes=nbytes,
        )
        results[f"K4 zero-guess level {lvl}"] = r
        log(f"K4 zero-guess level {lvl} at {cgs} float32 ({'scale' if sa is not None else 'alpha'}"
            f", {len(coff)} RAP taps): {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms (bytes, {nbytes / 1e6:.3f} MB: b, "
            f"{'s, ' if sa is not None else ''}ec, out once each)")
    return results


def box27():
    """(weights, offsets) of the 27-point Laplacian box (the uniform box)."""
    import itertools

    offsets = tuple(itertools.product((-1, 0, 1), repeat=3))
    return tuple(26.0 if o == (0, 0, 0) else -1.0 for o in offsets), offsets


def k2_phase(device):
    """K2 against its plain version and, bit for bit, against the K1 chain."""
    import torch

    from amg_tpu_torch.ops.stencil import SWEEPK_MODES, stencil_kernel_padded, sweepk_plain, taps_of

    w, off = box27()
    taps = taps_of(w, off)
    rng = np.random.default_rng(SEED + 2)
    errs, fails = [], []
    alpha = 1.0 / 52.0  # the L1-Jacobi scale of the box's interior rows
    for gs, modes in (((N_SIDE,) * 3, SWEEPK_MODES), ((190,) * 3, ("sweep3",))):
        for dtype in (torch.float32, torch.float64):
            dn = str(dtype).split(".")[-1]
            u, b = rand_pad(rng, gs, dtype, device), rand_pad(rng, gs, dtype, device)
            s = (0.5 + 0.5 * rand_pad(rng, gs, dtype, device)) / 52.0
            for mode in modes:
                k, vec = int(mode[5]), mode.endswith("_vec")
                sa = s if vec else None
                got = stencil_kernel_padded(u, b, w, gs, off, alpha=alpha, scale_pad=sa, mode=mode)
                want = sweepk_plain(u, b, taps, gs, k, alpha, sa)
                fails.append(compare(f"K2 {mode} {gs}", got, want, gs, dn, errs))
                chain = u
                for _ in range(k):
                    chain = stencil_kernel_padded(chain, b, w, gs, off, alpha=alpha, scale_pad=sa,
                                                  mode="sweep_vec" if vec else "sweep")
                exact = bool(torch.equal(got, chain))
                log(f"  K2 {mode:10s} {gs} {dn}: equal to {k} chained K1 launches: {exact}")
                if not exact:
                    fails.append(f"K2 {mode} {gs} {dn} differs from the K1 chain")
    torch.cuda.synchronize()
    return errs, [f for f in fails if f]


def device_per_cycle(run, k0, k1):
    """(busy ms, events, rows (ms, launches, name) by time) per cycle on the
    device: the slope between profiled runs of run(k0) and run(k1) cycles
    (the slope drops the per-call set-up)."""

    def times(k):
        _, _, rows = profile_device_ms(lambda: run(k))
        return {key: (ms, n) for ms, n, key in rows}

    p0, p1 = times(k0), times(k1)
    rows = []
    for key, (ms, n) in p1.items():
        ms0, n0 = p0.get(key, (0.0, 0))
        rows.append(((ms - ms0) / (k1 - k0), (n - n0) / (k1 - k0), key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows


@contextlib.contextmanager
def sweep_routing(fuse):
    """Runs of box sweeps in the structured cycle through K2 (fuse True) or
    as single K1 launches (False), whatever `struct_cycle._k2_pays` would
    choose; the same arithmetic either way."""
    from amg_tpu_torch.solve import struct_cycle

    gate = struct_cycle._k2_pays
    struct_cycle._k2_pays = lambda u_pad: fuse
    try:
        yield
    finally:
        struct_cycle._k2_pays = gate


def host_slope_ms(run, k0, k1, reps=3):
    """(ms per unit, samples) from the host clock: best-of-reps slope of
    run(k) between k0 and k1 (run synchronises)."""
    run(k0)
    s0 = [run(k0) for _ in range(reps)]
    s1 = [run(k1) for _ in range(reps)]
    return (min(s1) - min(s0)) / (k1 - k0) * 1e3, s0, s1


def v33_phase(hier32, hier64, b, device):
    """The V(3,3) structured solve, float32 and float64, each against the
    plain composition and with the kernels' counters reset just before and
    read just after; then, per dtype, the device time per cycle with every
    run of box sweeps through K2 and as K1 launches (the same iterates), and
    the routing the port keeps (`struct_cycle._k2_pays`)."""
    import torch

    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve import struct_cycle
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
    from amg_tpu_torch.solve.struct_cycle import struct_solve, struct_timed_cycles

    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
                      num_pre_sweeps=3, num_post_sweeps=3)
    fails, out = [], {}
    for hier, tol in ((hier32, 1e-4), (hier64, 1e-8)):
        spec = struct_cycle.make_struct_spec(hier)
        dn = str(spec.scale_pad.dtype).split(".")[-1]
        kept = "K2" if struct_cycle._k2_pays(spec.scale_pad) else "K1 chain"
        bt = torch.from_numpy(b).to(device=device, dtype=spec.scale_pad.dtype)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = struct_solve(hier, cfg, bt, tol=tol, max_cycles=40, device=device)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        x_ref, it_p, _ = plain_solve(hier, cfg, bt, tol, 40)
        rel = float(res.rel_resnorm)
        dx = float(torch.linalg.norm(res.x.double() - x_ref.double())
                   / torch.linalg.norm(x_ref.double()))
        log(f"V(3,3) {dn} solve {N_SIDE}^3: cycles {res.iters} (plain composition {it_p}), "
            f"rel_res {rel:.4e}, |x - x_plain|/|x_plain| {dx:.3e}, {solve_s:.3f} s; routing "
            f"of the box sweeps: {kept}; launches {counts}")
        log("  history", [float(f"{h:.6e}") for h in res.history_list()])
        if (res.iters != it_p or rel > tol or not bool(torch.isfinite(res.x).all())
                or (dn == "float64" and dx > 1e-10)):
            fails.append(f"V(3,3) {dn} solve against the plain composition")
        # per cycle: the norm sweep (K1) and two more pre-sweeps, K3, K4 and two
        # post-sweeps; the pipelined loop runs one pre-smoother more than it
        # has cycles. Two sweeps are one K2 launch or two K1 launches.
        k2_want = 2 * res.iters + 1 if kept == "K2" else 0
        if counts["K2"] != k2_want or counts["K1"] < res.iters + 1:
            fails.append(f"V(3,3) {dn} launches {counts}: K2 != {k2_want}")
        if counts["K1 taps"] == 0:
            fails.append(f"V(3,3) {dn}: K1's tap-list route was never launched")

        def cycles(k):
            return struct_timed_cycles(hier, cfg, bt, k, device=device)

        xs, dev, kern, boxes = {}, {}, {}, {}
        for r, fuse in (("K2", True), ("K1 chain", False)):
            with sweep_routing(fuse):
                k2_before = read_counts()["K2"]
                xs[r] = cycles(5)
                k2_run = read_counts()["K2"] - k2_before
                busy, events, rows = device_per_cycle(cycles, 5, 10)
            dev[r] = busy
            # kernels only: the copies' rows carry the host's waits at the ends
            kern[r] = sum(ms for ms, _, name in rows if not name.startswith("Mem"))
            boxes[r] = sum(ms for ms, _, name in rows if "box_march" in name)
            log(f"V(3,3) {dn} {r} routing: device busy per cycle (torch.profiler, slope 5->10 "
                f"cycles) {busy:.4f} ms in {events:.1f} events, kernels {kern[r]:.4f} ms, of "
                f"which the box march {boxes[r]:.4f} ms; K2 launches in 5 cycles {k2_run}")
            for ms, n, name in rows[:6]:
                log(f"  {ms:.4f} ms/cycle  {n:5.1f} launches/cycle  {name[:100]}")
            if (k2_run == 0) == fuse:
                fails.append(f"V(3,3) {dn} {r} routing launched K2 {k2_run} times in 5 cycles")
        same = bool(torch.equal(xs["K2"], xs["K1 chain"]))
        faster = min(kern, key=kern.get)
        log(f"V(3,3) {dn} 5 cycles: K2 routing equal to the K1-chain routing bit for bit: "
            f"{same}; the port keeps the {kept} routing; the faster in kernel time here: {faster}")
        if not same:
            fails.append(f"V(3,3) {dn} K2 routing differs from the K1-chain routing")
        out[dn] = {"cycles": res.iters, "plain_cycles": it_p, "rel_res": rel, "dx": dx,
                   "counts": counts, "kept": kept, "device_ms_k2": dev["K2"] or None,
                   "device_ms_chain": dev["K1 chain"] or None, "kernel_ms_k2": kern["K2"],
                   "kernel_ms_chain": kern["K1 chain"], "box_ms_k2": boxes["K2"],
                   "box_ms_chain": boxes["K1 chain"]}

        def run(k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cycles(k)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        # the host clock, which the cycle waits on: ten pairs of turns, the
        # order alternating within the pairs
        host = {"K2": [], "K1 chain": []}
        for pair in range(10):
            order = ("K2", "K1 chain") if pair % 2 == 0 else ("K1 chain", "K2")
            for r in order:
                with sweep_routing(r == "K2"):
                    host[r].append(host_slope_ms(run, 5, 25)[0])
        wins = sum(a < c for a, c in zip(host["K2"], host["K1 chain"]))
        med = {r: float(np.median(v)) for r, v in host.items()}
        q = {r: np.percentile(v, [25, 75]) for r, v in host.items()}
        log(f"V(3,3) {dn} per-cycle time on the host clock (struct_timed_cycles slope 5->25, "
            f"10 pairs): K2 routing median {med['K2']:.4f} ms (quartiles {q['K2'][0]:.4f}-"
            f"{q['K2'][1]:.4f}), K1 chain median {med['K1 chain']:.4f} ms (quartiles "
            f"{q['K1 chain'][0]:.4f}-{q['K1 chain'][1]:.4f}); K2 faster in {wins} of 10 pairs")
        out[dn].update({"host_ms_k2": med["K2"], "host_ms_chain": med["K1 chain"],
                        "host_k2_wins": wins})
    return out, fails


def k2_timing(device):
    """K2 in the V(3,3) path's modes at 126^3 and at the JAX bench's
    headline shape 190^3, float32, each beside the chain of K1 launches that
    does the same sweeps."""
    import torch

    from amg_tpu_torch.ops.stencil import stencil_kernel_padded, sweepk_plain, taps_of

    w, off = box27()
    taps = taps_of(w, off)
    rng = np.random.default_rng(SEED + 3)
    out = {}
    for gs, mode in (((N_SIDE,) * 3, "sweep2_vec"), ((N_SIDE,) * 3, "sweep3_vec"),
                     ((190,) * 3, "sweep2_vec"), ((190,) * 3, "sweep3")):
        k, vec = int(mode[5]), mode.endswith("_vec")
        sets = [tuple(rand_pad(rng, gs, torch.float32, device) for _ in range(3)) for _ in range(3)]
        alpha = 1.0 / 52.0

        def kern(i):
            u, b, s = sets[i % 3]
            return stencil_kernel_padded(u, b, w, gs, off, alpha=alpha,
                                         scale_pad=s if vec else None, mode=mode)

        def plain(i):
            u, b, s = sets[i % 3]
            return sweepk_plain(u, b, taps, gs, k, alpha, s if vec else None)

        state_bytes = sets[0][0].numel() * 4
        pts = int(np.prod(gs))
        nbytes = (4 if vec else 3) * state_bytes  # u, b (s) in; out
        flops = k * (2 * 27 + 3) * pts
        r = dict(ms=cuda_time(kern, 30), plain_ms=cuda_time(plain, 5), library_ms=None,
                 bytes=nbytes, flops=flops)
        def chain(i):
            u, b, s = sets[i % 3]
            for _ in range(k):
                u = stencil_kernel_padded(u, b, w, gs, off, alpha=alpha,
                                          scale_pad=s if vec else None,
                                          mode="sweep_vec" if vec else "sweep")
            return u

        r["chain_ms"] = cuda_time(chain, 30)
        log(f"  {k} chained K1 box {'sweep_vec' if vec else 'sweep'} launches at {gs} float32: "
            f"{r['chain_ms']:.4f} ms")
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        log(f"K2 {mode} at {gs} float32: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library null (no one PyTorch call runs {k} Jacobi sweeps), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.2f} GFLOP)")
        out[f"{mode} {gs[0]}"] = r
    return out


def dia_operator(vs, dtype, device):
    """The DiaKernelOperator of a CPU float64 VarStencilOperator on the card."""
    from amg_tpu_torch.setup.structured import DiaKernelOperator, VarStencilOperator

    return DiaKernelOperator.from_var_stencil(VarStencilOperator(
        coeffs=vs.coeffs.to(device=device, dtype=dtype), offsets=vs.offsets,
        grid_shape=vs.grid_shape))


def k5_phase(device, operators):
    """K5 against its plain version on the elasticity operators, and timed
    beside its byte bound, its plain version and the cuSPARSE CSR matvec."""
    import torch

    from amg_tpu_torch.ops.var_stencil import (
        MODES,
        var_from_padded,
        var_stencil_kernel_padded,
        var_stencil_plain,
        var_to_padded,
    )

    errs, fails, timings = [], [], {}
    rng = np.random.default_rng(SEED + 4)
    for name, (prob, vs) in operators.items():
        gs = vs.grid_shape
        n = prob.n
        l1 = np.abs(prob.A.to_scipy()).sum(axis=1).A1
        csr = prob.A.to_scipy()
        for dtype in (torch.float32, torch.float64):
            dn = str(dtype).split(".")[-1]
            op = dia_operator(vs, dtype, device)
            h, c = op.halos, op.coeffs

            def pad(v):
                return var_to_padded(torch.from_numpy(v).to(device=device, dtype=dtype), gs, h)

            sets = [(pad(rng.random(n)), pad(rng.random(n))) for _ in range(3)]
            s = pad(1.0 / l1)
            u, b = sets[0]
            Z, Y, X = gs
            for mode in MODES:
                got = var_stencil_kernel_padded(u, c, op.offsets, gs, b_pad=b, scale_pad=s, mode=mode)
                want = var_stencil_plain(u, c, op.offsets, gs, b, s if mode == "sweep" else None, mode)
                gi = var_from_padded(got, gs, h).double()
                wi = var_from_padded(want, gs, h).double()
                abs_err = float((gi - wi).abs().max())
                rel = abs_err / max(float(wi.abs().max()), 1e-300)
                shell = got.clone()
                shell[h[0]:h[0] + Z, h[1]:h[1] + Y, h[2]:h[2] + X] = 0
                shell_ok = bool(torch.count_nonzero(shell) == 0)
                exact = bool(torch.equal(got, want))
                ok = rel <= TOL[dn] and shell_ok and bool(torch.isfinite(gi).all())
                errs.append((f"K5 {mode} {name}", dn, abs_err, rel, ok))
                log(f"  K5 {mode:8s} {name} {gs} {dn} rel {rel:.3e} abs {abs_err:.3e} "
                    f"shell0 {shell_ok} bit-equal {exact} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fails.append(f"K5 {mode} {name} {dn}")
            # timing: three input sets cycled; the coefficient planes alone
            # exceed the 50 MB L2 in float32 at both sizes. The bound counts
            # the planes (m x the interior points, all of which the kernel
            # reads) and the padded vectors (read or written whole)
            vec_bytes = u.numel() * u.element_size()
            pts, m = n, len(op.offsets)
            peak = F32_FLOPS if dtype == torch.float32 else F64_FLOPS
            lib_A = torch.sparse_csr_tensor(
                torch.from_numpy(csr.indptr.astype(np.int64)),
                torch.from_numpy(csr.indices.astype(np.int64)),
                torch.from_numpy(csr.data), size=csr.shape,
            ).to(device=device, dtype=dtype)
            xs = [torch.from_numpy(rng.random(n)).to(device=device, dtype=dtype) for _ in range(3)]
            for mode in MODES:
                nvec = {"spmv": 2, "residual": 3, "sweep": 4}[mode]
                nbytes = c.numel() * c.element_size() + nvec * vec_bytes
                flops = 2 * m * pts + {"spmv": 0, "residual": 1, "sweep": 3}[mode] * pts
                sa = s if mode == "sweep" else None

                def kern(i, mode=mode, sa=sa):
                    uu, bb = sets[i % 3]
                    return var_stencil_kernel_padded(uu, c, op.offsets, gs, b_pad=bb,
                                                     scale_pad=sa, mode=mode)

                def plain(i, mode=mode, sa=sa):
                    uu, bb = sets[i % 3]
                    return var_stencil_plain(uu, c, op.offsets, gs, bb, sa, mode)

                r = dict(ms=cuda_time(kern, 20), plain_ms=cuda_time(plain, 3),
                         library_ms=None, bytes=nbytes, flops=flops)
                if mode == "spmv":
                    r["library_ms"] = cuda_time(lambda i: lib_A @ xs[i % 3], 20)
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
                r["bound_ms"] = max(t_bytes, t_ops)
                r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
                log(f"K5 {mode} {name} {gs} {dn}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                    f"library (cuSPARSE CSR matvec) {lib} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}, {nbytes / 1e6:.1f} MB, m={m}, padded vectors "
                    f"{tuple(u.shape)})")
                timings[(mode, name, dn)] = r
            # the sweep with bf16 planes (the smoother's narrow stream,
            # DiaKernelOperator.with_sweep_dtype), widened to the state's dtype:
            # against its plain version, and timed
            cb = c.to(torch.bfloat16)
            got = var_stencil_kernel_padded(u, cb, op.offsets, gs, b_pad=b, scale_pad=s,
                                            mode="sweep")
            want = var_stencil_plain(u, cb, op.offsets, gs, b, s, "sweep")
            gi = var_from_padded(got, gs, h).double()
            wi = var_from_padded(want, gs, h).double()
            abs_err = float((gi - wi).abs().max())
            rel = abs_err / max(float(wi.abs().max()), 1e-300)
            ok = rel <= TOL[dn] and bool(torch.isfinite(gi).all())
            errs.append((f"K5 bf16 sweep {name}", dn, abs_err, rel, ok))
            log(f"  K5 sweep bf16 planes {name} {gs} {dn} rel {rel:.3e} abs {abs_err:.3e} "
                f"bit-equal {bool(torch.equal(got, want))} {'ok' if ok else 'FAIL'}")
            if not ok:
                fails.append(f"K5 bf16 sweep {name} {dn}")
            nbytes = cb.numel() * cb.element_size() + 4 * vec_bytes
            flops = 2 * m * pts + 3 * pts
            r = dict(
                ms=cuda_time(lambda i: var_stencil_kernel_padded(
                    sets[i % 3][0], cb, op.offsets, gs, b_pad=sets[i % 3][1], scale_pad=s,
                    mode="sweep"), 20),
                plain_ms=cuda_time(lambda i: var_stencil_plain(
                    sets[i % 3][0], cb, op.offsets, gs, sets[i % 3][1], s, "sweep"), 3),
                library_ms=None, bytes=nbytes, flops=flops)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
            r["bound_ms"] = max(t_bytes, t_ops)
            r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            log(f"K5 sweep bf16 planes {name} {gs} {dn}: {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library null (no PyTorch call computes this "
                f"mixed-dtype sweep), bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{nbytes / 1e6:.1f} MB); the same sweep on {dn} planes "
                f"{timings[('sweep', name, dn)]['ms']:.4f} ms")
            timings[("sweep bf16", name, dn)] = r
            del op, c, cb, lib_A
    torch.cuda.synchronize()
    return errs, fails, timings


def profile_device_ms(fn):
    """(device ms, events, rows (ms, count, name) by time) of one call of fn
    under torch.profiler: kernel and memory events only (a CPU op's device
    time repeats its kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), sum(r[1] for r in rows), rows


def plain_dia_hierarchy(hier):
    """The same hierarchy with every DIA operator applying K5's plain version
    (the plain composition of the elasticity path)."""
    import dataclasses

    from amg_tpu_torch.ops.var_stencil import var_stencil_plain
    from amg_tpu_torch.setup.hierarchy import Hierarchy
    from amg_tpu_torch.setup.structured import DiaKernelOperator

    class PlainDia(DiaKernelOperator):
        def _apply(self, u_pad, b_pad=None, scale_pad=None, mode="spmv", coeffs=None):
            return var_stencil_plain(u_pad, self.coeffs if coeffs is None else coeffs,
                                     self.offsets, self.grid_shape, b_pad, scale_pad, mode)

    def plain(op):
        return PlainDia(**{f.name: getattr(op, f.name) for f in dataclasses.fields(op)})

    return Hierarchy(levels=tuple(lv._replace(A=plain(lv.A)) for lv in hier.levels),
                     coarse_Ainv=hier.coarse_Ainv), plain


def solve_profile(fn, iters):
    """(host ms, device busy ms, events, idle share, rows) per iteration of a
    solve: one run on the host clock, one under torch.profiler (after the
    caller's first run, which took the counts)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, events, rows = profile_device_ms(fn)
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
    k = max(iters, 1)
    return wall_ms / k, busy_ms / k, events / k, idle, rows


def log_profile(label, prof):
    host, busy, events, idle, rows = prof
    log(f"{label}: host clock {host:.4f} ms per iteration; device busy {busy:.4f} ms in "
        f"{events:.1f} kernel and copy events per iteration; idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    for ms, n, name in rows[:8]:
        log(f"  {ms:.4f} ms  {n:6d} launches  {name[:100]}")
    return {"host_ms": host, "device_busy_ms": busy, "events": events, "idle_share": idle}


def elasticity_phase(device, prob, vs, smoother_name="l1_jacobi", ref=None):
    """The 157k-dof elasticity solve: DIA hierarchy, V(2,2) with the given
    smoother under mixed_pcg, K5. With `ref` (the JAX package's run of the
    same solve), the level sizes must be its and the iterations within one of
    its (the Krylov state is double-single there, float64 here)."""
    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.setup.structured import build_dia_structured_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType, _block_solve
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
    from amg_tpu_torch.solve.mixed import mixed_pcg

    smoother = SmootherType(smoother_name)
    nodes = tuple(c + 1 for c in BEAM)
    t0 = time.perf_counter()
    hh, hier32 = build_dia_structured_hierarchy(prob.A, nodes, num_functions=3,
                                                dtype=torch.float32, smoother=smoother,
                                                device=device)
    A64 = dia_operator(vs, torch.float64, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = hh.stats()
    log(f"elasticity {BEAM} ({prob.n} dofs, {prob.A.indptr[-1]} nnz), {smoother_name}: setup "
        f"{setup_s:.2f} s (block inverses included); levels "
        f"{[(lv.A.grid_shape, len(lv.A.offsets)) for lv in hier32.levels]}, level_n {st['n']}, "
        f"coarsest {hier32.coarse_Ainv.shape[0]} dense")
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=smoother, num_pre_sweeps=2,
                      num_post_sweeps=2)
    b = prob.rhs / np.linalg.norm(prob.rhs)

    def solve(hier, A):
        return mixed_pcg(hier, A, cfg, b, tol=1e-5, max_cycles=60, device=device)

    # the path: counters reset just before, read just after
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solve(hier32, A64)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    x = res.x.cpu().numpy()
    true_rel = float(np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b))
    it = res.iters
    ref_txt = "" if ref is None else f" (reference {ref['iters']})"
    log(f"mixed_pcg float32 V(2,2) {smoother_name} preconditioner: iterations {it}{ref_txt}"
        f", rel_res {res.rel_resnorm:.4e}, true rel_res (float64 CSR) {true_rel:.4e}, solve "
        f"{solve_s:.3f} s, {solve_s / max(it, 1) * 1e3:.3f} ms/iteration; launches {counts}, K5 "
        f"per iteration {counts['K5'] / max(it, 1):.2f}")
    log("  history", [float(f"{v:.4e}") for v in res.history_list()])
    fails = []
    if not (true_rel <= 1e-5 and it <= 60 and np.isfinite(x).all()):
        fails.append(f"elasticity {smoother_name} mixed_pcg: true residual > 1e-5 or > 60 "
                     "iterations")
    if counts["K5"] == 0:
        fails.append(f"elasticity {smoother_name} path launched no K5")
    if ref is not None and (abs(it - ref["iters"]) > 1 or st["n"] != ref["level_n"]):
        fails.append(f"elasticity {smoother_name}: not the reference's levels or iterations +-1")
    rec = {"iters": it, "rel_res": res.rel_resnorm, "true_rel_res": true_rel,
           "setup_s": setup_s, "solve_s": solve_s, "counts": counts, "level_n": st["n"],
           "history": res.history_list()}
    prof = solve_profile(lambda: solve(hier32, A64), it)
    rec.update(log_profile(f"elasticity {smoother_name} solve", prof))
    if smoother in (SmootherType.HYBRID_JGS,):
        # the block solve (torch.bmm, no TPU kernel) against the bound of its
        # factor stream: the fine level's (nblocks, 128, 128) float32
        # inverses read once, r and the output once each
        inv = hier32.levels[0].sm.block_inv
        factor_bytes = sum(2 * lv.sm.block_inv.numel() * lv.sm.block_inv.element_size()
                           for lv in hier32.levels)
        rs = [torch.randn(prob.n, device=device) for _ in range(3)]
        bmm_ms = cuda_time(lambda i: _block_solve(inv, rs[i % 3]), 20)
        nbytes = inv.numel() * inv.element_size() + 2 * inv.shape[0] * inv.shape[1] * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"JGS block solve (torch.bmm) {tuple(inv.shape)} float32: {bmm_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({nbytes / 1e6:.1f} MB, bytes); both directions' float32 "
            f"factors on all levels {factor_bytes / 1e6:.1f} MB on the card")
        rec.update(bmm_ms=bmm_ms, bmm_bound_ms=bound, bmm_bytes=nbytes,
                   factor_bytes=factor_bytes)
    # float64 preconditioner against the plain composition
    hier64 = hierarchy_from_arrays(*hh.arrays, dtype=torch.float64, device=device)
    r64 = solve(hier64, A64)
    plain_hier, plain = plain_dia_hierarchy(hier64)
    rp = solve(plain_hier, plain(A64))
    dx = float(torch.linalg.norm(r64.x - rp.x) / torch.linalg.norm(rp.x))
    log(f"mixed_pcg float64 {smoother_name} preconditioner: iterations {r64.iters} (plain "
        f"composition {rp.iters}), rel_res {r64.rel_resnorm:.4e}, |x - x_plain|/|x_plain| "
        f"{dx:.3e}")
    if r64.iters != rp.iters or dx > 1e-10:
        fails.append(f"elasticity {smoother_name} float64 solve against the plain composition")
    rec.update(iters64=r64.iters, plain_iters64=rp.iters, dx64=dx)
    return rec, fails


def elasticity_bf16_phase(device, errs):
    """The elasticity solve of BEAM_BF16 with the smoother's coefficient
    planes streamed as bf16 (`build_dia_structured_hierarchy(sweep_coef_dtype=
    torch.bfloat16)`), float32 preconditioner: its float64 CSR residual and
    iterations against the reference's, and against the plain composition
    (K5's plain version in every operator, the same bf16 planes). First K5's
    bf16-plane sweep at each level's shape against its plain version
    (appended to `errs`)."""
    import torch

    from amg_tpu_torch.ops.var_stencil import (
        var_from_padded,
        var_stencil_kernel_padded,
        var_stencil_plain,
    )

    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.structured import (
        build_dia_structured_hierarchy,
        csr_to_dia_stencil,
    )
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
    from amg_tpu_torch.solve.mixed import mixed_pcg

    prob = elasticity_beam(*BEAM_BF16, bc="identity")
    vs = csr_to_dia_stencil(prob.A, prob.grid_shape)
    nodes = tuple(c + 1 for c in BEAM_BF16)
    t0 = time.perf_counter()
    _, hier = build_dia_structured_hierarchy(prob.A, nodes, num_functions=3, dtype=torch.float32,
                                             device=device, sweep_coef_dtype=torch.bfloat16)
    A64 = dia_operator(vs, torch.float64, device)
    torch.cuda.synchronize()
    log(f"elasticity {BEAM_BF16} ({prob.n} dofs), bf16 sweep planes: setup "
        f"{time.perf_counter() - t0:.2f} s; planes {[str(lv.A.coeffs_sweep.dtype) for lv in hier.levels]}")
    fails = []
    rng = np.random.default_rng(SEED + 6)
    for k, lv in enumerate(hier.levels):
        op, gs = lv.A, lv.A.grid_shape
        u, b_, s_ = (op._to_kernel(torch.from_numpy(rng.random(op.n_rows)).to(device,
                                                                               torch.float32))
                     for _ in range(3))
        got = var_stencil_kernel_padded(u, op.coeffs_sweep, op.offsets, gs, b_pad=b_,
                                        scale_pad=s_, mode="sweep")
        want = var_stencil_plain(u, op.coeffs_sweep, op.offsets, gs, b_, s_, "sweep")
        gi = var_from_padded(got, gs, op.halos).double()
        wi = var_from_padded(want, gs, op.halos).double()
        abs_err = float((gi - wi).abs().max())
        rel = abs_err / max(float(wi.abs().max()), 1e-300)
        ok = rel <= TOL["float32"] and bool(torch.isfinite(gi).all())
        errs.append((f"K5 bf16 sweep level {k}", "float32", abs_err, rel, ok))
        log(f"  K5 sweep bf16 planes level {k} {gs} float32 rel {rel:.3e} abs {abs_err:.3e} "
            f"bit-equal {bool(torch.equal(got, want))} {'ok' if ok else 'FAIL'}")
        if not ok:
            fails.append(f"K5 bf16 sweep level {k}")
    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI,
                      num_pre_sweeps=2, num_post_sweeps=2)
    b = prob.rhs / np.linalg.norm(prob.rhs)

    def solve(h, A):
        return mixed_pcg(h, A, cfg, b, tol=1e-5, max_cycles=60, device=device)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solve(hier, A64)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    x = res.x.cpu().numpy()
    true_rel = float(np.linalg.norm(b - prob.A @ x) / np.linalg.norm(b))
    it = res.iters
    log(f"mixed_pcg float32 V(2,2), bf16 sweep planes: iterations {it}, rel_res "
        f"{res.rel_resnorm:.4e}, true rel_res (float64 CSR) {true_rel:.4e}, solve {solve_s:.3f} s; "
        f"launches {counts}: K5 {counts['K5']}, of which sweeps on bf16 planes "
        f"{counts['K5 bf16']}")
    log("  history", [float(f"{v:.4e}") for v in res.history_list()])
    if not (true_rel <= 1e-5 and it <= 60 and np.isfinite(x).all()):
        fails.append("bf16 elasticity mixed_pcg: true residual > 1e-5 or > 60 iterations")
    if abs(it - BF16_REF_ITERS) > 1:
        fails.append(f"bf16 elasticity mixed_pcg: {it} iterations, the reference's "
                     f"{BF16_REF_ITERS}")
    if counts["K5 bf16"] == 0:
        fails.append("bf16 elasticity path launched no K5 sweep on bf16 planes")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2 = solve(hier, A64)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, events, rows = profile_device_ms(lambda: solve(hier, A64))
    idle = 1.0 - busy_ms / wall_ms if busy_ms > 0 else None
    log(f"bf16 elasticity solve again: {res2.iters} iterations, {wall_ms:.3f} ms "
        f"({wall_ms / max(res2.iters, 1):.3f} ms/iteration); device busy (torch.profiler, one "
        f"solve) {busy_ms:.3f} ms in {events} kernel and copy events; idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    for ms, n, name in rows[:6]:
        log(f"  {ms:.4f} ms  {n:6d} launches  {name[:100]}")
    plain_hier, plain = plain_dia_hierarchy(hier)
    rp = solve(plain_hier, plain(A64))
    dx = float(torch.linalg.norm(res.x - rp.x) / torch.linalg.norm(rp.x))
    exact = bool(torch.equal(res.x, rp.x))
    log(f"bf16 elasticity against the plain composition: iterations {it} (plain {rp.iters}), "
        f"|x - x_plain|/|x_plain| {dx:.3e}, bit-equal {exact}")
    if rp.iters != it or dx > 1e-6:
        fails.append("bf16 elasticity solve against the plain composition")
    return {"beam": BEAM_BF16, "n": prob.n, "iters": it, "ref_iters": BF16_REF_ITERS,
            "true_rel_res": true_rel,
            "solve_s": solve_s, "wall_ms": wall_ms,
            "ms_per_iter": wall_ms / max(res2.iters, 1), "device_busy_ms": busy_ms or None,
            "idle_share": idle, "counts": counts, "plain_iters": rp.iters, "dx": dx,
            "bit_equal": exact}, fails


# the generic (algebraic) path: the 27-point Laplacian at GENERIC_N^3
# (884,736 dofs) through build_hierarchy with the default HierarchyParams
# (native HMIS, ext+i, p_max_elmts 4, L1-Jacobi, float64, the stencil on level
# 0) and driver.solve; its hybrid JGS, Chebyshev and PCG solves at 48^3
# (golden config9's size). GENERIC_REF holds the JAX package's own results
# for the same inputs on the CPU in float64
# (`JAX_PLATFORMS=cpu python3 tools/torch_generic_reference.py`).
# the JAX package's own runs of the slice-9 paths on the CPU in float64, with
# the async AMS solve's draws (`JAX_PLATFORMS=cpu python3
# tools/torch_elasticity_reference.py`)
ELAST_REF = "tools/torch_elasticity_reference.json"
SA_BEAM = BEAM  # bc "reduce": 155,952 dofs, the rigid-body modes as candidates
MAXWELL_N = 40  # maxwell_curlcurl(40): 182,520 edges
AMS_ASYNC_N = 8  # the async AMS replay's mesh
GOLDEN_DIA = ("config10_elasticity_dia_mixed", "config11_elasticity_jgs_mixed")


def load_json(rel):
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), rel)) as f:
        return json.load(f)


def golden_dia_phase(device):
    """Goldens config10 and config11 (the 49,179-dof beam, float32 DIA
    hierarchy, L1-Jacobi and hybrid JGS, under mixed_pcg) on the card,
    through the port's runner (`setup_experiment` / `solve_experiment`, the
    two halves of `run_experiment`) on the golden's options. Their float32
    histories moved on the reference itself across XLA builds (ROADMAP F1):
    held by level_n and level_nnz, the iterations within one, a true float64
    residual <= 1e-5 and history[:5] to rtol 0.1."""
    import torch

    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import setup_experiment, solve_experiment

    rec, fails = {}, []
    for name in GOLDEN_DIA:
        g = load_json(f"tests/golden/{name}.json")
        c = g["config"]
        torch.cuda.synchronize()
        reset_counts()
        exp = setup_experiment(SolverOptions(**c), device)
        st = solve_experiment(exp)
        counts = read_counts()
        prob = elasticity_beam(nx=c["nx"], ny=c["ny"], nz=c["nz"], bc=c["elast_bc"])
        b = prob.rhs / np.linalg.norm(prob.rhs)
        x = st.x.cpu().numpy()
        true_rel = true_rel_residual(prob, x, b)
        h = st.history
        dev = float(np.max(np.abs(np.asarray(h[:5]) - g["history"][:5]) / np.asarray(g["history"][:5])))
        log(f"{name} ({st.n} dofs, {st.smoother}) through the runner: setup {st.setup_wtime:.2f} "
            f"s, level_n {st.level_n} (golden {g['level_n']}), iterations {st.cycles} (golden "
            f"{g['cycles']}), true rel_res {true_rel:.4e}, history[:5] max rel deviation "
            f"{dev:.3e}; launches {counts}")
        r = {"iters": st.cycles, "golden_iters": g["cycles"], "true_rel_res": true_rel,
             "history_head_dev": dev, "setup_s": st.setup_wtime, "counts": counts}
        r.update(log_profile(f"{name} solve", solve_profile(lambda: solve_experiment(exp),
                                                            st.cycles)))
        rec[name] = r
        if st.level_n != g["level_n"] or st.level_nnz != g["level_nnz"]:
            fails.append(f"{name}: level_n / level_nnz differ from the golden's")
        if abs(st.cycles - g["cycles"]) > 1 or not true_rel <= 1e-5 or dev > 0.1 \
                or counts["K5"] == 0:
            fails.append(f"{name}: iterations, true residual, history[:5] or K5 launches")
        del exp, st
    return rec, fails


def ell_peak_mb(m, x):
    """Peak device memory (MB) one ELL spmv allocates above what is live: its
    output alone (n values), since the ELL kernel writes no (n, k)
    temporary."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y = m @ x
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del y
    return peak / 1e6


def sa_phase(device, ref):
    """SA-PCG at full size (golden config8's recipe): the level sizes and nnz
    and the float64 iterations the reference's, rel_res <= 1e-8 and a true
    residual within 5% of the reference's own (PCG's recursive residual
    drifts from the true one on this beam: the reference's x has 1.12e-8).
    Plain float32 PCG does not converge on this beam, in the reference
    either (kappa * eps_f32 > 1); the float32 hierarchy runs as mixed_pcg's
    preconditioner instead (float64 state and operator), to a true residual
    <= 1e-8 within 200 iterations."""
    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import solve
    from amg_tpu_torch.solve.mixed import mixed_pcg

    fails = []
    prob = elasticity_beam(*SA_BEAM)
    t0 = time.perf_counter()
    hh, hier64 = build_hierarchy(prob.A, HierarchyParams(num_functions=3, setup_type="sa"),
                                 near_nullspace=prob.near_nullspace, device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = hh.stats()
    log(f"SA elasticity_beam{SA_BEAM} ({prob.n} dofs): setup {setup_s:.2f} s, level_n {st['n']} "
        f"(reference {ref['level_n']}), level_nnz {st['nnz']}, operator complexity "
        f"{st['operator_complexity']:.4f}; ELL widths "
        f"{[(lv.A.k, None if lv.P is None else lv.P.k, None if lv.R is None else lv.R.k) for lv in hier64.levels]}")
    if st["n"] != ref["level_n"] or st["nnz"] != ref["level_nnz"]:
        fails.append("SA hierarchy differs from the reference's")
    b_np = prob.rhs / np.linalg.norm(prob.rhs)
    b64 = torch.from_numpy(b_np).to(device)
    cfg = CycleConfig()

    def run(hier, b, tol, max_cycles=200):
        return solve(hier, cfg, b, tol=tol, max_cycles=max_cycles, outer="pcg", device=device)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = run(hier64, b64, 1e-8)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    true_rel = true_rel_residual(prob, res.x.cpu().numpy(), b_np)
    log(f"SA-PCG float64 V(1,1) L1-Jacobi: iterations {res.iters} (reference {ref['iters']}), "
        f"rel_res {float(res.rel_resnorm):.4e}, true rel_res {true_rel:.4e}, {solve_s:.3f} s; "
        f"launches {counts}")
    log(f"  the reference's true rel_res {ref['true_rel_res']:.4e}")
    every_ell_product_launched("SA-PCG float64", counts, fails)
    rec = {"level_n": st["n"], "setup_s": setup_s, "iters64": res.iters,
           "true_rel_res64": true_rel, "solve64_s": solve_s, "counts": counts}
    if res.iters != ref["iters"] or not float(res.rel_resnorm) <= 1e-8 \
            or not true_rel <= 1.05 * ref["true_rel_res"]:
        fails.append("SA-PCG float64: not the reference's iterations or true residual")
    rec.update(log_profile("SA-PCG float64", solve_profile(lambda: run(hier64, b64, 1e-8),
                                                           res.iters)))
    hier32 = hierarchy_from_arrays(*hh.arrays, dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    res32 = mixed_pcg(hier32, hier64.levels[0].A, cfg, b_np, tol=1e-8, max_cycles=200,
                      device=device)
    torch.cuda.synchronize()
    s32 = time.perf_counter() - t0
    true32 = true_rel_residual(prob, res32.x.cpu().numpy(), b_np)
    log(f"SA float32 hierarchy under mixed_pcg (float64 state and operator): iterations "
        f"{res32.iters}, true rel_res {true32:.4e}, {s32:.3f} s; plain float32 PCG in the "
        f"reference: {ref['f32_pcg']['iters']} iterations to rel_res "
        f"{ref['f32_pcg']['rel_res']:.3e}")
    rec.update(iters32_mixed=res32.iters, true_rel_res32_mixed=true32, solve32_mixed_s=s32)
    if not (true32 <= 1e-8 and res32.iters <= 200):
        fails.append("SA float32 hierarchy under mixed_pcg: true residual > 1e-8")
    x = torch.rand(prob.n, dtype=torch.float64, device=device)
    l0 = hier64.levels[0]
    peaks = {"A0": ell_peak_mb(l0.A, x), "R0": ell_peak_mb(l0.R, x),
             "P0": ell_peak_mb(l0.P, l0.R @ x)}
    log(f"SA ELL spmv, float64, peak MB above the live set (the output): {peaks}")
    rec["ell_peak_mb"] = peaks
    del hier32, hier64, x, l0
    torch.cuda.empty_cache()
    # the ELL kernel on the beam's level-0 operator and transfers
    rng = np.random.default_rng(SEED + 14)
    spmv = {}
    for field in ("A", "P", "R"):
        spmv.update(spmv_timing(f"SA beam level 0 {field}", getattr(hh.levels[0], field), device,
                                rng, fails, bsr=False))
    rec["spmv"] = {f"{k[0]} {k[1]}": v for k, v in spmv.items()}
    return rec, fails


class RecordedAMSDraws:
    """The async AMS solve's draws as the reference consumed them, step by
    step."""

    def __init__(self, draws):
        self.fire, self.cols, self.k = draws["fire"], draws["cols"], 0

    def step(self, Lg):
        if self.k >= len(self.fire):
            raise RuntimeError("the replay ran past the reference's recorded steps")
        f, c = np.asarray(self.fire[self.k]), np.asarray(self.cols[self.k])
        self.k += 1
        assert f.shape == (Lg,)
        return f, c


def ams_phase(device, ref):
    """AMS-PCG on the curl-curl problem at MAXWELL_N in float64: the nodal
    and Pi hierarchies' level sizes and the iterations the reference's, true
    residual <= 1e-8; the async additive AMS solve at AMS_ASYNC_N on the
    reference's recorded draws: its steps and history (rtol 1e-8)."""
    import torch

    from amg_tpu_torch.convert import matrix_from_arrays
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, _format_converter
    from amg_tpu_torch.solve.ams import (
        ams_async_additive_solve,
        async_ams_eigs,
        build_ams,
        solve_ams_pcg,
    )

    fails = []
    prob = maxwell_curlcurl(MAXWELL_N)
    t0 = time.perf_counter()
    ams, cfg = build_ams(prob.A, prob.aux["G"], Pi=prob.aux["Pi"], device=device)
    A = matrix_from_arrays(_format_converter(HierarchyParams())(prob.A), torch.float64, device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    node_n = [lv.A.shape[0] for lv in ams.node_hier.levels]
    pi_n = [lv.A.shape[0] for lv in ams.pi_hier.levels]
    log(f"AMS maxwell_curlcurl({MAXWELL_N}) ({prob.n} edges): setup {setup_s:.2f} s, node "
        f"levels {node_n} (reference {ref['node_level_n']}), Pi levels {pi_n} (reference "
        f"{ref['pi_level_n']})")
    if node_n != ref["node_level_n"] or pi_n != ref["pi_level_n"]:
        fails.append("AMS hierarchies differ from the reference's")
    b_np = np.random.default_rng(0).random(prob.n)
    b = torch.from_numpy(b_np).to(device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solve_ams_pcg(A, ams, cfg, b, tol=1e-8, max_iters=200, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    true_rel = true_rel_residual(prob, res.x.cpu().numpy(), b_np)
    log(f"AMS-PCG float64: iterations {res.iters} (reference {ref['iters']}), rel_res "
        f"{float(res.rel_resnorm):.4e}, true rel_res {true_rel:.4e}, {solve_s:.3f} s; "
        f"launches {counts}")
    rec = {"node_level_n": node_n, "pi_level_n": pi_n, "setup_s": setup_s,
           "iters": res.iters, "true_rel_res": true_rel, "solve_s": solve_s}
    if res.iters != ref["iters"] or not true_rel <= 1e-8:
        fails.append("AMS-PCG: not the reference's iterations or true residual > 1e-8")
    rec.update(log_profile("AMS-PCG float64", solve_profile(
        lambda: solve_ams_pcg(A, ams, cfg, b, tol=1e-8, max_iters=200, device=device),
        res.iters)))
    del ams, A

    aref = ref["async_n8"]
    p8 = maxwell_curlcurl(AMS_ASYNC_N)
    ams8, _ = build_ams(p8.A, p8.aux["G"], Pi=p8.aux["Pi"], device=device)
    A8 = matrix_from_arrays(_format_converter(HierarchyParams())(p8.A), torch.float64, device)
    co = async_ams_eigs(A8, ams8)
    omega = 0.7 * 2.0 / (co.alpha + co.beta)
    b8 = p8.rhs / np.linalg.norm(p8.rhs)
    t0 = time.perf_counter()
    ares = ams_async_additive_solve(A8, ams8, b8, draws=RecordedAMSDraws(aref["draws"]),
                                    fire_prob=0.8, sim_read_delay=2, tol=1e-8, max_cycles=600,
                                    device=device)
    torch.cuda.synchronize()
    async_s = time.perf_counter() - t0
    h = np.asarray(ares.history_list())
    ok_hist = h.shape == (len(aref["history"]),) and np.allclose(
        h, aref["history"], rtol=1e-8, atol=1e-14)
    log(f"async AMS maxwell_curlcurl({AMS_ASYNC_N}), the reference's draws: {ares.iters} steps "
        f"(reference {aref['iters']}), rel_res {float(ares.rel_resnorm):.4e}, omega {omega:.12f} "
        f"(reference {aref['omega']:.12f}), history {'equal' if ok_hist else 'DIFFERS'} "
        f"(rtol 1e-8), {async_s:.3f} s ({async_s / max(ares.iters, 1) * 1e3:.3f} ms per step)")
    rec["async"] = {"iters": ares.iters, "omega": omega, "ref_omega": aref["omega"],
                    "history_equal": ok_hist, "s": async_s}
    if ares.iters != aref["iters"] or not ok_hist:
        fails.append("async AMS replay: not the reference's steps or history")
    return rec, fails


GENERIC_N = 96
GENERIC_SIDE = 48
GENERIC_REF = {
    "96": {
        "level_n": [884736, 110592, 27719, 6436, 891, 201, 39],
        "level_nnz": [23393656, 7598160, 3643775, 1029788, 121629, 19979, 1257],
        "iters": 41,
        "history": [1.0, 1.265019076876827, 0.6926628905678609,
                    0.3631215331591324, 0.19504097144476074],
    },
    "48 hybrid_jgs": {"iters": 21},
    "48 jacobi cheby": {"iters": 14},
    "48 l1_jacobi pcg": {"iters": 12},
}
BEAM_SPMV = (48, 12, 12)  # the JAX bench's aux_bsr matrix: 24,336 dofs


def spmv_timing(name, csr, device, rng, fails, bsr=True):
    """ELL, BSR (at choose_bsr_shape's tile, where `bsr`) and the cuSPARSE CSR
    matvec of one matrix, CUDA events over 50 calls after a spin kernel,
    float32 and float64, beside the byte bound of y = A x (the CSR values,
    column indices and row pointers, x and y, each once, at HBM_BYTES_PER_S)
    and the ELL slot bound (every padded slot's value and int32 index, x and
    y). The ELL product is the ELL kernel (`ops/ell.py::ell_spmv_kernel`, at
    `lanes_for(k)` lanes a row), timed beside its plain version
    (`ell_spmv_plain`) and held to it at k eps max_i sum_j |a_ij x_j|, with
    equal bits over two launches: a miss is appended to `fails`."""
    import torch

    from amg_tpu_torch.ops.ell import ell_spmv_plain, lanes_for
    from amg_tpu_torch.sparse.bsr import bsr_from_csr, choose_bsr_shape
    from amg_tpu_torch.sparse.ell import ell_from_csr

    tile = choose_bsr_shape(csr)[0] if bsr else None
    n, m = csr.shape
    rows = {}
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        item = torch.finfo(dtype).bits // 8
        xs = [torch.from_numpy(rng.random(m)).to(device=device, dtype=dtype) for _ in range(4)]
        ell = ell_from_csr(csr, dtype=dtype, device=device)
        bmat = (bsr_from_csr(csr, bm=tile[0], bn=tile[1], dtype=dtype, device=device)
                if tile else None)
        lib = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int64)),
            torch.from_numpy(csr.indices.astype(np.int64)),
            torch.from_numpy(csr.data), size=csr.shape,
        ).to(device=device, dtype=dtype)
        want = (lib @ xs[0]).double()
        errs = {}
        for key, mat in (("ell", ell), ("bsr", bmat)):
            if mat is not None:
                errs[key] = float(((mat @ xs[0]).double() - want).abs().max() / want.abs().max())
        got, again = ell @ xs[0], ell @ xs[0]
        plain = ell_spmv_plain(ell.cols, ell.vals, xs[0])
        scale = float(ell_spmv_plain(ell.cols, ell.vals.abs(), xs[0].abs()).max())
        tol = max(ell.k, 1) * torch.finfo(dtype).eps * scale
        err = float((got - plain).abs().max())
        same = bool(torch.equal(got, again))
        if not (err <= tol and same):
            fails.append(f"ELL kernel on {name} {dn}: |kernel - plain| {err:.3e} > {tol:.3e} "
                         f"or not the same bits over two launches ({same})")
        bytes_ = csr.nnz * (item + 4) + (n + 1) * 4 + (m + n) * item
        slot_bytes = n * ell.k * (item + 4) + (m + n) * item
        r = {
            "ell_ms": cuda_time(lambda i: ell @ xs[i % 4], 50),
            "ell_plain_ms": cuda_time(lambda i: ell_spmv_plain(ell.cols, ell.vals, xs[i % 4]), 50),
            "bsr_ms": cuda_time(lambda i: bmat @ xs[i % 4], 50) if bmat is not None else None,
            "cusparse_ms": cuda_time(lambda i: lib @ xs[i % 4], 50),
            "bound_ms": bytes_ / HBM_BYTES_PER_S * 1e3, "bytes": bytes_,
            "ell_slot_bound_ms": slot_bytes / HBM_BYTES_PER_S * 1e3,
            "ell_k": ell.k, "ell_lanes": lanes_for(ell.k), "ell_err_vs_plain": err,
            "ell_scale": scale, "ell_tol": tol, "ell_pass": err <= tol and same, "bsr_tile": tile,
            "bsr_kb": bmat.kb if bmat is not None else None, "rel_err_vs_cusparse": errs,
        }
        rows[(name, dn)] = r
        log(f"  spmv {name} ({n}x{m}, {csr.nnz} nnz) {dn}: ELL kernel (k {ell.k}, "
            f"{r['ell_lanes']} lanes) {r['ell_ms']:.4f} ms, plain {r['ell_plain_ms']:.4f} ms, "
            f"|kernel - plain| {err:.3e} (limit {tol:.3e}), bits equal over two launches "
            f"{same}; BSR {tile} (kb {r['bsr_kb']}) "
            f"{r['bsr_ms'] if r['bsr_ms'] is None else round(r['bsr_ms'], 4)} ms, "
            f"cuSPARSE CSR {r['cusparse_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({bytes_ / 1e6:.1f} MB), ELL slot bound {r['ell_slot_bound_ms']:.4f} ms; "
            f"rel err vs cuSPARSE {errs}")
        del ell, bmat, lib
    return rows


# the additive and asynchronous solvers on the generic hierarchy: the JAX
# package's own results on the CPU in float64, and the draws of its SEMI,
# async_smooth and extended-system runs
# (`JAX_PLATFORMS=cpu python3 tools/torch_async_reference.py`)
ASYNC_REF = "tools/torch_async_reference.json"


def async_options(hier, cfg, cheby_setup, async_type="full", sim_read_delay=4,
                  accel="richardson", comm_every=1, cheby_grid=0, **kw):
    """The AsyncConfig keywords that the port's runner derives for an async
    additive solve (`amg_tpu_torch/utils/runner.py::async_accel_options`),
    from cheby_setup(num_iters=20) on the MULTADD cfg."""
    from amg_tpu_torch.utils.runner import async_accel_options

    kw = dict(kw, async_type=async_type, sim_read_delay=sim_read_delay, comm_every=comm_every)
    if accel not in ("cheby", "richardson"):
        return kw
    coeffs = cheby_setup(hier, cfg, num_iters=20)
    return dict(kw, **async_accel_options(coeffs, accel, async_type, sim_read_delay,
                                          comm_every, cheby_grid))


class RecordedAsyncDraws:
    """async_solve's draws of one SEMI run of the JAX package, replayed (the
    DrawSource protocol of amg_tpu_torch/solve/async_sim.py)."""

    def __init__(self, rec):
        self.rec, self.i = rec, -1

    def wait_uniforms(self, L):
        raise RuntimeError("no wait-counter draws are recorded")

    def step(self, L):
        self.i += 1
        return np.array(self.rec["fire"][self.i]), np.array(self.rec["perm"][self.i])

    def read_scalar(self, lvl):
        return self.rec["reads"][self.i][lvl]

    def read_rows(self, lvl, n, dtype, device):
        raise RuntimeError("no FULL-mode draws are recorded")


class RecordedSmoothDraws:
    """async_smooth_solve's (B,) firing uniforms of the JAX package's run."""

    def __init__(self, rec):
        self.rec, self.i = rec, -1

    def step(self, B, dtype, device):
        import torch

        self.i += 1
        return torch.tensor(self.rec[self.i], dtype=dtype, device=device)


class RecordedExtDraws:
    """ext_solve's (L,) firing and read uniforms of the JAX package's run."""

    def __init__(self, rec):
        self.rec, self.i = rec, -1

    def step(self, L):
        self.i += 1
        return np.array(self.rec["fire"][self.i]), np.array(self.rec["read"][self.i])


def additive_cfg(name):
    """The CLI defaults of each additive solver: L1-Jacobi, smoothed
    transfers for multadd and mult_multadd."""
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType

    return CycleConfig(cycle=CycleType(name),
                       use_smoothed_transfers=name in ("multadd", "mult_multadd"))


def ell_bytes(m):
    return m.vals.nbytes + m.cols.nbytes


def async_timing(hier, cfg, acfg, b, device, k0=10, k1=30):
    """Host clock per async step (best-of-3 slope between k0 and k1 steps,
    tol 0: every step runs, with its one host read), and the device's busy
    time, events and rows per step (profiled slope between k0 and k0 + 10).
    Every run draws from GeneratorDraws(0), so the runs share their first
    steps."""
    import torch

    from amg_tpu_torch.solve.async_sim import async_solve

    def solve_k(k):
        return async_solve(hier, cfg, acfg, b, seed=0, tol=0.0, max_cycles=k, device=device)

    def run(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve_k(k)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    host_ms, s0, s1 = host_slope_ms(run, k0, k1)
    busy, events, rows = device_per_cycle(solve_k, k0, k0 + 10)
    return {"host_ms_per_step": host_ms, "device_busy_ms_per_step": busy,
            "events_per_step": events,
            "idle_share": 1.0 - busy / host_ms if host_ms > 0 else None,
            "samples_s": [s0, s1], "rows": [(ms, nev, name[:100]) for ms, nev, name in rows[:8]]}


def additive_phase_96(prob, hh, hier64, hier32, b_np, ref, device, keep=None):
    """The additive and async solvers on the generic phase's 96^3
    hierarchy: sync MULTADD under Chebyshev at the reference's count and
    history, async_multadd FULL Richardson on the port's own generators in
    the reference's corridor; their timings. Returns (record, failures);
    puts the float64 hierarchy, the async run's cfg / acfg, steps, x and
    per-step times into `keep` (phase 19's single-device baseline)."""
    import torch

    from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
    from amg_tpu_torch.solve.driver import cheby_setup, solve

    fails, rec = [], {}
    new_b = {name: sum(ell_bytes(getattr(lv, name)) for lv in hier64.levels
                       if getattr(lv, name) is not None)
             for name in ("P", "R", "P_s", "R_s", "P_id", "R_id")}
    n, L = prob.n, hier64.num_levels
    state_b = {"ring (W = 5)": 5 * n * 8, "FULL last reads (int32)": L * n * 4}
    log(f"additive {GENERIC_N}^3: device bytes of the transfers (float64 ELL) "
        f"{ {k: round(v / 1e6, 2) for k, v in new_b.items()} } MB; async state "
        f"{ {k: round(v / 1e6, 2) for k, v in state_b.items()} } MB")
    rec.update(transfer_bytes=new_b, async_state_bytes=state_b)

    cfg = additive_cfg("multadd")
    b64 = torch.from_numpy(b_np).to(device)
    t0 = time.perf_counter()
    coeffs = cheby_setup(hier64, cfg, num_iters=20, device=device)
    torch.cuda.synchronize()
    cheby_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res = solve(hier64, cfg, b64, tol=1e-8, max_cycles=200, accel="cheby", cheby_coeffs=coeffs,
                device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    hist = res.history_list()
    true_rel = true_rel_residual(prob, res.x.cpu().numpy(), b_np)
    want = ref["96"]["multadd"]
    log(f"additive {GENERIC_N}^3 sync MULTADD (smoothed transfers, Chebyshev; cheby_setup "
        f"{cheby_s:.2f} s): cycles {res.iters} (reference {want['iters']}), rel_res "
        f"{float(res.rel_resnorm):.4e}, true rel_res {true_rel:.4e}, {solve_s:.3f} s; "
        f"launches {counts}")
    log("  history[:5]", [float(f"{h:.6e}") for h in hist[:5]],
        "reference", [float(f"{h:.6e}") for h in want["history"][:5]])
    rec["sync multadd"] = {"iters": res.iters, "rel_res": float(res.rel_resnorm),
                           "true_rel_res": true_rel, "solve_s": solve_s,
                           "cheby_setup_s": cheby_s, "counts": counts,
                           "coeffs": list(coeffs)}
    if res.iters != want["iters"] or not true_rel <= 1e-8:
        fails.append("96^3 sync multadd: not the reference's cycles or true residual > 1e-8")
    if not np.allclose(hist[:5], want["history"][:5], rtol=1e-10, atol=1e-14):
        fails.append("96^3 sync multadd: history[:5] differs from the reference's")

    def run_sync(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve(hier64, cfg, b64, tol=0.0, max_cycles=k, accel="cheby", cheby_coeffs=coeffs,
              device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    host_ms, _, _ = host_slope_ms(run_sync, 3, 8)
    busy, events, _ = device_per_cycle(
        lambda k: solve(hier64, cfg, b64, tol=0.0, max_cycles=k, accel="cheby",
                        cheby_coeffs=coeffs, device=device), 3, 6)
    log(f"  sync MULTADD cycle: host clock {host_ms:.4f} ms, device busy {busy:.4f} ms in "
        f"{events:.1f} events, idle share {1.0 - busy / host_ms:.3f}")
    rec["sync multadd"].update(host_ms_per_cycle=host_ms, device_busy_ms_per_cycle=busy,
                               events_per_cycle=events)

    acfg = AsyncConfig(**async_options(hier64, cfg, lambda *a, **k: coeffs))
    want = ref["96"]["full richardson"]
    lo, hi = math.floor(0.75 * want["iters"]), math.ceil(1.25 * want["iters"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    ares = async_solve(hier64, cfg, acfg, b64, seed=0, tol=1e-8, max_cycles=1000, device=device)
    torch.cuda.synchronize()
    async_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() - mem0
    true_rel = true_rel_residual(prob, ares.x.cpu().numpy(), b_np)
    gw = ares.grid_wait.summary()
    log(f"additive {GENERIC_N}^3 async_multadd FULL Richardson (the port's generators, seed 0): "
        f"steps {ares.iters} (reference {want['iters']} with its own draws; corridor "
        f"{lo}-{hi}), rel_res {float(ares.rel_resnorm):.4e}, true rel_res {true_rel:.4e}, "
        f"{async_s:.3f} s; peak device memory over the hierarchy {peak / 1e6:.1f} MB; "
        f"launches {counts}")
    log(f"  grid wait: mean {[round(v, 3) for v in gw['mean']]}, min {gw['min']}, max "
        f"{gw['max']}, corrections {gw['num_correct']} (reference's run: "
        f"{[round(v, 3) for v in want['grid_wait']['mean']]}, {want['grid_wait']['num_correct']})")
    rec["async full"] = {"iters": ares.iters, "rel_res": float(ares.rel_resnorm),
                         "true_rel_res": true_rel, "solve_s": async_s, "grid_wait": gw,
                         "peak_bytes": peak, "counts": counts}
    if not (float(ares.rel_resnorm) <= 1e-8 and true_rel <= 1.1e-8 and lo <= ares.iters <= hi):
        fails.append("96^3 async_multadd FULL: not converged within the reference's corridor")
    if keep is not None:
        keep.update(hier64=hier64, async_cfg=cfg, async_acfg=acfg, async_iters=ares.iters,
                    async_x=ares.x.cpu().numpy(), async_history=ares.history_list())

    for dn, hier, b in (("float64", hier64, b64), ("float32", hier32, b64.float())):
        t = async_timing(hier, cfg, acfg, b, device)
        log(f"  async step {dn}: host clock {t['host_ms_per_step']:.4f} ms, device busy "
            f"{t['device_busy_ms_per_step']:.4f} ms in {t['events_per_step']:.1f} events, "
            f"idle share {t['idle_share']:.3f}")
        for ms, nev, name in t["rows"]:
            log(f"    {ms:.4f} ms  {nev:7.1f} launches  {name}")
        rec[f"async step {dn}"] = t
        if keep is not None and dn == "float64":
            keep.update(async_host_ms=t["host_ms_per_step"],
                        async_device_ms=t["device_busy_ms_per_step"])
    return rec, fails


def additive_phase_48(ref, device):
    """At 48^3: the sync additive cycles at the reference's counts (AFACj's
    first 40 cycles at its history), SEMI async_multadd with the
    reference's draws replayed, FULL on the port's generators over five
    seeds, async_smooth and the async implicit extended system with the
    reference's draws. Returns (record, failures)."""
    import torch

    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.solve.accel import estimate_cycle_eigs
    from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
    from amg_tpu_torch.solve.async_smooth import (
        AsyncSmoothConfig,
        async_smooth_solve,
        block_neighbor_mask,
    )
    from amg_tpu_torch.solve.driver import cheby_setup, solve
    from amg_tpu_torch.solve.extended import build_extended_system, ext_matvec, ext_solve

    t_phase = time.perf_counter()
    fails, rec = [], {}
    ref = ref["48"]
    prob = laplacian_3d_27pt(GENERIC_SIDE)
    hh, hier = build_hierarchy(prob.A, HierarchyParams(), fine_stencil=prob.stencil,
                               device=device)
    if hh.stats()["n"] != ref["level_n"] or hh.stats()["nnz"] != ref["level_nnz"]:
        fails.append("additive 48^3: the hierarchy differs from the reference's")
    b_np = np.random.default_rng(0).random(prob.n)
    b = torch.from_numpy(b_np).to(device)

    def close(got, want, rtol):
        return len(got) == len(want) and np.allclose(got, want, rtol=rtol, atol=1e-14)

    for name in ("multadd", "afacx", "bpx", "mult_multadd", "afacj"):
        cfg = additive_cfg(name)
        accel = None if name == "mult_multadd" else "cheby"
        coeffs = cheby_setup(hier, cfg, num_iters=20, device=device) if accel else None
        want = ref["afacj 40" if name == "afacj" else name]
        t0 = time.perf_counter()
        res = solve(hier, cfg, b, tol=1e-8, max_cycles=40 if name == "afacj" else 200,
                    accel=accel, cheby_coeffs=coeffs, device=device)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        hist = res.history_list()
        log(f"additive {GENERIC_SIDE}^3 sync {name}: cycles {res.iters} (reference "
            f"{want['iters']}), rel_res {float(res.rel_resnorm):.4e}, {s:.3f} s")
        rec[name] = {"iters": res.iters, "rel_res": float(res.rel_resnorm), "solve_s": s}
        if res.iters != want["iters"]:
            fails.append(f"48^3 sync {name}: not the reference's cycles")
        if name == "afacj" and not close(hist, want["history"], 1e-8):
            fails.append("48^3 afacj: its 40 cycles' history differs from the reference's")

    cfg = additive_cfg("multadd")
    coeffs = cheby_setup(hier, cfg, num_iters=20, device=device)
    want = ref["semi richardson"]
    acfg = AsyncConfig(**async_options(hier, cfg, lambda *a, **k: coeffs, async_type="semi"))
    t0 = time.perf_counter()
    res = async_solve(hier, cfg, acfg, b, draws=RecordedAsyncDraws(want["draws"]), tol=1e-8,
                      max_cycles=200, device=device)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    gw = res.grid_wait.summary()
    log(f"additive {GENERIC_SIDE}^3 async_multadd SEMI, the reference's draws: steps "
        f"{res.iters} (reference {want['iters']}), rel_res {float(res.rel_resnorm):.4e}, "
        f"{s:.3f} s; grid wait equal to the reference's: {gw == want['grid_wait']}")
    rec["semi replay"] = {"iters": res.iters, "rel_res": float(res.rel_resnorm), "solve_s": s,
                          "grid_wait": gw}
    if res.iters != want["iters"] or not close(res.history_list(), want["history"], 1e-8) \
            or gw != want["grid_wait"]:
        fails.append("48^3 SEMI replay: not the reference's steps, history or grid waits")

    acfg = AsyncConfig(**async_options(hier, cfg, lambda *a, **k: coeffs))
    keys = list(ref["full richardson iters by key"].values())
    lo, hi = math.floor(0.9 * min(keys)), math.ceil(1.1 * max(keys))
    steps = []
    t0 = time.perf_counter()
    for seed in range(5):
        res = async_solve(hier, cfg, acfg, b, seed=seed, tol=1e-8, max_cycles=1000,
                          device=device)
        steps.append(res.iters if float(res.rel_resnorm) <= 1e-8 else None)
    s = time.perf_counter() - t0
    mean = np.mean(steps) if None not in steps else None
    log(f"additive {GENERIC_SIDE}^3 async_multadd FULL, the port's generators, seeds 0-4: steps "
        f"{steps}, mean {mean} (the reference's keys 0-4: {keys}; corridor {lo}-{hi}), {s:.3f} s")
    rec["full seeds"] = {"steps": steps, "reference": keys, "solve_s": s}
    if mean is None or not lo <= mean <= hi:
        fails.append("48^3 FULL async over five seeds: the mean step count is off the corridor")

    want = ref["smooth southwell_exp"]
    B = len(want["block_updates"])
    t0 = time.perf_counter()
    sres = async_smooth_solve(hier.levels[0].A, hier.levels[0].sm, AsyncSmoothConfig(num_blocks=B),
                              block_neighbor_mask(prob.A, B), b,
                              draws=RecordedSmoothDraws(want["draws"]), tol=0.0,
                              max_cycles=want["iters"], device=device)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    bu = sres.block_updates.tolist()
    log(f"additive {GENERIC_SIDE}^3 async_smooth southwell_exp, the reference's draws: "
        f"{sres.iters} steps to rel_res {float(sres.rel_resnorm):.4e}, block updates {bu} "
        f"(reference {want['block_updates']}), {s:.3f} s")
    rec["async_smooth replay"] = {"iters": sres.iters, "rel_res": float(sres.rel_resnorm),
                                  "block_updates": bu, "solve_s": s}
    if bu != want["block_updates"] or not close(sres.history_list(), want["history"], 1e-8):
        fails.append("48^3 async_smooth replay: not the reference's block updates or history")

    want = ref["async_implicit_ext_bpx"]
    t0 = time.perf_counter()
    ext = build_extended_system(hh, HierarchyParams(), explicit=False, device=device)
    A0 = hier.levels[0].A
    ecoeffs = estimate_cycle_eigs(
        lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u), ext.offsets[-1],
        torch.float64, num_iters=20, range_start=True, operand=(ext, A0), device=device)
    eres = ext_solve(hier, ext, b, tol=1e-8, max_cycles=200, cheby_coeffs=ecoeffs,
                     async_fire_prob=0.5, sim_read_delay=4,
                     draws=RecordedExtDraws(want["draws"]), device=device)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    log(f"additive {GENERIC_SIDE}^3 async_implicit_ext_bpx, the reference's draws: steps "
        f"{eres.iters} (reference {want['iters']}), rel_res {float(eres.rel_resnorm):.4e} "
        f"(reference {want['rel_res']:.4e}), bounds {[round(c, 6) for c in ecoeffs]}, {s:.3f} s")
    rec["ext replay"] = {"iters": eres.iters, "rel_res": float(eres.rel_resnorm), "solve_s": s}
    if eres.iters != want["iters"] or not close(eres.history_list(), want["history"], 1e-8):
        fails.append("48^3 async_implicit_ext_bpx replay: not the reference's steps or history")
    rec["phase_s"] = time.perf_counter() - t_phase
    return rec, fails


def generic_phase(device, keep):
    """The generic AMG path: returns (record, failures); puts the 96^3
    problem, host hierarchy, b, float64 x and per-cycle times into `keep`
    (phase 18's single-device baseline)."""
    import torch

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import cheby_setup, solve
    from amg_tpu_torch.solve.mixed import mixed_solve

    t_phase = time.perf_counter()
    fails, rec = [], {}
    prob = laplacian_3d_27pt(GENERIC_N)
    t0 = time.perf_counter()
    hh, hier64 = build_hierarchy(prob.A, HierarchyParams(), fine_stencil=prob.stencil,
                                 device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = hh.stats()
    log(f"generic {GENERIC_N}^3 ({prob.n} dofs): setup {setup_s:.2f} s, "
        f"{sum(st['nnz'])} nnz over {st['num_levels']} levels")
    for k, (lv, hl) in enumerate(zip(hier64.levels, hh.levels)):
        log(f"  level {k}: n {hl.A.n_rows}, nnz {hl.A.nnz}, {type(lv.A).__name__}"
            f"{f', ELL width {lv.A.k}' if hasattr(lv.A, 'k') else ''}")
    rec.update(setup_s=setup_s, level_n=st["n"], level_nnz=st["nnz"])
    if st["n"] != GENERIC_REF["96"]["level_n"] or st["nnz"] != GENERIC_REF["96"]["level_nnz"]:
        fails.append(f"generic {GENERIC_N}^3 hierarchy differs from the reference's")

    cfg = CycleConfig()
    b_np = np.random.default_rng(0).random(prob.n)
    b64 = torch.from_numpy(b_np).to(device)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = solve(hier64, cfg, b64, tol=1e-8, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    x = res.x.cpu().numpy()
    true_rel = true_rel_residual(prob, x, b_np)
    hist64 = res.history_list()
    keep.update(prob=prob, hh=hh, b=b_np, x64=x)
    log(f"generic float64 MULT V(1,1) L1-Jacobi: cycles {res.iters} (reference "
        f"{GENERIC_REF['96']['iters']}), rel_res {float(res.rel_resnorm):.4e}, true rel_res "
        f"(float64 CSR) {true_rel:.4e}, {solve_s:.3f} s; launches {counts}")
    every_ell_product_launched("generic float64 solve", counts, fails)
    log("  history[:5]", [float(f"{h:.6e}") for h in hist64[:5]],
        "reference", [float(f"{h:.6e}") for h in GENERIC_REF["96"]["history"][:5]])
    rec.update(iters64=res.iters, rel_res64=float(res.rel_resnorm), true_rel_res64=true_rel,
               solve64_s=solve_s, counts=counts, history64_head=hist64[:5])
    if res.iters != GENERIC_REF["96"]["iters"] or not true_rel <= 1e-8 \
            or not np.isfinite(x).all():
        fails.append("generic float64 solve: not the reference's cycles or true residual > 1e-8")
    # the goldens' tolerance (tests/test_golden.py)
    if not np.allclose(hist64[:5], GENERIC_REF["96"]["history"], rtol=1e-10, atol=1e-14):
        fails.append("generic float64 solve: history[:5] differs from the reference's")

    hier32 = hierarchy_from_arrays(*hh.arrays, dtype=torch.float32, device=device)
    b32 = b64.float()
    res32 = solve(hier32, cfg, b32, tol=1e-4, device=device)
    k64 = next(k for k, h in enumerate(hist64) if h <= 1e-4)
    log(f"generic float32: cycles {res32.iters} to rel_res {float(res32.rel_resnorm):.4e} "
        f"(float64 history first <= 1e-4 at cycle {k64})")
    rec.update(iters32=res32.iters, rel_res32=float(res32.rel_resnorm), f64_cycle_1e4=k64)
    if abs(res32.iters - k64) > 1 or not float(res32.rel_resnorm) <= 1e-4:
        fails.append("generic float32 solve: not within one cycle of the float64 history")

    # mixed_solve: the float32 hierarchy's cycles refined in float64 against
    # the float64 fine stencil
    eref = load_json(ELAST_REF)["mixed"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mres = mixed_solve(hier32, hier64.levels[0].A, cfg, b64, tol=1e-8, device=device)
    torch.cuda.synchronize()
    mixed_s = time.perf_counter() - t0
    mtrue = true_rel_residual(prob, mres.x.cpu().numpy(), b_np)
    log(f"mixed_solve float32 cycles, float64 refinement: cycles {mres.iters} (reference "
        f"{eref['iters']}), rel_res {mres.rel_resnorm:.4e}, true rel_res {mtrue:.4e}, "
        f"{mixed_s:.3f} s ({mixed_s / max(mres.iters, 1) * 1e3:.3f} ms per cycle)")
    rec["mixed_solve"] = {"iters": mres.iters, "true_rel_res": mtrue, "s": mixed_s}
    if abs(mres.iters - eref["iters"]) > 1 or not mtrue <= 1e-8:
        fails.append("mixed_solve: not within one cycle of the reference or true residual > 1e-8")

    # timing of the 96^3 float64 solve: host clock per cycle (tol 0, so every
    # cycle runs, with its one scalar read), the device's busy time per cycle
    def run(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve(hier64, cfg, b64, tol=0.0, max_cycles=k, device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    host_ms, s0, s1 = host_slope_ms(run, 5, 15)
    busy, events, rows = device_per_cycle(
        lambda k: solve(hier64, cfg, b64, tol=0.0, max_cycles=k, device=device), 5, 10)
    idle = 1.0 - busy / host_ms if host_ms > 0 else None
    log(f"generic {GENERIC_N}^3 float64 cycle: host clock {host_ms:.4f} ms per cycle "
        f"(5 cycles {[round(v, 4) for v in s0]} s, 15 {[round(v, 4) for v in s1]} s); device "
        f"busy {busy:.4f} ms in {events:.1f} events per cycle; idle share "
        f"{'not measured' if idle is None else f'{idle:.3f}'}")
    for ms, nev, name in rows[:10]:
        log(f"  {ms:.4f} ms  {nev:7.1f} launches  {name[:100]}")
    rec.update(host_ms_per_cycle=host_ms, device_busy_ms_per_cycle=busy,
               events_per_cycle=events, idle_share=idle)
    keep.update(host_ms=host_ms, device_ms=busy)

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), ASYNC_REF)) as f:
        aref = json.load(f)
    log("additive and async solvers:")
    rec["additive 96"], f96 = additive_phase_96(prob, hh, hier64, hier32, b_np, aref, device,
                                                keep)
    fails += f96

    rng = np.random.default_rng(SEED + 9)
    spmv = {}
    for k in (1, 2):
        spmv.update(spmv_timing(f"{GENERIC_N}^3 level {k}", hh.levels[k].A, device, rng,
                                fails))
    # the sync MULTADD cycle's largest transfers, P~0 and R~0
    for field in ("P_s", "R_s"):
        spmv.update(spmv_timing(f"{GENERIC_N}^3 level 0 {field}", getattr(hh.levels[0], field),
                                device, rng, fails, bsr=False))
    del hier32, hier64, hh
    torch.cuda.empty_cache()
    beam = elasticity_beam(*BEAM_SPMV)
    spmv.update(spmv_timing(f"beam {BEAM_SPMV}", beam.A, device, rng, fails))
    rec["spmv"] = {f"{k[0]} {k[1]}": v for k, v in spmv.items()}

    prob48 = laplacian_3d_27pt(GENERIC_SIDE)
    b48 = torch.from_numpy(np.random.default_rng(0).random(prob48.n)).to(device)
    for key, smoother, kw in (("48 hybrid_jgs", SmootherType.HYBRID_JGS, {}),
                              ("48 jacobi cheby", SmootherType.JACOBI, {"accel": "cheby"}),
                              ("48 l1_jacobi pcg", SmootherType.L1_JACOBI, {"outer": "pcg"})):
        t0 = time.perf_counter()
        _, h48 = build_hierarchy(prob48.A, HierarchyParams(smoother=smoother),
                                 fine_stencil=prob48.stencil, device=device)
        c48 = CycleConfig(smoother=smoother)
        if kw.get("accel") == "cheby":
            kw["cheby_coeffs"] = cheby_setup(h48, c48, num_iters=20, device=device)
        torch.cuda.synchronize()
        setup48 = time.perf_counter() - t0
        t0 = time.perf_counter()
        r48 = solve(h48, c48, b48, tol=1e-8, device=device, **kw)
        torch.cuda.synchronize()
        s48 = time.perf_counter() - t0
        want = GENERIC_REF[key]["iters"]
        log(f"generic {GENERIC_SIDE}^3 {key[3:]}: cycles {r48.iters} (reference {want}), rel_res "
            f"{float(r48.rel_resnorm):.4e}; setup {setup48:.2f} s, solve {s48:.3f} s")
        rec[key] = {"iters": r48.iters, "rel_res": float(r48.rel_resnorm), "setup_s": setup48,
                    "solve_s": s48}
        if r48.iters != want or not float(r48.rel_resnorm) <= 1e-8:
            fails.append(f"generic {key}: not the reference's cycles")
        del h48
    rec["additive 48"], f48 = additive_phase_48(aref, device)
    log(f"additive phase at {GENERIC_SIDE}^3: {rec['additive 48']['phase_s']:.1f} s")
    fails += f48
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"generic phase: {rec['phase_s']:.1f} s")
    return rec, fails


# phase 17: the drivers. The goldens of one device (tests/golden): config1,
# 2, 5, 9 (float64: count, shapes, history[:5] to 1e-10), config8 (SA-PCG:
# the same, F9), config3 and 13 (async on the port's generators: converged,
# steps within +-25% of the golden's); config10/11 are phase 13's
DRIVER_GOLDENS_F64 = ("config1_5pt_mult", "config2_27pt_jacobi_cheby", "config5_maxwell_ams",
                      "config9_27pt_medium", "config8_elasticity_sa_pcg")
DRIVER_GOLDENS_ASYNC = ("config3_27pt_async_multadd", "config13_27pt_medium_async")
DRIVER_N = N_SIDE  # the flagship: 27pt 126^3 structured
DRIVER_PHASE_N = 96  # -print_level_stats on the generic MULT solve
DRIVER_VARDIFCONV_N = 96  # vardifconv on the structured (DIA) hierarchy


def run_driver(opts, device, exp=None):
    """One run through the port's runner with the launch counters set to 0
    just before and read just after: (experiment, stats, counts). With `exp`
    (a set-up run of the same hierarchy) only the solve half runs again."""
    import torch

    from amg_tpu_torch.utils.runner import setup_experiment, solve_experiment

    torch.cuda.synchronize()
    reset_counts()
    if exp is None:
        exp = setup_experiment(opts, device)
    st = solve_experiment(exp)
    torch.cuda.synchronize()
    return exp, st, read_counts()


def plain_driver_solve(hier, exp, device):
    """The plain composition of a run: driver.solve on the same hierarchy,
    the run's cycle and b, launch counts logged (no kernel of K1-K5)."""
    import torch

    from amg_tpu_torch.solve.driver import solve
    from amg_tpu_torch.utils.runner import cycle_config

    o = exp.opts
    b = torch.from_numpy(np.random.default_rng(o.seed).random(exp.prob.n)).to(device)
    torch.cuda.synchronize()
    reset_counts()
    res = solve(hier, cycle_config(o, exp.smoother), b, tol=o.tol, max_cycles=o.num_cycles,
                device=device)
    torch.cuda.synchronize()
    return res, read_counts()


def drivers_phase(device, keep):
    """Phase 17: the port's own entry point, `run_experiment` (as its halves
    `setup_experiment` / `solve_experiment`, which keep the hierarchy for the
    plain composition), and its CLI on the card. Puts (a)'s host arrays
    into `keep` (phase 20's 126^3 structured route)."""
    import dataclasses

    import torch

    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.solve.cycles import cycle_step
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import cycle_config, solve_experiment

    t_phase = time.perf_counter()
    rec, fails = {}, []

    # (a) the flagship at full width: struct_solve through the runner
    opts = SolverOptions(problem="27pt", n=DRIVER_N, hierarchy="structured")
    exp, st, counts = run_driver(opts, device)
    keep["struct arrays"] = exp.hh.arrays
    x = st.x.cpu().numpy()
    b_np = np.random.default_rng(0).random(exp.prob.n)
    true_rel = true_rel_residual(exp.prob, x, b_np)
    plain, pcounts = plain_driver_solve(exp.hier, exp, device)
    dx = float(np.linalg.norm(x - plain.x.cpu().numpy()) / np.linalg.norm(plain.x.cpu().numpy()))
    log(f"(a) run_experiment 27pt {DRIVER_N}^3 structured ({st.n} dofs, levels {st.level_n}): "
        f"setup {st.setup_wtime:.2f} s, solve {st.solve_wtime:.4f} s, cycles {st.cycles} "
        f"(plain composition {plain.iters}), rel_res {st.rel_resnorm:.4e}, true rel_res "
        f"{true_rel:.4e}, |x - x_plain|/|x_plain| {dx:.3e}; launches {counts}, plain {pcounts}")
    r = {"n": st.n, "level_n": st.level_n, "setup_s": st.setup_wtime, "solve_s": st.solve_wtime,
         "cycles": st.cycles, "plain_cycles": plain.iters, "rel_res": st.rel_resnorm,
         "true_rel_res": true_rel, "dx": dx, "counts": counts,
         "host_ms_per_cycle_in_solve": st.solve_wtime / max(st.cycles, 1) * 1e3}
    r.update(log_profile("(a) V(1,1) solve through the runner",
                         solve_profile(lambda: solve_experiment(exp), st.cycles)))
    rec["a v11"] = r
    if min(counts[k] for k in ("K1", "K3", "K4")) == 0 \
            or max(ported_launches(pcounts).values()) > 0:
        fails.append("(a) V(1,1): K1 box, K3 or K4 not launched, or the plain composition "
                     "launched a kernel")
    if not true_rel <= 1e-8 or st.cycles != plain.iters or dx > 1e-10:
        fails.append("(a) V(1,1): true residual > 1e-8, or not the plain composition's cycles "
                     "and x")
    # V(3,3) by the sweep flags, on the same hierarchy (no option that
    # differs reaches the setup)
    exp33 = dataclasses.replace(exp, opts=dataclasses.replace(
        exp.opts, num_pre_smooth_sweeps=3, num_post_smooth_sweeps=3))
    _, st33, c33 = run_driver(exp33.opts, device, exp=exp33)
    x33 = st33.x.cpu().numpy()
    true33 = true_rel_residual(exp.prob, x33, b_np)
    plain33, p33 = plain_driver_solve(exp.hier, exp33, device)
    dx33 = float(np.linalg.norm(x33 - plain33.x.cpu().numpy())
                 / np.linalg.norm(plain33.x.cpu().numpy()))
    log(f"(a) V(3,3) through the runner: cycles {st33.cycles} (plain composition "
        f"{plain33.iters}), true rel_res {true33:.4e}, |x - x_plain|/|x_plain| {dx33:.3e}, solve "
        f"{st33.solve_wtime:.4f} s; launches {c33}, plain {p33}")
    r = {"cycles": st33.cycles, "plain_cycles": plain33.iters, "true_rel_res": true33,
         "dx": dx33, "counts": c33, "solve_s": st33.solve_wtime}
    r.update(log_profile("(a) V(3,3) solve through the runner",
                         solve_profile(lambda: solve_experiment(exp33), st33.cycles)))
    rec["a v33"] = r
    if c33["K1 taps"] == 0 or max(ported_launches(p33).values()) > 0:
        fails.append("(a) V(3,3): K1's tap route not launched, or the plain composition launched "
                     "a kernel")
    if not true33 <= 1e-8 or st33.cycles != plain33.iters or dx33 > 1e-10:
        fails.append("(a) V(3,3): true residual > 1e-8, or not the plain composition's cycles "
                     "and x")
    flagship_cycles = st.cycles
    del exp, exp33, st, st33, plain, plain33
    torch.cuda.empty_cache()

    # (b) the JAX bench's elasticity solve (V(2,2) hybrid JGS, 157k) and the
    # same with L1-Jacobi (phase 8's), through the runner on config11's and
    # config10's options with the bench's sweeps
    eref = load_json(ELAST_REF)["jgs"]
    for name, smoother, want in (("jgs", "hybrid_jgs", eref["iters"]), ("l1", "l1_jacobi", 20)):
        o = SolverOptions(problem="elasticity", nx=BEAM[0], ny=BEAM[1], nz=BEAM[2],
                          elast_bc="identity", hierarchy="structured", smoother=smoother,
                          mixed_precision=True, tol=1e-5, num_cycles=60,
                          num_pre_smooth_sweeps=2, num_post_smooth_sweeps=2)
        exp, st, counts = run_driver(o, device)
        prob = exp.prob
        bb = prob.rhs / np.linalg.norm(prob.rhs)
        tr = true_rel_residual(prob, st.x.cpu().numpy(), bb)
        log(f"(b) run_experiment elasticity {BEAM} {smoother} V(2,2) mixed ({st.n} dofs): setup "
            f"{st.setup_wtime:.2f} s, level_n {st.level_n} (phase 12 / reference "
            f"{eref['level_n']}), iterations {st.cycles} (want {want} +-1), true rel_res "
            f"{tr:.4e}, solve {st.solve_wtime:.4f} s; launches {counts}")
        r = {"iters": st.cycles, "want": want, "true_rel_res": tr, "setup_s": st.setup_wtime,
             "solve_s": st.solve_wtime, "counts": counts, "level_n": st.level_n}
        r.update(log_profile(f"(b) {smoother} solve through the runner",
                             solve_profile(lambda: solve_experiment(exp), st.cycles)))
        rec[f"b {name}"] = r
        if counts["K5"] == 0 or abs(st.cycles - want) > 1 or not tr <= 1e-5 \
                or st.level_n != eref["level_n"] or st.level_nnz != eref["level_nnz"]:
            fails.append(f"(b) elasticity {smoother}: K5, iterations, true residual or shapes")
        del exp, st
    torch.cuda.empty_cache()

    # (c) the single-device goldens through the runner on the card
    for name in DRIVER_GOLDENS_F64 + DRIVER_GOLDENS_ASYNC:
        g = load_json(f"tests/golden/{name}.json")
        _, st, counts = run_driver(SolverOptions(**g["config"]), device)
        h, w = np.asarray(st.history), np.asarray(g["history"])
        if name in DRIVER_GOLDENS_ASYNC:
            ok = st.rel_resnorm <= g["config"].get("tol", 1e-8) and \
                abs(st.cycles - g["cycles"]) <= 0.25 * g["cycles"]
            dev = None
        else:
            dev = float(np.max(np.abs(h[:5] - w[:5]) / w[:5]))
            ok = st.cycles == g["cycles"] and st.level_n == g["level_n"] and \
                st.level_nnz == g["level_nnz"] and np.allclose(h[:5], w[:5], rtol=1e-10,
                                                               atol=1e-14)
        log(f"(c) {name}: cycles {st.cycles} (golden {g['cycles']}), level_n {st.level_n}, "
            f"rel_res {st.rel_resnorm:.4e}, history[:5] max rel deviation {dev}, setup "
            f"{st.setup_wtime:.3f} s, solve {st.solve_wtime:.3f} s {'ok' if ok else 'FAIL'}")
        rec[f"c {name}"] = {"cycles": st.cycles, "golden": g["cycles"], "head_dev": dev,
                            "rel_res": st.rel_resnorm, "ok": bool(ok)}
        if not ok:
            fails.append(f"(c) golden {name} through the runner")

    # (d) the CLI in a process of its own
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "amg_tpu_torch.utils.cli", "-problem", "27pt",
                          "-n", str(DRIVER_N), "-hierarchy", "structured", "-oneline_output"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    try:
        line = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        line = {}
    log(f"(d) python3 -m amg_tpu_torch.utils.cli ... -oneline_output: rc {out.returncode}, "
        f"{cli_s:.1f} s, {line}")
    rec["d cli"] = dict(line, rc=out.returncode, s=cli_s)
    if out.returncode != 0 or line.get("cycles") != flagship_cycles or \
            not line.get("rel_res", 1.0) <= 1e-8:
        fails.append("(d) the CLI's one-line result: not (a)'s cycles or rel_res > 1e-8")
        log(out.stderr[-2000:])

    # (e) -print_level_stats on the generic MULT solve
    o = SolverOptions(problem="27pt", n=DRIVER_PHASE_N, print_level_stats=True)
    exp, st, counts = run_driver(o, device)
    b = torch.from_numpy(np.random.default_rng(o.seed).random(st.n)).to(device)
    xc = torch.zeros_like(b)
    cfg = cycle_config(exp.opts, exp.smoother)
    for _ in range(st.phase.cycles):
        xc = cycle_step(exp.hier, cfg, xc, b)
    dxe = float(torch.linalg.norm(st.phase._x - xc) / torch.linalg.norm(xc))
    log(f"(e) run_experiment 27pt {DRIVER_PHASE_N}^3 -print_level_stats: cycles {st.cycles}, "
        f"rel_res {st.rel_resnorm:.4e}, setup {st.setup_wtime:.2f} s, solve {st.solve_wtime:.3f}"
        f" s; the segmented profile's x after {st.phase.cycles} cycles against cycle_step's: "
        f"{dxe:.3e}; launches {counts}")
    st.phase.print_table()
    rec["e phases"] = {"cycles": st.cycles, "dx": dxe, "totals": st.phase.totals(),
                       "smooth": st.phase.smooth, "residual": st.phase.residual,
                       "restrict": st.phase.restrict, "prolong": st.phase.prolong}
    if dxe > 1e-12 or not st.rel_resnorm <= 1e-8:
        fails.append("(e) the segmented profile is not the production cycle, or no convergence")
    del exp, st, b, xc
    torch.cuda.empty_cache()

    # (f) vardifconv on the structured hierarchy: float64 DIA levels on K5
    o = SolverOptions(problem="vardifconv", n=DRIVER_VARDIFCONV_N, hierarchy="structured")
    exp, st, counts = run_driver(o, device)
    plain_hier, _ = plain_dia_hierarchy(exp.hier)
    plain, pcounts = plain_driver_solve(plain_hier, exp, device)
    dxf = float(torch.linalg.norm(st.x - plain.x) / torch.linalg.norm(plain.x))
    log(f"(f) run_experiment vardifconv {DRIVER_VARDIFCONV_N}^3 structured ({st.n} dofs, levels "
        f"{st.level_n}): setup {st.setup_wtime:.2f} s, cycles {st.cycles} (plain composition "
        f"{plain.iters}), rel_res {st.rel_resnorm:.4e}, |x - x_plain|/|x_plain| {dxf:.3e}, solve "
        f"{st.solve_wtime:.3f} s; launches {counts}, plain {pcounts}")
    r = {"cycles": st.cycles, "plain_cycles": plain.iters, "rel_res": st.rel_resnorm,
         "dx": dxf, "counts": counts, "setup_s": st.setup_wtime, "solve_s": st.solve_wtime}
    r.update(log_profile("(f) vardifconv solve through the runner",
                         solve_profile(lambda: solve_experiment(exp), st.cycles)))
    rec["f vardifconv"] = r
    if counts["K5"] == 0 or not st.rel_resnorm <= 1e-8 or st.cycles != plain.iters \
            or max(ported_launches(pcounts).values()) > 0:
        fails.append("(f) vardifconv: K5 not launched, rel_res > 1e-8 or not the plain "
                     "composition's cycles")
    del exp, st, plain_hier, plain
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"drivers phase: {rec['phase_s']:.1f} s")
    return rec, fails


# phase 18: the row-partitioned multi-device path, D logical shards on one
# card (parallel.dist.make_row_mesh)
MULTI_D = 8
MULTI_GOLDENS = ("config7_halo_dist_mult", "config4_elasticity_dist")


def multidevice_phase(device, keep, ams_ref):
    """Phase 18 on `device`: `keep` holds phase 10's 96^3 problem, host
    hierarchy, b and float64 x; `ams_ref` phase 15's reference numbers.
    Returns (record, failures)."""
    import torch

    from amg_tpu_torch.parallel import (
        build_dist_hierarchy,
        comm_trace,
        make_row_mesh,
        pad_vector,
        unpad_vector,
    )
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.setup.hierarchy import HierarchyParams
    from amg_tpu_torch.solve.ams import build_sharded_ams, solve_sharded_ams_pcg
    from amg_tpu_torch.solve.cycles import CycleConfig, mult_vcycle
    from amg_tpu_torch.solve.driver import solve
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import run_experiment

    t_phase = time.perf_counter()
    fails, rec = [], {"goldens": {}}

    def no_kernel(label, counts):
        if any(ported_launches(counts).values()):
            fails.append(f"{label}: a kernel of K1-K5 was launched on the multi-device path "
                         f"{counts}")

    # (a) the multi-device goldens through the runner
    for name in MULTI_GOLDENS:
        g = load_json(f"tests/golden/{name}.json")
        opts = SolverOptions(**g["config"])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        st = run_experiment(opts, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        ok_hist = np.allclose(st.history[:5], g["history"][:5], rtol=1e-10, atol=1e-14)
        log(f"golden {name} (num_devices {opts.num_devices}, comm {opts.comm}): cycles "
            f"{st.cycles} (golden {g['cycles']}), level_n {st.level_n}, rel_res "
            f"{st.rel_resnorm:.4e}, history[:5] {'equal' if ok_hist else 'DIFFERS'} (rtol "
            f"1e-10), {wall:.2f} s; launches {counts}")
        rec["goldens"][name] = {"cycles": st.cycles, "rel_res": st.rel_resnorm, "s": wall}
        if st.cycles != g["cycles"] or st.level_n != g["level_n"] or not ok_hist \
                or not st.rel_resnorm <= opts.tol:
            fails.append(f"golden {name}: not the golden's cycles, shapes or history")
        no_kernel(name, counts)
    log(f"  (a) {time.perf_counter() - t_phase:.1f} s")

    # (b) 96^3 on 8 shards, the halo route, against phase 10's solve
    prob, hh, b_np, x1 = keep["prob"], keep["hh"], keep["b"], keep["x64"]
    mesh = make_row_mesh(MULTI_D, device)
    cfg = CycleConfig()
    params = HierarchyParams()  # phase 10's
    want_iters = GENERIC_REF["96"]["iters"]
    for comm in ("halo", "gspmd"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hier, info = build_dist_hierarchy(hh, params, mesh, comm=comm)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        b = pad_vector(torch.from_numpy(b_np), info, mesh)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = solve(hier, cfg, b, tol=1e-8, device=device)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        counts = read_counts()
        x = unpad_vector(res.x, info, mesh).cpu().numpy()
        dx = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
        true_rel = true_rel_residual(prob, x, b_np)
        shard_rows = [lv.A.shape[0] // MULTI_D for lv in hier.levels]
        log(f"{GENERIC_N}^3 on {MULTI_D} shards, comm {comm}: setup {setup_s:.2f} s, rows a "
            f"shard {shard_rows}; cycles {res.iters} (one device {want_iters}), rel_res "
            f"{float(res.rel_resnorm):.4e}, true rel_res {true_rel:.4e}, |x - x_1|/|x_1| "
            f"{dx:.3e}, {solve_s:.3f} s; launches {counts}")
        r = {"setup_s": setup_s, "iters": res.iters, "true_rel_res": true_rel, "dx": dx,
             "solve_s": solve_s, "rows_a_shard": shard_rows}
        if res.iters != want_iters or dx > 1e-9 or not true_rel <= 1e-8:
            fails.append(f"{GENERIC_N}^3 {comm}: not the single-device cycles or x")
        no_kernel(f"{GENERIC_N}^3 {comm}", counts)
        if comm == "halo":
            with comm_trace(mesh) as trace:
                mult_vcycle(hier, cfg, torch.zeros_like(b), b)
            r.update(comm_bytes_per_cycle=int(sum(trace)), comm_msgs_per_cycle=len(trace))
            payload = sum(lv.A.comm_payload_bytes_per_matvec() for lv in hier.levels)
            log(f"  halo traffic a cycle: {sum(trace)} bytes a shard in {len(trace)} halo "
                f"matvecs; one matvec on every level ships {payload} payload bytes a shard")

            def run(k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                solve(hier, cfg, b, tol=0.0, max_cycles=k, device=device)
                torch.cuda.synchronize()
                return time.perf_counter() - t

            host_ms, _, _ = host_slope_ms(run, 5, 15)
            busy, events, rows = device_per_cycle(
                lambda k: solve(hier, cfg, b, tol=0.0, max_cycles=k, device=device), 5, 10)
            idle = 1.0 - busy / host_ms if host_ms > 0 else None
            log(f"  a cycle: host clock {host_ms:.4f} ms, device busy {busy:.4f} ms in "
                f"{events:.1f} events, idle share "
                f"{'not measured' if idle is None else f'{idle:.3f}'} (phase 10, one device: "
                f"{keep['device_ms']:.4f} ms device, {keep['host_ms']:.4f} ms host)")
            for ms, nev, name in rows[:8]:
                log(f"    {ms:.4f} ms  {nev:7.1f} launches  {name[:100]}")
            r.update(host_ms_per_cycle=host_ms, device_busy_ms_per_cycle=busy,
                     events_per_cycle=events, idle_share=idle)
        rec[f"96 {comm}"] = r
        if comm == "gspmd":  # phase 20's one-process run of the route
            keep.update({"gspmd x": x, "gspmd rec": {"steps": res.iters, "counts": counts}})
        del hier
        torch.cuda.empty_cache()
        log(f"  (b) {comm}: {time.perf_counter() - t_phase:.1f} s into the phase")

    # (c) AMS-PCG row-sharded at n = 40
    pm = maxwell_curlcurl(MAXWELL_N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A_h, ams, node_cfg, pad_e, _ = build_sharded_ams(pm.A, pm.aux["G"], mesh, Pi=pm.aux["Pi"])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bm_np = np.random.default_rng(0).random(pm.n)  # phase 15's b
    bm = torch.from_numpy(bm_np)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    mres = solve_sharded_ams_pcg(A_h, ams, node_cfg, bm, mesh, pad_e, tol=1e-8, max_iters=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    true_rel = true_rel_residual(pm, mres.x.cpu().numpy(), bm_np)
    log(f"AMS-PCG maxwell_curlcurl({MAXWELL_N}) on {MULTI_D} shards ({pm.n} edges, padded "
        f"{pad_e[1]}): setup {setup_s:.2f} s; iterations {mres.iters} (one device "
        f"{ams_ref['iters']}), rel_res {float(mres.rel_resnorm):.4e}, true rel_res "
        f"{true_rel:.4e}, {solve_s:.3f} s; launches {counts}")
    rec["ams"] = {"setup_s": setup_s, "iters": mres.iters, "true_rel_res": true_rel,
                  "solve_s": solve_s}
    if abs(mres.iters - ams_ref["iters"]) > 1 or not true_rel <= 1e-8:
        fails.append("sharded AMS-PCG: not the single-device iterations +-1 or residual > 1e-8")
    no_kernel("sharded AMS-PCG", counts)
    rec["ams"].update(log_profile("sharded AMS-PCG float64", solve_profile(
        lambda: solve_sharded_ams_pcg(A_h, ams, node_cfg, bm, mesh, pad_e, tol=1e-8,
                                      max_iters=200), mres.iters)))
    del A_h, ams
    log(f"  (c) {time.perf_counter() - t_phase:.1f} s into the phase")
    # (d) the dry run, row and grid parts, runs in phase 19 (e)
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"multi-device phase: {rec['phase_s']:.1f} s")
    return rec, fails


# phase 19: grid (level) parallelism on the same mesh (parallel.grid)
GRID_GOLDENS = ("config6_grid_async_multadd", "config12_maxwell_async_ams_grid")
# the grid-mapped extended system at 27pt 30^3, the largest side whose
# explicit AA fits the card: 1.88G ELL slots, 12 B each held and 16 B more
# in a matvec's gather and product, 53 GB (31^3: 2.62G slots, 73 GB)
GRID_EXT_N = 30
GRID_AMS_STEPS = 100
GRID_AMS_SPLIT_N = 6  # maxwell_curlcurl(6): one AMS group a shard


def grid_phase(device, keep):
    """Phase 19 on `device`: `keep` holds phase 10's 96^3 host hierarchy,
    b, and phase 11's float64 hierarchy, async cfg / acfg, steps, x and
    per-step times. Returns (record, failures)."""
    import torch

    from amg_tpu_torch.convert import matrix_from_arrays
    from amg_tpu_torch.parallel import comm_trace, make_row_mesh
    from amg_tpu_torch.parallel.grid import (
        build_grid_owned_storage,
        device_branch_fn,
        grid_parallel_solve,
        plan_grid_levels,
    )
    from amg_tpu_torch.parallel.partition import compute_level_work
    from amg_tpu_torch.problems.maxwell import maxwell_curlcurl
    from amg_tpu_torch.setup.hierarchy import HierarchyParams, _format_converter
    from amg_tpu_torch.solve.ams import (
        ams_async_additive_solve,
        ams_grid_parallel_solve,
        async_ams_eigs,
        build_ams,
        plan_ams_groups,
    )
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.dryrun import dryrun_multichip
    from amg_tpu_torch.utils.runner import setup_experiment, solve_experiment

    t_phase = time.perf_counter()
    fails, rec = [], {"goldens": {}}

    def no_kernel(label, counts):
        if any(ported_launches(counts).values()):
            fails.append(f"{label}: a kernel of K1-K5 was launched on the grid path "
                         f"{counts}")

    # (a) the grid goldens through the runner, on the port's generators
    for name in GRID_GOLDENS:
        g = load_json(f"tests/golden/{name}.json")
        opts = SolverOptions(**g["config"])
        lo, hi = math.floor(0.75 * g["cycles"]), math.ceil(1.25 * g["cycles"])
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        exp = setup_experiment(opts, device)
        t1 = time.perf_counter()
        st = solve_experiment(exp)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = read_counts()
        log(f"golden {name} ({opts.solver}, num_devices {opts.num_devices}, grid parallel): "
            f"level_n {st.level_n}, steps {st.cycles} (golden {g['cycles']} with the reference's "
            f"draws; corridor {lo}-{hi}), rel_res {st.rel_resnorm:.4e}; setup {t1 - t0:.2f} s, "
            f"solve {t2 - t1:.3f} s ({(t2 - t1) / max(st.cycles, 1) * 1e3:.3f} ms a step); "
            f"launches {counts}")
        rec["goldens"][name] = {"cycles": st.cycles, "rel_res": st.rel_resnorm,
                                "setup_s": t1 - t0, "solve_s": t2 - t1}
        if st.level_n != g["level_n"] or st.level_nnz != g["level_nnz"] \
                or not lo <= st.cycles <= hi or not st.rel_resnorm <= opts.tol:
            fails.append(f"golden {name}: not the golden's shapes, or not converged in its corridor")
        no_kernel(name, counts)
        del exp
    log(f"  (a) {time.perf_counter() - t_phase:.1f} s")

    # (b) phase 11's 96^3 FULL async_multadd over 8 shards' level groups
    hh, hier, b_np = keep["hh"], keep["hier64"], keep["b"]
    cfg, acfg = keep["async_cfg"], keep["async_acfg"]
    want_iters, x1 = keep["async_iters"], keep["async_x"]
    b64 = torch.from_numpy(b_np).to(device)
    mesh = make_row_mesh(MULTI_D, device)
    _, levels_of, scale = plan_grid_levels(hh, MULTI_D,
                                           smoothed_transfers=cfg.use_smoothed_transfers)
    storage = build_grid_owned_storage(hier, levels_of, cfg, mesh)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = grid_parallel_solve(hier, cfg, acfg, levels_of, scale, mesh, b64, seed=0, tol=1e-8,
                              max_cycles=1000)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    x = res.x.cpu().numpy()
    dx = float(np.linalg.norm(x - x1) / np.linalg.norm(x1))
    true_rel = true_rel_residual(keep["prob"], x, b_np)
    # a step count may move by one only where the single-device history ends
    # within 1e-12 of tol (a roundoff-sized change then crosses it)
    slack = 1 if abs(keep["async_history"][-1] - 1e-8) <= 1e-12 else 0
    log(f"{GENERIC_N}^3 FULL async_multadd over {MULTI_D} shards' level groups {levels_of} "
        f"(scale {[round(float(v), 3) for v in scale]}): steps {res.iters} (one device {want_iters}), "
        f"rel_res {float(res.rel_resnorm):.4e}, true rel_res {true_rel:.4e}, |x - x_1|/|x_1| "
        f"{dx:.3e}, {solve_s:.3f} s; owned bytes a shard {list(storage.owned_bytes)}; "
        f"launches {counts}")
    r = {"levels_of": [list(ls) for ls in levels_of], "iters": res.iters, "dx": dx,
         "true_rel_res": true_rel, "solve_s": solve_s, "owned_bytes": list(storage.owned_bytes),
         "grid_wait": res.grid_wait.summary()}
    if abs(res.iters - want_iters) > slack or dx > 1e-9 or not float(res.rel_resnorm) <= 1e-8:
        fails.append(f"{GENERIC_N}^3 grid FULL: not the single-device steps or x")
    no_kernel(f"{GENERIC_N}^3 grid", counts)

    def solve_k(k):
        return grid_parallel_solve(hier, cfg, acfg, levels_of, scale, mesh, b64, seed=0,
                                   tol=0.0, max_cycles=k)

    def run(k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        solve_k(k)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    host_ms, _, _ = host_slope_ms(run, 10, 30)
    busy, events, rows = device_per_cycle(solve_k, 10, 20)
    idle = 1.0 - busy / host_ms if host_ms > 0 else None
    log(f"  a grid step: host clock {host_ms:.4f} ms, device busy {busy:.4f} ms in {events:.1f} "
        f"events, idle share {'not measured' if idle is None else f'{idle:.3f}'} (one device, "
        f"phase 11: {keep['async_device_ms']:.4f} ms device, {keep['async_host_ms']:.4f} ms host)")
    for ms, nev, name in rows[:8]:
        log(f"    {ms:.4f} ms  {nev:7.1f} launches  {name[:100]}")
    r.update(host_ms_per_step=host_ms, device_busy_ms_per_step=busy, events_per_step=events,
             idle_share=idle)
    # each shard's correction work in one step (every level fires, FULL reads
    # from a ring of the solve's iterates) beside the work model's share
    work = compute_level_work(hh, smoothed_transfers=cfg.use_smoothed_transfers)
    W = acfg.sim_read_delay + 1
    ring = torch.stack([res.x * (1.0 - 0.1 * i) for i in range(W)])
    gen = torch.Generator(device=device).manual_seed(0)
    cols = [torch.randint(0, W, (b64.shape[0],), generator=gen, device=device, dtype=torch.int32)
            for _ in range(hier.num_levels)]
    shard_ms = []
    for d in range(MULTI_D):
        fn = device_branch_fn(storage.views[d], cfg, acfg, levels_of[d], b64)
        fn(ring, cols)
        ms, _, _ = profile_device_ms(lambda: fn(ring, cols))
        shard_ms.append(ms)
    model = [float(sum(work[k] for k in ls)) for ls in levels_of]
    tot_ms, tot_w = max(sum(shard_ms), 1e-12), sum(model)
    log("  one step's correction work a shard (every level firing): device ms "
        f"{[round(v, 4) for v in shard_ms]}; share {[round(v / tot_ms, 3) for v in shard_ms]} "
        f"against the work model's {[round(v / tot_w, 3) for v in model]}")
    r.update(shard_device_ms=shard_ms, shard_model_work=model)
    rec["96 full"] = r
    del storage, hier, ring
    for key in ("hier64", "async_x"):
        keep.pop(key, None)
    torch.cuda.empty_cache()
    log(f"  (b) {time.perf_counter() - t_phase:.1f} s into the phase")

    # (c) the grid-mapped extended system (HaloELL AA) through the runner
    opts = SolverOptions(problem="27pt", n=GRID_EXT_N, solver="explicit_ext_bpx",
                         num_devices=MULTI_D, tol=1e-8)
    t0 = time.perf_counter()
    held_gb = torch.cuda.memory_allocated(device) / 1e9
    exp = setup_experiment(opts, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t1 = time.perf_counter()
    with comm_trace(exp.grid_mesh) as trace:
        st = solve_experiment(exp)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = read_counts()
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    per_matvec = sum(trace) / max(len(trace), 1)
    log(f"grid-mapped extended system, 27pt {GRID_EXT_N}^3 ({st.level_n}), explicit_ext_bpx on "
        f"{MULTI_D} shards: steps {st.cycles}, rel_res {st.rel_resnorm:.4e}; setup {t1 - t0:.2f} "
        f"s, solve {t2 - t1:.3f} s (the system's build and eigenvalue estimate included); "
        f"{len(trace)} AA matvecs, {per_matvec:.0f} halo bytes a shard each (one a step); "
        f"device peak {peak_gb:.2f} GB ({held_gb:.2f} GB held before the setup); "
        f"launches {counts}")
    rec["ext"] = {"n": GRID_EXT_N, "cycles": st.cycles, "rel_res": st.rel_resnorm,
                  "setup_s": t1 - t0, "solve_s": t2 - t1, "aa_matvecs": len(trace),
                  "halo_bytes_per_step": per_matvec, "device_peak_gb": peak_gb,
                  "held_before_gb": held_gb}
    if not st.rel_resnorm <= 1e-8:
        fails.append("grid-mapped extended system: rel_res > 1e-8")
    no_kernel("grid-mapped extended system", counts)
    # phase 20's one-process run of the route
    keep.update({"ext x": st.x.cpu().numpy(), "ext rec": {"steps": st.cycles, "counts": counts}})
    del exp
    torch.cuda.empty_cache()
    log(f"  (c) {time.perf_counter() - t_phase:.1f} s into the phase")

    # (d) the async AMS groups against the single-device async AMS: at
    # n = 40 the work model puts all 14 groups on one shard (ROADMAP F13),
    # at n = 6 each of its 6 groups on its own
    for n_mx, key in ((MAXWELL_N, "ams"), (GRID_AMS_SPLIT_N, "ams split")):
        pm = maxwell_curlcurl(n_mx)
        t0 = time.perf_counter()
        ams, _ = build_ams(pm.A, pm.aux["G"], Pi=pm.aux["Pi"], device=device)
        A = matrix_from_arrays(_format_converter(HierarchyParams())(pm.A), torch.float64, device)
        coeffs = async_ams_eigs(A, ams)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        bm_np = np.random.default_rng(0).random(pm.n)  # phase 15's b
        bm = torch.from_numpy(bm_np).to(device)
        runs = {}
        for label in ("one device", "grid"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            if label == "grid":
                out, owned = ams_grid_parallel_solve(A, ams, mesh, bm, seed=0, tol=0.0,
                                                     max_cycles=GRID_AMS_STEPS,
                                                     cheby_coeffs=coeffs)
            else:
                out = ams_async_additive_solve(A, ams, bm, seed=0, tol=0.0,
                                               max_cycles=GRID_AMS_STEPS, cheby_coeffs=coeffs,
                                               device=device)
            torch.cuda.synchronize()
            runs[label] = (out, time.perf_counter() - t0, read_counts())
        (one, s1, _), (grid, s2, counts) = runs["one device"], runs["grid"]
        dxa = float(torch.linalg.norm(grid.x - one.x) / torch.linalg.norm(one.x))
        groups_of, _ = plan_ams_groups(ams, MULTI_D)
        log(f"async AMS groups, maxwell_curlcurl({n_mx}) ({pm.n} edges), {GRID_AMS_STEPS} "
            f"steps on the port's draws (seed 0): rel_res {float(grid.rel_resnorm):.4e} (one "
            f"device {float(one.rel_resnorm):.4e}), |x - x_1|/|x_1| {dxa:.3e}; "
            f"{s2 / GRID_AMS_STEPS * 1e3:.3f} ms a step (one device "
            f"{s1 / GRID_AMS_STEPS * 1e3:.3f}); setup {setup_s:.2f} s; groups "
            f"{[list(g) for g in groups_of]}, owned bytes a shard {owned}; launches {counts}")
        rec[key] = {"n": n_mx, "steps": grid.iters, "rel_res": float(grid.rel_resnorm),
                    "dx": dxa, "ms_per_step": s2 / GRID_AMS_STEPS * 1e3,
                    "one_device_ms_per_step": s1 / GRID_AMS_STEPS * 1e3, "owned_bytes": owned,
                    "groups_of": [list(g) for g in groups_of]}
        if grid.iters != GRID_AMS_STEPS or one.iters != GRID_AMS_STEPS or dxa > 1e-9:
            fails.append(f"async AMS groups n = {n_mx}: not the single-device solve's steps or x")
        if n_mx == GRID_AMS_SPLIT_N and sum(1 for g in groups_of if g) < 2:
            fails.append(f"async AMS groups n = {n_mx}: the groups are not split")
        no_kernel(f"async AMS groups n = {n_mx}", counts)
        del ams, A
        torch.cuda.empty_cache()
    log(f"  (d) {time.perf_counter() - t_phase:.1f} s into the phase")

    # (e) the dry run, its row and grid parts
    t0 = time.perf_counter()
    try:
        rec["dryrun"] = dryrun_multichip(MULTI_D, device)
    except AssertionError as e:
        fails.append(f"dryrun_multichip: {e}")
    rec["dryrun_s"] = time.perf_counter() - t0
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"grid phase: {rec['phase_s']:.1f} s (the dry run {rec['dryrun_s']:.1f} s)")
    return rec, fails


# phase 20: the routes across processes. chip_smoke.py re-invokes itself as
# P20_WORKERS processes (`--p20-worker`): NCCL, one card each, where the
# machine shows that many cards; otherwise gloo on cuda:0 with the mesh
# staging each collective through host buffers (NCCL refuses two ranks on
# one device). Each process holds 4 of the 8 shards; every route is held
# against the one-process 8-shard run of the same options, which phases
# 18 / 19 ran or this phase runs first. The shared host inputs (phase 10's
# 96^3 host hierarchy, b, the beams' and the 126^3 structured setups) go to
# the workers as files in a temporary directory of the checkout.
P20_WORKERS = 2
P20_ROUTES = ("gspmd", "async full", "mixed", "cheby power", "async_smooth", "extended",
              "hybrid_jgs beam", "structured", "structured f32", "structured dia mixed")
# the routes whose x must be the one-process run's exactly: every level
# computes its rows as one process does
P20_EXACT = ("structured", "structured f32")
P20_STRUCT32_TOL = 1e-4  # the 126^3 V(1,1) float32 target (PERF.md section 2)
P20_SMOOTH_STEPS = 100
P20_STRUCT_OPTS = {"problem": "27pt", "n": N_SIDE, "hierarchy": "structured",
                   "solver": "mult", "num_devices": MULTI_D}
P20_EXT_OPTS = {"problem": "27pt", "n": GRID_EXT_N, "solver": "explicit_ext_bpx",
                "num_devices": MULTI_D, "tol": 1e-8}
P20_BEAM_OPTS = {"problem": "elasticity", "nx": BEAM[0], "ny": BEAM[1], "nz": BEAM[2],
                 "solver": "mult", "smoother": "hybrid_jgs", "outer_solver": "pcg",
                 "num_devices": MULTI_D, "comm": "halo", "device_format": "ell",
                 "setup_type": "classical"}
# the identity-BC beam nearest the bench's 144x18x18 whose 144 node planes
# split over the 8 shards, under config10's mixed-precision options
P20_DIA_OPTS = {"problem": "elasticity", "nx": 143, "ny": BEAM[1], "nz": BEAM[2],
                "elast_bc": "identity", "hierarchy": "structured", "mixed_precision": True,
                "tol": 1e-5, "num_cycles": 60, "num_devices": MULTI_D}


class P20Route:
    """One route of phase 20, set up: `solve()` runs it to its end (timed),
    `steps_of(res)` / `x_of(res)` read its step count and global x (a host
    array), `run(k)` runs k steps (tol 0, the device profile's slope),
    `mesh` is the mesh whose collectives it takes."""

    def __init__(self, name, mesh, solve, run, x_of, steps_of=lambda r: r.iters,
                 extra=lambda r: {}):
        self.name, self.mesh, self.solve, self.run = name, mesh, solve, run
        self.x_of, self.steps_of, self.extra = x_of, steps_of, extra


def p20_routes(ctx, mesh, device):
    """Phase 20's routes on `mesh` (8 shards: one process's, or 4 of each
    worker's), from the shared inputs `ctx`, in P20_ROUTES' order, set up
    one after the other (the 96^3 row-sharded hierarchies live while the
    routes that share them run)."""
    import torch

    from amg_tpu_torch.parallel import build_dist_hierarchy, pad_vector, unpad_vector
    from amg_tpu_torch.setup.hierarchy import HierarchyParams
    from amg_tpu_torch.solve.cycles import CycleConfig
    from amg_tpu_torch.solve.driver import cheby_setup, solve

    hh, b_np = ctx["hh"], ctx["b"]
    cfg = CycleConfig()

    def dist(comm, dtype=torch.float64):
        hier, info = build_dist_hierarchy(hh, HierarchyParams(dtype=dtype), mesh, comm=comm)
        return hier, info, pad_vector(torch.from_numpy(b_np), info, mesh)

    def glob(info):
        return lambda res: unpad_vector(res.x, info, mesh).double().cpu().numpy()

    # (a) comm "gspmd"
    hier, info, b = dist("gspmd")
    yield P20Route("gspmd", mesh, lambda: solve(hier, cfg, b, tol=1e-8, device=device),
                   lambda k: solve(hier, cfg, b, tol=0.0, max_cycles=k, device=device),
                   glob(info))
    del hier
    # (b)-(d) on the halo hierarchy: FULL async_multadd (phase 11's options,
    # the port's generators seeded 0 in every process), mixed_solve, and the
    # Chebyshev solver after cheby_setup by power
    from amg_tpu_torch.solve.async_sim import AsyncConfig, async_solve
    from amg_tpu_torch.solve.mixed import mixed_solve

    hier, info, b = dist("halo")
    acfg, add_cfg = AsyncConfig(**ctx["acfg"]), additive_cfg("multadd")
    yield P20Route(
        "async full", mesh,
        lambda: async_solve(hier, add_cfg, acfg, b, seed=0, tol=1e-8, max_cycles=1000,
                            device=device),
        lambda k: async_solve(hier, add_cfg, acfg, b, seed=0, tol=0.0, max_cycles=k,
                              device=device),
        glob(info), extra=lambda r: {"history_end": r.history_list()[-1]})
    hier32, _, _ = dist("halo", torch.float32)
    A64 = hier.levels[0].A
    yield P20Route("mixed", mesh,
                   lambda: mixed_solve(hier32, A64, cfg, b, tol=1e-8, device=device),
                   lambda k: mixed_solve(hier32, A64, cfg, b, tol=0.0, max_cycles=k,
                                         device=device),
                   glob(info))
    del hier32, A64
    coeffs = cheby_setup(hier, cfg, num_iters=20, method="power", device=device)
    yield P20Route(
        "cheby power", mesh,
        lambda: solve(hier, cfg, b, tol=1e-8, accel="cheby", cheby_coeffs=coeffs,
                      device=device),
        lambda k: solve(hier, cfg, b, tol=0.0, max_cycles=k, accel="cheby",
                        cheby_coeffs=coeffs, device=device),
        glob(info), extra=lambda r: {"bounds": [coeffs.alpha, coeffs.beta]})
    del hier
    # (e) one-level async smoothing on the 27-point 96^3 plane halo
    from amg_tpu_torch.parallel.dist import shard_smoother
    from amg_tpu_torch.parallel.halo import make_halo_stencil
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.smooth.smoothers import (
        SmootherType,
        make_smoother_data,
        smoother_data_from_arrays,
    )
    from amg_tpu_torch.solve.async_smooth import (
        AsyncSmoothConfig,
        async_smooth_solve,
        block_neighbor_mask,
    )
    from amg_tpu_torch.sparse.stencil import StencilOperator

    st = laplacian_3d_27pt(GENERIC_N).stencil
    A = make_halo_stencil(StencilOperator(weights=st.weights.to(device), offsets=st.offsets,
                                          grid_shape=st.grid_shape), mesh)
    lv0 = hh.levels[0]
    sm = smoother_data_from_arrays(make_smoother_data(lv0.A, SmootherType.L1_JACOBI,
                                                      w=lv0.weight), torch.float64, device)
    if mesh.world_size > 1:
        sm = shard_smoother(sm, mesh)
    scfg, nbr = AsyncSmoothConfig(num_blocks=MULTI_D), block_neighbor_mask(lv0.A, MULTI_D)
    bs = mesh.shard_vector(torch.from_numpy(b_np))

    def smooth_k(k):
        return async_smooth_solve(A, sm, scfg, nbr, bs, tol=0.0, max_cycles=k, device=device,
                                  mesh=mesh)

    yield P20Route("async_smooth", mesh, lambda: smooth_k(P20_SMOOTH_STEPS), smooth_k,
                   lambda r: mesh.gather(r.x).cpu().numpy(),
                   extra=lambda r: {"history": r.history_list()})
    del A, sm
    # (f) the grid-mapped extended system: the runner's EXT branch, its
    # set-up (hierarchy, mesh, b) by setup_experiment and its calls as
    # solve_experiment makes them
    from amg_tpu_torch.solve.accel import estimate_cycle_eigs
    from amg_tpu_torch.solve.extended import (
        build_sharded_extended_system,
        ext_matvec,
        ext_solve,
    )
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import _make_vectors, setup_experiment

    exp = setup_experiment(SolverOptions(**P20_EXT_OPTS), device)
    o = exp.opts
    ext = build_sharded_extended_system(exp.hh, exp.params, exp.grid_mesh, imbalance=o.imbal,
                                        assign_policy=o.assign_procs,
                                        assign_scalar=o.assign_procs_scalar)
    A0 = exp.hier.levels[0].A
    ecoeffs = estimate_cycle_eigs(
        lambda op, u: op[0].inv_wdiag * ext_matvec(op[0], op[1], u), ext.offsets[-1],
        exp.params.dtype, num_iters=o.cheby_power_iters, range_start=True, operand=(ext, A0),
        device=device, mesh=ext.mesh)
    be, xe = _make_vectors(o, exp.prob.n, exp.params.dtype, device)

    def ext_k(k, tol=0.0):
        return ext_solve(exp.hier, ext, be, xe, tol=tol, max_cycles=k, cheby_coeffs=ecoeffs,
                         seed=o.seed, device=device)

    yield P20Route("extended", exp.grid_mesh, lambda: ext_k(o.num_cycles, o.tol), ext_k,
                   lambda r: r.x.cpu().numpy(),
                   extra=lambda r: {"rel_res": float(r.rel_resnorm)})
    del exp, ext
    # (g) config4's options with hybrid JGS on the 157k beam (PCG)
    from amg_tpu_torch.utils.runner import cycle_config

    bo = SolverOptions(**P20_BEAM_OPTS)
    bo.fixup()
    hier, info = build_dist_hierarchy(ctx["beam_hh"], ctx["beam_params"], mesh, comm="halo")
    bb = pad_vector(torch.from_numpy(ctx["beam_b"]), info, mesh)
    bcfg = cycle_config(bo, ctx["beam_params"].smoother)
    yield P20Route(
        "hybrid_jgs beam", mesh,
        lambda: solve(hier, bcfg, bb, tol=bo.tol, max_cycles=bo.num_cycles, outer="pcg",
                      device=device),
        lambda k: solve(hier, bcfg, bb, tol=0.0, max_cycles=k, outer="pcg", device=device),
        glob(info))
    del hier
    # (h) 126^3 on the structured hierarchy through the generic cycle
    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.parallel import shard_structured_hierarchy

    so = SolverOptions(**P20_STRUCT_OPTS)
    so.fixup()
    n = N_SIDE ** 3
    b_np = np.random.default_rng(so.seed).random(n)
    scfg2 = cycle_config(so, SmootherType(so.smoother))
    for name, dtype, tol in (("structured", torch.float64, so.tol),
                             ("structured f32", torch.float32, P20_STRUCT32_TOL)):
        hier = shard_structured_hierarchy(
            hierarchy_from_arrays(*ctx["struct_arrays"], dtype=dtype, device=device), mesh)
        bst = pad_vector(torch.from_numpy(b_np).to(dtype), (n, n), mesh)
        yield P20Route(name, mesh,
                       lambda: solve(hier, scfg2, bst, tol=tol, device=device),
                       lambda k: solve(hier, scfg2, bst, tol=0.0, max_cycles=k, device=device),
                       glob((n, n)))
        del hier, bst
    # (i) the identity-BC beam under -hierarchy structured -mixed_precision:
    # the runner's set-up (float32 DIA levels, the float64 DIA outer
    # operator, plane-split where the 144 node planes split) and its call of
    # mixed_pcg
    from amg_tpu_torch.parallel.dist import shard_structured_operator
    from amg_tpu_torch.setup.structured import VarStencilOperator
    from amg_tpu_torch.solve.mixed import mixed_pcg

    do = SolverOptions(**P20_DIA_OPTS)
    do.fixup()
    dia = ctx["dia"]
    hier = shard_structured_hierarchy(
        hierarchy_from_arrays(*dia["arrays"], dtype=torch.float32, device=device), mesh)
    A64 = VarStencilOperator(coeffs=torch.from_numpy(dia["coeffs"]).to(device),
                             offsets=dia["offsets"], grid_shape=dia["grid_shape"])
    if mesh.world_size > 1:
        A64 = shard_structured_operator(A64, mesh)
    nd = dia["b"].shape[0]
    bd = pad_vector(torch.from_numpy(dia["b"]), (nd, nd), mesh)
    dcfg = cycle_config(do, SmootherType(do.smoother))
    yield P20Route(
        "structured dia mixed", mesh,
        lambda: mixed_pcg(hier, A64, dcfg, bd, tol=do.tol, max_cycles=do.num_cycles,
                          device=device),
        # k PCG iterations: one refinement cycle of k inner iterations
        lambda k: mixed_pcg(hier, A64, dcfg, bd, tol=0.0, max_cycles=k, inner_iters=k,
                            inner_tol=0.0, device=device),
        glob((nd, nd)))


def p20_measure(route):
    """A set-up route run to its end, every kernel counter reset just before
    and read just after, on the host clock and with the bytes its processes
    exchanged; then its device time a step under the profiler (the slope
    between 2 and 4 steps). Returns (record, global x)."""
    import torch

    torch.cuda.synchronize()
    sent0 = route.mesh.sent_bytes
    reset_counts()
    t0 = time.perf_counter()
    res = route.solve()
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    sent = route.mesh.sent_bytes - sent0
    steps = int(route.steps_of(res))
    busy, events, _ = device_per_cycle(route.run, 2, 4)
    k = max(steps, 1)
    rec = {"steps": steps, "solve_s": solve_s, "host_ms": solve_s / k * 1e3,
           "device_ms": busy, "events": events, "sent_bytes_per_step": sent / k,
           "counts": counts, **route.extra(res)}
    return rec, route.x_of(res)


def p20_inputs(keep, tmp, device):
    """The parent's half before the workers start: the shared host inputs
    written to `tmp`, and the one-process 8-shard run of every route that
    phases 18 / 19 did not run (their x to `tmp` as .npy). Returns the
    one-process records."""
    import pickle

    import torch

    from amg_tpu_torch.setup.hierarchy import build_host_hierarchy
    from amg_tpu_torch.utils.config import SolverOptions
    from amg_tpu_torch.utils.runner import build_problem, hierarchy_params, setup_experiment

    t0 = time.perf_counter()
    acfg = keep["async_acfg"]
    ctx = {"hh": keep["hh"], "b": keep["b"],
           "acfg": {f: getattr(acfg, f) for f in acfg.__dataclass_fields__}}
    # the beam's host hierarchy (the runner's sharded setup builds it so,
    # and its b as the runner makes it from the beam's load)
    opts = SolverOptions(**P20_BEAM_OPTS)
    opts.fixup()
    prob = build_problem(opts)
    params = hierarchy_params(opts)
    t1 = time.perf_counter()
    beam_hh = build_host_hierarchy(prob.A, params)
    rhs = np.asarray(prob.rhs)
    ctx.update(beam_hh=beam_hh, beam_params=params, beam_b=rhs / np.linalg.norm(rhs))
    log(f"  the beam's host hierarchy ({prob.n} dofs, levels "
        f"{[lv.A.n_rows for lv in beam_hh.levels]}): {time.perf_counter() - t1:.2f} s")
    # the runner's structured setup at 126^3: its host arrays (phase 17's,
    # whose options differ only in num_devices)
    if "struct arrays" in keep:
        ctx["struct_arrays"] = keep["struct arrays"]
    else:
        exp = setup_experiment(SolverOptions(**dict(P20_STRUCT_OPTS, only_setup=True)), "cpu")
        ctx["struct_arrays"] = exp.hh.arrays
        del exp
    # the identity-BC beam's structured set-up as the runner makes it on 8
    # shards: its host arrays, the float64 outer operator's planes and b
    t1 = time.perf_counter()
    exp = setup_experiment(SolverOptions(**dict(P20_DIA_OPTS, only_setup=True)), "cpu")
    rhs = np.asarray(exp.prob.rhs)
    ctx["dia"] = {"arrays": exp.hh.arrays, "coeffs": exp.A_acc.coeffs.numpy(),
                  "offsets": exp.A_acc.offsets, "grid_shape": exp.A_acc.grid_shape,
                  "b": rhs / np.linalg.norm(rhs)}
    log(f"  the identity-BC beam {P20_DIA_OPTS['nx']}x{P20_DIA_OPTS['ny']}x"
        f"{P20_DIA_OPTS['nz']} ({exp.prob.n} dofs): set-up {time.perf_counter() - t1:.2f} s")
    del exp, prob
    log_layouts(ctx)
    with open(os.path.join(tmp, "ctx.pkl"), "wb") as f:
        pickle.dump(ctx, f, protocol=pickle.HIGHEST_PROTOCOL)
    log(f"  shared inputs written in {time.perf_counter() - t0:.1f} s")
    from amg_tpu_torch.parallel import make_row_mesh

    mesh = make_row_mesh(MULTI_D, device)
    one = {}
    earlier = {"gspmd": "gspmd x", "extended": "ext x"}  # phases 18 and 19's runs
    for route in p20_routes(ctx, mesh, device):
        name = route.name
        t1 = time.perf_counter()
        rec, x = p20_measure(route)
        del route
        torch.cuda.empty_cache()
        if earlier.get(name) in keep:
            # the workers are held to the earlier phase's x; this run of the
            # same options must equal it
            want = keep[earlier[name]]
            rec["dx_earlier_phase"] = float(np.linalg.norm(x - want) / np.linalg.norm(want))
            x = want
        np.save(os.path.join(tmp, f"x {name}.npy"), x)
        one[name] = rec
        log(f"  one process, 8 shards, {name}: {rec['steps']} steps; host "
            f"{rec['host_ms']:.3f} ms, device {rec['device_ms']:.3f} ms, "
            f"{rec['events']:.1f} events a step; {time.perf_counter() - t1:.1f} s"
            + (f"; |x - x_phase|/|x_phase| {rec['dx_earlier_phase']:.3e}"
               if "dx_earlier_phase" in rec else ""))
    del ctx
    torch.cuda.empty_cache()
    return one


def log_layouts(ctx):
    """The layout of each level of the structured routes across 2 processes
    (`structured_layout`: the plane halo where a level's leading axis splits
    over the 8 shards)."""
    import torch

    from amg_tpu_torch.convert import operator_from_arrays
    from amg_tpu_torch.parallel.dist import RowMesh, structured_layout

    mesh = RowMesh(n_devices=MULTI_D, device=torch.device("cpu"), rank=0,
                   world_size=P20_WORKERS)
    for name, (levels, _) in ((f"{N_SIDE}^3 structured", ctx["struct_arrays"]),
                              ("identity-BC beam", ctx["dia"]["arrays"])):
        lay = []
        for lv in levels:
            A = operator_from_arrays(lv["A"], torch.float64, "cpu")
            lay.append(f"{tuple(A.grid_shape)} {structured_layout(A, mesh)}")
        log(f"  {name} levels across {P20_WORKERS} processes: " + ", ".join(lay))


def p20_worker(rank, world, port, backend, tmp) -> int:
    """One worker process of phase 20: joins the group, runs every route on
    its 4 of the 8 shards, compares the global x with the one-process run's
    and prints one "P20 <json>" line."""
    import pickle

    import torch

    from amg_tpu_torch.parallel import init_multihost, make_row_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    n_cards = torch.cuda.device_count()
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    init_multihost(f"localhost:{port}", world, rank, device=device, backend=backend)
    mesh = make_row_mesh(MULTI_D, device)
    log(f"worker {rank} of {world}: backend {torch.distributed.get_backend()}, device "
        f"{device} ({torch.cuda.get_device_name(device)}, {n_cards} visible), shards "
        f"{mesh.first_shard}-{mesh.first_shard + mesh.local_devices - 1}, host-staged "
        f"collectives {mesh.staged}")
    with open(os.path.join(tmp, "ctx.pkl"), "rb") as f:
        ctx = pickle.load(f)
    out = {"rank": rank, "device": str(device), "backend": torch.distributed.get_backend(),
           "staged": mesh.staged, "routes": {}}
    t0 = time.perf_counter()
    for route in p20_routes(ctx, mesh, device):
        name = route.name
        log(f"worker {rank} {name}: set up at {time.perf_counter() - t0:.1f} s")
        rec, x = p20_measure(route)
        del route
        torch.cuda.empty_cache()
        want = np.load(os.path.join(tmp, f"x {name}.npy"))
        rec["dx"] = float(np.linalg.norm(x - want) / np.linalg.norm(want))
        out["routes"][name] = rec
        log(f"worker {rank} {name}: {rec['steps']} steps, |x - x_1|/|x_1| {rec['dx']:.3e}, "
            f"solved at {time.perf_counter() - t0:.1f} s")
    torch.distributed.destroy_process_group()
    print("P20 " + json.dumps(out), flush=True)
    return 0


def routes_phase(device, keep):
    """Phase 20 on `device`: the one-process runs, then P20_WORKERS workers
    of this script on the card(s); each route's steps, x and counters
    against the one-process run. Returns (record, failures)."""
    import socket
    import tempfile

    import torch

    t_phase = time.perf_counter()
    fails, rec = [], {}
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= P20_WORKERS else "gloo"
    log(f"routes across processes: {P20_WORKERS} workers, backend {backend} ("
        f"{n_cards} card(s) visible: " + ("one card a process" if backend == "nccl" else
                                          "both processes on cuda:0, host-staged gloo") + ")")
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        one = p20_inputs(keep, tmp, device)
        rec["one process"] = one
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            port = sk.getsockname()[1]
        # the workers share the host's cores; the rendezvous and gloo stay on
        # the loopback interface
        threads = str(max(1, (os.cpu_count() or 2) // P20_WORKERS))
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", NCCL_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS=threads, OPENBLAS_NUM_THREADS=threads,
                   MKL_NUM_THREADS=threads)
        logs = [open(os.path.join(tmp, f"worker {r}.log"), "w+") for r in range(P20_WORKERS)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--p20-worker",
                                   str(r), str(P20_WORKERS), str(port), backend, tmp],
                                  stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=ROOT)
                 for r in range(P20_WORKERS)]
        try:
            for p in procs:
                p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            fails.append("phase 20: a worker did not finish within 600 s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        rec["workers_s"] = time.perf_counter() - t0
        results = []
        for r, f in enumerate(logs):
            f.seek(0)
            text = f.read()
            f.close()
            for ln in text.splitlines():
                if ln.startswith("P20 "):
                    results.append(json.loads(ln[4:]))
                else:
                    log(f"  [worker {r}] {ln}")
            if procs[r].returncode != 0:
                fails.append(f"phase 20: worker {r} exited {procs[r].returncode}")
    if len(results) != P20_WORKERS:
        fails.append("phase 20: not every worker printed its result")
        return rec, fails
    rec["workers"] = results
    for name in P20_ROUTES:
        o = one[name]
        # exact where every level computes its rows as one process does;
        # the Krylov band under PCG
        band = (0.0 if name in P20_EXACT else
                1e-10 if name in ("hybrid_jgs beam", "structured dia mixed") else 1e-12)
        for w in results:
            r = w["routes"][name]
            log(f"{name} across {P20_WORKERS} processes ({w['backend']}, {w['device']}, staged "
                f"{w['staged']}), worker {w['rank']}: steps {r['steps']} (one process "
                f"{o['steps']}), |x - x_1|/|x_1| {r['dx']:.3e}; host {r['host_ms']:.3f} ms, "
                f"device {r['device_ms']:.3f} ms, {r['events']:.1f} events a step (one process "
                f"{o['host_ms']:.3f} / {o['device_ms']:.3f}"
                f" ms); {r['sent_bytes_per_step']:.0f} bytes sent to the other process a step; "
                f"launches {r['counts']}")
            if r["steps"] != o["steps"] or not r["dx"] <= band:
                fails.append(f"phase 20 {name}: worker {w['rank']} not the one-process steps "
                             f"or x within {band}")
            if any(ported_launches(r["counts"]).values()):
                fails.append(f"phase 20 {name}: a kernel was launched {r['counts']}")
            if name == "cheby power" and not np.allclose(r["bounds"], o["bounds"], rtol=1e-12,
                                                         atol=0):
                fails.append("phase 20 cheby power: not the one-process bounds")
            if name == "async_smooth" and not np.allclose(r["history"], o["history"],
                                                          rtol=0, atol=1e-12):
                fails.append("phase 20 async_smooth: not the one-process history")
        if any(ported_launches(o["counts"]).values()):
            fails.append(f"phase 20 {name}: a kernel was launched in one process {o['counts']}")
        if not o.get("dx_earlier_phase", 0.0) <= 1e-15:
            fails.append(f"phase 20 {name}: the one-process run is not phase 18's / 19's")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"routes phase: {rec['phase_s']:.1f} s (workers {rec['workers_s']:.1f} s)")
    return rec, fails


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import amg_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False  # coarse_Ainv product, full f32
    torch.backends.cudnn.allow_tf32 = False  # conv3d yardstick in full f32
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = toolchain()
    build()
    # the native setup library (g++): the structured and DIA setups' RAP
    # and the generic path's whole host setup run through it; built here so
    # that no setup time below includes its compile
    from amg_tpu_torch import native_backend

    t0 = time.perf_counter()
    native_backend.build()
    log(f"native setup library built in {time.perf_counter() - t0:.1f} s")

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.problems.elasticity import elasticity_beam
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.structured import build_structured_hierarchy, csr_to_dia_stencil
    from amg_tpu_torch.smooth.smoothers import SmootherType
    from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
    from amg_tpu_torch.solve.struct_cycle import struct_solve

    t0 = time.perf_counter()
    prob = laplacian_3d_27pt(N_SIDE)
    hh, hier64 = build_structured_hierarchy(
        prob.stencil, smoother=SmootherType.L1_JACOBI, dtype=torch.float64, device=device
    )
    hier32 = hierarchy_from_arrays(*hh.arrays, dtype=torch.float32, device=device)
    log(f"setup {time.perf_counter() - t0:.1f} s: levels "
        f"{[(lv.A.grid_shape, type(lv.A).__name__) for lv in hier64.levels]}")

    log("kernel phase:")
    errs, fails = kernel_phase(hier64, device)
    log("K2 phase:")
    errs2, fails2 = k2_phase(device)
    errs += errs2
    fails += fails2
    if fails:
        log("kernel phase FAILED:", fails)
        return 1

    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = np.random.default_rng(0).random(prob.n)
    b32 = torch.from_numpy(b).to(device=device, dtype=torch.float32)

    # main path, V(1,1): the counts are reset just before and read just after
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = struct_solve(hier32, cfg, b32, tol=1e-5, max_cycles=40, device=device)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = read_counts()
    x32 = res.x.double().cpu().numpy()
    rel32 = float(res.rel_resnorm)
    true32 = true_rel_residual(prob, x32, b)
    log(f"float32 solve {N_SIDE}^3: cycles {res.iters}, rel_res {rel32:.4e}, "
        f"true rel_res (float64 CSR) {true32:.4e}, {solve_s:.3f} s")
    log("history", [float(f"{h:.6e}") for h in res.history_list()])
    log("launches", counts)
    if not (11 <= res.iters <= 13 and rel32 <= 1e-4 and np.isfinite(x32).all()):
        log("float32 solve FAILED (needs 11-13 cycles to rel_res <= 1e-4)")
        return 1
    # the float32 iterate's own rounding puts a floor of ~1e-5 under its
    # true residual, so the float64 check is an order-of-magnitude guard
    if not true32 <= 1e-3:
        log("float32 solve FAILED: the float64 residual of x exceeds 1e-3")
        return 1
    if min(counts[k] for k in ("K1", "K3", "K4")) == 0:
        log("main path FAILED: a kernel was never launched", counts)
        return 1
    if counts["K3"] != 3 * res.iters or counts["K4"] != 3 * res.iters or counts["K1"] < res.iters:
        log("main path FAILED: launches per cycle are not K1 >= 1, K3 = 3, K4 = 3")
        return 1

    b64 = torch.from_numpy(b).to(device)
    res64 = struct_solve(hier64, cfg, b64, tol=1e-8, max_cycles=40, device=device)
    x_ref, it_ref, hist_ref = plain_solve(hier64, cfg, b64, 1e-8, 40)
    dx = float(torch.linalg.norm(res64.x - x_ref) / torch.linalg.norm(x_ref))
    log(f"float64 solve: cycles {res64.iters} (plain composition {it_ref}), rel_res "
        f"{float(res64.rel_resnorm):.4e}, |x - x_plain|/|x_plain| {dx:.3e}")
    if res64.iters != it_ref or dx > 1e-10 or float(res64.rel_resnorm) > 1e-8:
        log("float64 solve FAILED against the plain composition")
        return 1

    log("V(3,3) path:")
    v33, f33 = v33_phase(hier32, hier64, b, device)
    if f33:
        log("V(3,3) path FAILED:", f33)
        return 1

    log("elasticity operators:")
    t0 = time.perf_counter()
    operators = {}
    for name, cells in (("157k", BEAM), ("362k", BEAM_LARGE)):
        p_el = elasticity_beam(*cells, bc="identity")
        operators[name] = (p_el, csr_to_dia_stencil(p_el.A, p_el.grid_shape))
        log(f"  {name}: elasticity_beam{cells} {p_el.n} dofs, DIA grid "
            f"{p_el.grid_shape}, {len(operators[name][1].offsets)} diagonals")
    log(f"  generated in {time.perf_counter() - t0:.1f} s")
    log("K5 phase:")
    errs5, fails5, t5 = k5_phase(device, operators)
    errs += errs5
    if fails5:
        log("K5 phase FAILED:", fails5)
        return 1
    del operators["362k"]
    log("elasticity path:")
    el, fel = elasticity_phase(device, *operators["157k"])
    if fel:
        log("elasticity path FAILED:", fel)
        return 1
    eref = load_json(ELAST_REF)
    log("elasticity path, hybrid JGS (the JAX bench's production smoother):")
    jgs, fjgs = elasticity_phase(device, *operators["157k"], smoother_name="hybrid_jgs",
                                 ref=eref["jgs"])
    if fjgs:
        log("hybrid JGS elasticity path FAILED:", fjgs)
        return 1
    log("elasticity path, bf16 sweep planes:")
    el16, fel16 = elasticity_bf16_phase(device, errs)
    if fel16:
        log("bf16 elasticity path FAILED:", fel16)
        return 1
    del operators
    log("goldens config10 / config11 on the card:")
    gdia, fgdia = golden_dia_phase(device)
    if fgdia:
        log("goldens config10 / config11 FAILED:", fgdia)
        return 1
    log("smoothed aggregation:")
    sa, fsa = sa_phase(device, eref["sa"])
    if fsa:
        log("SA path FAILED:", fsa)
        return 1
    log("AMS:")
    amsr, fams = ams_phase(device, eref["ams"])
    if fams:
        log("AMS path FAILED:", fams)
        return 1
    log("generic AMG path:")
    keep = {}  # phase 10's 96^3 host hierarchy and solves, for phases 18 and 19
    gen, fgen = generic_phase(device, keep)
    if fgen:
        log("generic AMG path FAILED:", fgen)
        return 1
    log("the drivers (run_experiment, the CLI):")
    drv, fdrv = drivers_phase(device, keep)
    if fdrv:
        log("drivers phase FAILED:", fdrv)
        return 1
    log("the row-partitioned multi-device path (8 shards on one card):")
    multi, fmulti = multidevice_phase(device, keep, eref["ams"])
    if fmulti:
        log("multi-device phase FAILED:", fmulti)
        return 1
    log("grid (level) parallelism (8 shards' level groups on one card):")
    grid, fgrid = grid_phase(device, keep)
    if fgrid:
        log("grid phase FAILED:", fgrid)
        return 1
    log("the routes across processes:")
    routes, froutes = routes_phase(device, keep)
    if froutes:
        log("routes phase FAILED:", froutes)
        return 1
    del keep

    cycle = cycle_phase(hier32, cfg, b32, device)
    timings = timing_phase(hier32, device, counts, res.iters)
    t2 = k2_timing(device)
    timings["K2"] = t2[f"sweep2_vec {N_SIDE}"]
    timings["K5"] = t5[("spmv", "157k", "float64")]
    timings["K1 taps"] = timings["K1 taps level 1 float32"]
    timings["K5 bf16 sweep"] = t5[("sweep bf16", "157k", "float32")]
    # each path's counts: K1 (the box march), K3 and K4 of the V(1,1) solve;
    # K1's tap-list route and K2 of the V(3,3) float32 solve (K2: 0 where the
    # port routes its box sweeps as K1 launches, on the card, where that is
    # faster); K5 of the elasticity solve, and its bf16-plane sweeps of the
    # bf16 solve (BEAM_BF16)
    launches = dict(counts, K2=max(r["counts"]["K2"] for r in v33.values()),
                    K5=el["counts"]["K5"])
    launches["K1 taps"] = v33["float32"]["counts"]["K1 taps"]
    launches["K5 bf16 sweep"] = el16["counts"]["K5 bf16"]

    sources = {
        "K1": ("amg_tpu_torch/csrc/box_march.cu", "amg_tpu/ops/pallas_stencil.py:269"),
        "K1 taps": ("amg_tpu_torch/csrc/tap_march.cu", "amg_tpu/ops/pallas_stencil.py:269"),
        "K2": ("amg_tpu_torch/csrc/box_march.cu", "amg_tpu/ops/pallas_stencil.py:82"),
        "K3": ("amg_tpu_torch/csrc/transfer.cu", "amg_tpu/ops/pallas_transfer.py:181"),
        "K4": ("amg_tpu_torch/csrc/prolong_march.cu", "amg_tpu/ops/pallas_transfer.py:404"),
        "K5": ("amg_tpu_torch/csrc/var_stencil.cu", "amg_tpu/ops/pallas_var_stencil.py:98"),
        "K5 bf16 sweep": ("amg_tpu_torch/csrc/var_stencil.cu",
                          "amg_tpu/ops/pallas_var_stencil.py:98"),
    }
    # the errors each entry carries: K1 on the box, K1 on tap lists (the RAP
    # taps and their reversal), K5 on its own planes, K5's sweep on bf16 planes
    picks = {
        "K1": lambda n: n.startswith("K1 ") and " box " in n,
        "K1 taps": lambda n: n.startswith("K1 ") and " box " not in n,
        "K5": lambda n: n.startswith("K5 ") and "bf16" not in n,
        "K5 bf16 sweep": lambda n: n.startswith("K5 bf16"),
    }
    # what each entry's time is of: K1 sweep_vec_norm (the box march), K3 and
    # K4 at 126^3 float32 (the V(1,1) path); K1's tap-list route sweep_vec at
    # 63^3 float32 (the V(3,3) path's RAP level); K2 sweep2_vec at 126^3
    # float32 (the V(3,3) path); K5 spmv at 157k float64 (the PCG matvec of the
    # elasticity path) and its bf16-plane sweep at 157k, float32 state
    kernels = []
    for name, (src, rep) in sources.items():
        pick = picks.get(name, lambda n, name=name: n.startswith(name + " "))
        mine = [e for e in errs if pick(e[0]) and e[1] == "float32"]
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[name], "max_abs_err": max(e[2] for e in mine),
            "max_rel_err": max(e[3] for e in mine), "pass": all(e[4] for e in mine),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    # the ELL kernel, which replaces no TPU kernel (the reference's ELL is
    # plain jnp): its time on the SA beam's level-0 A in float64 (the PCG
    # matvec of the benchmark's beam cell), its launches on the float64
    # SA-PCG solve, its errors against its plain version on every operator
    # spmv_timing ran (relative to max_i sum_j |a_ij x_j|), both dtypes
    ell_rows = list(sa["spmv"].values()) + list(gen["spmv"].values())
    a0 = sa["spmv"]["SA beam level 0 A float64"]
    kernels.append({
        "name": "ELL", "route": "cuda", "source": "amg_tpu_torch/csrc/ell_spmv.cu",
        "replaces": None, "launches": sa["counts"]["ELL"],
        "max_abs_err": max(r["ell_err_vs_plain"] for r in ell_rows),
        "max_rel_err": max(r["ell_err_vs_plain"] / r["ell_scale"] for r in ell_rows),
        "pass": all(r["ell_pass"] for r in ell_rows),
        "ms": a0["ell_ms"], "plain_ms": a0["ell_plain_ms"], "bound_ms": a0["bound_ms"],
        "bound_by": "bytes", "library_ms": a0["cusparse_ms"],
    })
    log(json.dumps({"card": card, "n": prob.n, "cycles": res.iters, "rel_res": rel32,
                    **cycle}))
    log(json.dumps({"v33": v33}))
    log(json.dumps({"elasticity": el}))
    log(json.dumps({"elasticity_bf16": el16}))
    log(json.dumps({"elasticity_jgs": jgs}))
    log(json.dumps({"goldens_dia": gdia}))
    log(json.dumps({"sa": sa}))
    log(json.dumps({"ams": amsr}))
    log(json.dumps({"generic": gen}))
    log(json.dumps({"drivers": drv}))
    log(json.dumps({"multidevice": multi}))
    log(json.dumps({"grid": grid}))
    log(json.dumps({"routes": routes}))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--p20-worker"]:
        rank, world, port = (int(a) for a in sys.argv[2:5])
        sys.exit(p20_worker(rank, world, port, sys.argv[5], sys.argv[6]))
    sys.exit(main())
