#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`amg_tpu_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases (any failure exits non-zero and prints no result line):
  1. toolchain: torch, CUDA, nvcc, triton; the card's name and power limit;
  2. build: compiles every kernel of the main path from `amg_tpu_torch/csrc`;
  3. kernels: K1 (all five modes), K3 and K4 (both zero_guess modes, scale
     and alpha) against their plain PyTorch versions on the card, at 126^3
     and at the coarse shapes 63^3 and 32^3 with the real RAP taps, in
     float32 (max relative error <= 1e-5 on the interior) and float64
     (<= 1e-12), shells exactly 0;
  4. main path: `struct_solve` of the 27-point Laplacian at 126^3
     (2,000,376 dofs), V(1,1) L1-Jacobi, b = default_rng(0).random(n),
     float32, tol 1e-5 — must take 11-13 cycles to rel_res <= 1e-4 — with
     every kernel's launch counter set to 0 just before and read just after;
  5. the same solve in float64 to tol 1e-8, held against the plain
     composition (a loop of `mult_vcycle`, no custom kernel) on the card: the
     same cycle count and x within 1e-10 relative;
  6. timing with CUDA events: the per-cycle time of `struct_timed_cycles`
     (slope between two cycle counts) and each kernel at its 126^3 shape,
     beside its plain version, its DRAM byte bound and, for K1, the
     `torch.nn.functional.conv3d` yardstick.
The last two lines are the `kernels` JSON object and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

N_SIDE = 126
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores
TOL = {"float32": 1e-5, "float64": 1e-12}


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
    torch.cuda.synchronize()
    fails = [f for f in fails if f]
    return errs, fails


def reset_counts():
    from amg_tpu_torch.ops.stencil import stencil_kernel_padded
    from amg_tpu_torch.ops.transfer import prolong_sweep_padded, residual_restrict_padded

    for fn in (stencil_kernel_padded, residual_restrict_padded, prolong_sweep_padded):
        fn.launches = 0


def read_counts():
    from amg_tpu_torch.ops.stencil import stencil_kernel_padded
    from amg_tpu_torch.ops.transfer import prolong_sweep_padded, residual_restrict_padded

    return {
        "K1": stencil_kernel_padded.launches,
        "K3": residual_restrict_padded.launches,
        "K4": prolong_sweep_padded.launches,
    }


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
    from torch.profiler import ProfilerActivity, profile

    from amg_tpu_torch.solve.struct_cycle import struct_timed_cycles

    def run(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        struct_timed_cycles(hier32, cfg, b32, k, device=device)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    k0, k1 = 10, 60
    run(k0)
    s0 = [run(k0) for _ in range(3)]
    s1 = [run(k1) for _ in range(3)]
    cycle_ms = (min(s1) - min(s0)) / (k1 - k0) * 1e3
    log(f"per-cycle time (struct_timed_cycles slope {k0}->{k1}, float32): {cycle_ms:.4f} ms; "
        f"samples {k0}: {[round(t * 1e3, 3) for t in s0]} ms, "
        f"{k1}: {[round(t * 1e3, 3) for t in s1]} ms")

    def device_times(k):
        """{event name: (device ms, count)} of one run of k cycles: kernel and
        memory events only (a CPU op's device time repeats its kernels)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            struct_timed_cycles(hier32, cfg, b32, k, device=device)
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            out[e.key] = (us / 1e3, e.count)
        return out

    p0, p1 = device_times(10), device_times(20)
    rows = []
    for key, (ms, n) in p1.items():
        ms0, n0 = p0.get(key, (0.0, 0))
        rows.append(((ms - ms0) / 10, (n - n0) / 10, key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    events = sum(r[1] for r in rows)
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

    from amg_tpu_torch.ops.stencil import stencil_kernel_padded, stencil_plain, taps_of
    from amg_tpu_torch.ops.transfer import (
        coarse_shape_of,
        prolong_sweep_padded,
        prolong_sweep_plain,
        residual_restrict_padded,
        residual_restrict_plain,
    )
    from amg_tpu_torch.solve.struct_cycle import make_struct_spec

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
    coarse_bytes = sets[0][2].numel() * 4
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
    k3_bytes = 2 * state_bytes + coarse_bytes  # u, b in; rc out
    k3_flops = 2 * nt * pts + pts + 2 * 27 * int(np.prod(cs))
    results["K3"] = dict(
        ms=cuda_time(lambda i: residual_restrict_padded(
            sets[i % 4][0], sets[i % 4][1], w, gs, off), 50),
        plain_ms=cuda_time(lambda i: residual_restrict_plain(
            sets[i % 4][0], sets[i % 4][1], taps, gs), 10),
        library_ms=None, bytes=k3_bytes, flops=k3_flops,
    )
    k4_bytes = 4 * state_bytes + coarse_bytes  # x, b, s, ec in; out
    k4_flops = 2 * nt * pts + 4 * pts + 2 * 8 * pts
    results["K4"] = dict(
        ms=cuda_time(lambda i: prolong_sweep_padded(
            sets[i % 4][0], sets[i % 4][1], sets[i % 4][2], w, gs, off, scale_pad=s), 50),
        plain_ms=cuda_time(lambda i: prolong_sweep_plain(
            sets[i % 4][0], sets[i % 4][1], sets[i % 4][2], taps, gs, 0.0, s), 10),
        library_ms=None, bytes=k4_bytes, flops=k4_flops,
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
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import amg_tpu_torch  # noqa: F401  (fails outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False  # coarse_Ainv product, full f32
    torch.backends.cudnn.allow_tf32 = False  # conv3d yardstick in full f32
    device = torch.device("cuda", 0)
    card = toolchain()
    build()

    from amg_tpu_torch.convert import hierarchy_from_arrays
    from amg_tpu_torch.problems.laplacian import laplacian_3d_27pt
    from amg_tpu_torch.setup.structured import build_structured_hierarchy
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
    if fails:
        log("kernel phase FAILED:", fails)
        return 1

    cfg = CycleConfig(cycle=CycleType.MULT, smoother=SmootherType.L1_JACOBI)
    b = np.random.default_rng(0).random(prob.n)
    b32 = torch.from_numpy(b).to(device=device, dtype=torch.float32)

    # main path: the counts are reset just before and read just after
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
    if min(counts.values()) == 0:
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

    cycle = cycle_phase(hier32, cfg, b32, device)
    timings = timing_phase(hier32, device, counts, res.iters)

    sources = {
        "K1": ("amg_tpu_torch/csrc/stencil.cu", "amg_tpu/ops/pallas_stencil.py:269"),
        "K3": ("amg_tpu_torch/csrc/transfer.cu", "amg_tpu/ops/pallas_transfer.py:181"),
        "K4": ("amg_tpu_torch/csrc/transfer.cu", "amg_tpu/ops/pallas_transfer.py:404"),
    }
    kernels = []
    for name, (src, rep) in sources.items():
        mine = [e for e in errs if e[0].startswith(name) and e[1] == "float32"]
        t = timings[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": counts[name], "max_abs_err": max(e[2] for e in mine),
            "max_rel_err": max(e[3] for e in mine), "pass": all(e[4] for e in mine),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    log(json.dumps({"card": card, "n": prob.n, "cycles": res.iters, "rel_res": rel32,
                    **cycle}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
