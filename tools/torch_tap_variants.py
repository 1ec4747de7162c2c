#!/usr/bin/env python3
"""What bounds K1's tap-list route (amg_tpu_torch/csrc/tap_march.cu) on the
card: time its sweep_vec at the V(3,3) path's RAP levels, 63^3 and 32^3
(27 distinct taps in product order, a per-point scale), in float32 and
float64, beside diagnostic builds of the same source that each drop or change
one part of a z-step, and under other launch plans.

    python3 tools/torch_tap_variants.py                  # from the repository root, one GPU
    python3 tools/torch_tap_variants.py --parent DIR     # also time DIR's K1 tap kernel

Variants (text edits of tap_march.cu, built into the git-ignored
amg_tpu_torch/_build/variants_taps/; the port never loads them):
  full        the kernel as it is (also held bit for bit against the plain
              version); also timed on its route for any tap list (the same
              taps), and under z-chunks other than k1_taps_plan's;
  no-copies   the cp.async copies removed (the rings hold whatever is
              there): the compute and the barriers alone;
  no-compute  the product-order sums replaced by a copy of the last value
              loaded (the copies, the barriers and the stores remain);
  one-plane   the product-order route sums the 9 taps of plane n only:
              what the other 18 cost;
  plane-a-step  one output plane a step (the upper four warps idle),
              so one barrier a plane instead of one per two planes;
  ahead-2/3   two or three steps of copies in flight instead of one (also
              timed under the other plans).
With --parent DIR (an unpacked tree of an earlier commit whose
amg_tpu_torch/csrc/stencil.cu holds the one-thread-per-point K1 tap kernel),
that kernel is built from DIR and timed on the same inputs, in turns with
`full`. Each is timed with chip_smoke's CUDA-event timer over four input sets
cycled past the L2, in two turns.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from amg_tpu_torch.ops import _build  # noqa: E402
from amg_tpu_torch.ops import stencil as ts  # noqa: E402

COPIES = (("cp_async16(win + slot<kWSlots>(p) * kPlane + tid * kV, u + (v ? p * sp + soff : 0), v);",
           "(void)v;"),
          ("cp_async16(tile + tdst + slot<kTSlots>(p) * kTPlane, tsrc + (v ? p * sp + toff : 0), v);",
           "(void)v;"))
COMPUTE = (("acc[0] = add_rn(acc[0], mul_rn(w, v[dy][dx]));", "acc[0] = v[dy][dx]; (void)w;"),
           ("acc[1] = add_rn(acc[1], mul_rn(w, v[dy + 1][dx]));", "acc[1] = v[dy + 1][dx];"))
TAPS = (("for (int dz = 0; dz < 3; ++dz) {", "for (int dz = 1; dz < 2; ++dz) {"),)
PLANES = "constexpr int kP = 2;"
AHEAD = "constexpr int kAhead = 1;"
MODE = ts.MODES.index("sweep_vec")
# the C entry of the earlier one-thread-per-point kernel (csrc/stencil.cu)
PARENT_SIGNATURE = (
    ctypes.c_int,
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_double)]
    + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_int] * 8 + [ctypes.c_double, ctypes.c_void_p],
)


def edit(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"tap_march.cu no longer has {old!r}")
        src = src.replace(old, new)
    return src


def variants(src):
    return {
        "full": src,
        "no-copies": edit(src, COPIES),
        "no-compute": edit(src, COMPUTE),
        "one-plane": edit(src, TAPS),
        "plane-a-step": edit(src, [(PLANES, PLANES.replace("2", "1"))]),
        "ahead-2": edit(src, [(AHEAD, AHEAD.replace("1", "2"))]),
        "ahead-3": edit(src, [(AHEAD, AHEAD.replace("1", "3"))]),
    }


def build(root, texts, common):
    """{name: C entry}: one nvcc per text, all at once; prints each build's
    registers by (dtype, route, mode)."""
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(common, root / "common.cuh")
    procs = {}
    for name, text in texts.items():
        (root / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, "-o", str(root / f"{name}.so"),
             str(root / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{out[-3000:]}")
        regs, entry = [], "?"
        for line in out.splitlines():
            m = re.search(r"kernelI([fd])Li(\d)ELi(\d)E", line)
            if m:
                entry = f"{m[1]}{('list', '', 'dense27')[int(m[2])]}{m[3]}"
            elif "Used " in line:
                regs.append(f"{entry}:{line.split('Used ')[1].split(' registers')[0]}")
        print(f"  {name}: registers (dtype, route, mode 0-4) {' '.join(regs)}", flush=True)
        lib = ctypes.CDLL(str(root / f"{name}.so"))
        if name == "parent":
            f = lib.amg_k1_launch
            f.restype, f.argtypes = PARENT_SIGNATURE
        else:
            f = lib.amg_k1_taps_launch
            f.restype, f.argtypes = ts._TAP_SIGNATURES["amg_k1_taps_launch"]
        entries[name] = f
    return entries


def launch(entry, dev, sets, taps, gs, plan, i, route=None):
    u, b, s = sets[i % 4]
    out = torch.empty_like(u)
    w, dz, dy, dx, n = ts.tap_arrays(taps)
    zchunk, grid = plan
    _build.launch(entry, "K1 tap variant", dev, int(u.dtype == torch.float64), u.data_ptr(),
                  b.data_ptr(), s.data_ptr(), out.data_ptr(), None, w, dz, dy, dx, n,
                  ts.tap_route(taps) if route is None else route, *gs, *u.shape, MODE, *grid,
                  zchunk, 0.0)
    return out


def launch_parent(entry, dev, sets, taps, gs, i):
    u, b, s = sets[i % 4]
    out = torch.empty_like(u)
    w, dz, dy, dx, n = ts.tap_arrays(taps)
    _build.launch(entry, "parent K1 tap kernel", dev, int(u.dtype == torch.float64),
                  u.data_ptr(), b.data_ptr(), s.data_ptr(), out.data_ptr(), None, w, dz, dy,
                  dx, n, *gs, *u.shape, MODE, 0.0)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="tree whose csrc/stencil.cu to time beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_tap_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.toolchain()
    src = (_build.CSRC / "tap_march.cu").read_text()
    entries = build(_build.BUILD_DIR / "variants_taps", variants(src), _build.CSRC / "common.cuh")
    if args.parent is not None:
        pcsrc = args.parent / "amg_tpu_torch" / "csrc"
        entries.update(build(_build.BUILD_DIR / "variants_taps_parent",
                             {"parent": (pcsrc / "stencil.cu").read_text()},
                             pcsrc / "common.cuh"))
    rng = np.random.default_rng(cs.SEED)
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    w = -rng.random(27)
    w[13] = 30.0
    taps = ts.taps_of(tuple(float(x) for x in w), offs)
    for dtype in (torch.float32, torch.float64):
        dn = str(dtype).split(".")[-1]
        for gs in ((63,) * 3, (32,) * 3):
            sets = [(cs.rand_pad(rng, gs, dtype, dev), cs.rand_pad(rng, gs, dtype, dev),
                     0.02 * cs.rand_pad(rng, gs, dtype, dev)) for _ in range(4)]
            plan = ts.k1_taps_plan(gs)
            u, b, s = sets[0]
            want = ts.stencil_plain(u, b, taps, gs, 0.0, s, "sweep_vec")
            exact = {r: bool(torch.equal(launch(entries["full"], dev, sets, taps, gs, plan, 0,
                                                route=r), want)) for r in (0, 2)}
            nbytes = 4 * u.numel() * u.element_size()
            print(f"K1 tap list sweep_vec at {gs} {dn}, plan {plan}: full equal to the plain "
                  f"version bit for bit (list route, product-order route): {exact}; byte bound "
                  f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB)",
                  flush=True)
            if not all(exact.values()):
                return 1
            names = [n for n in entries if n != "parent"] if dtype == torch.float32 else ["full"]
            for turn in (1, 2):
                for name in names:
                    ms = cs.cuda_time(
                        lambda i, e=entries[name]: launch(e, dev, sets, taps, gs, plan, i), 50)
                    print(f"  turn {turn} {name:14s} {ms:.4f} ms", flush=True)
                ms = cs.cuda_time(lambda i: launch(entries["full"], dev, sets, taps, gs, plan, i,
                                                   route=0), 50)
                print(f"  turn {turn} full, the route for any tap list: {ms:.4f} ms", flush=True)
                if "parent" in entries:
                    ms = cs.cuda_time(lambda i: launch_parent(entries["parent"], dev, sets, taps,
                                                              gs, i), 50)
                    print(f"  turn {turn} parent's kernel (csrc/stencil.cu): {ms:.4f} ms",
                          flush=True)
            if dtype == torch.float32:
                Zr, Yr, Xr = ts.padded_shape(gs)
                for zchunk in (1, 2, 3, 4, 6, 8, 10, 12, 16):
                    if zchunk != plan[0] and zchunk < Zr:
                        p = (zchunk, (math.ceil(Xr / 32), math.ceil(Yr / 8), math.ceil(Zr / zchunk)))
                        for name in ("full", "ahead-2"):
                            ms = cs.cuda_time(lambda i, p=p, e=entries[name]: launch(
                                e, dev, sets, taps, gs, p, i), 50)
                            print(f"  {name} under z-chunks of {zchunk} ({math.prod(p[1])} "
                                  f"blocks): {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
