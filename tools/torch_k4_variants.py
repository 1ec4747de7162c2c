#!/usr/bin/env python3
"""What bounds K4 (amg_tpu_torch/csrc/prolong_march.cu) on the card: time it
at 126^3 float32 (the uniform box, scale stream: the V(1,1) path's level-0
launch) and in its zero-guess launches at 63^3 and 32^3 (27 distinct taps),
beside diagnostic builds of the same source that each drop or change one
part of a z-step, and under other launch plans.

    python3 tools/torch_k4_variants.py     # from the repository root, one GPU

Variants (text edits of prolong_march.cu, built into the git-ignored
amg_tpu_torch/_build/variants_k4/; the port never loads them):
  full        the kernel as it is (also held bit for bit against the plain
              version);
  no-copies   the cp.async copies removed (the rings hold whatever is
              there): the compute and barriers alone;
  no-compute  the z- and y-sums store a copy and the output skips the box
              (the expansions, copies, u' and barriers remain);
  no-expand   the coarse planes are not expanded in the march (only in the
              prologue): what the expansions cost;
  one-plane   the route for 27 taps in product order (the RAP levels')
              sums the 9 taps of plane n only: what the other 18 cost at
              63^3 and 32^3 (which also run the route for any tap list, on
              the same taps, for comparison);
  ahead-1/3   one or three planes of x, b and s in flight instead of two;
  min-blocks-N  __launch_bounds__(256, N): the registers capped so that N
              blocks fit on an SM.
Each is timed with chip_smoke's CUDA-event timer over four input sets cycled
past the L2, in two turns; `full` also under z-chunks other than k4_plan's.
"""

from __future__ import annotations

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
from amg_tpu_torch.ops import transfer as tt  # noqa: E402

COPIES = ("cp_async16(d, b + g, v);",
          "if constexpr (kNW == 2) cp_async16(d + kWSlots * kPlane, s + g, v);",
          "cp_async16(d, x + g, v);",
          "if constexpr (kNTs == 2) cp_async16(d + kTSlots * kPlane, s + g, v);")
COMPUTE = (("t.v[e] = add_rn(add_rn(m.v[e], c.v[e]), u.v[e]);", "t.v[e] = u.v[e];"),
           ("ty[w + r * kWX] = box_axis_sum(c, m, p);", "ty[w + r * kWX] = p;"),
           ("acc[0] = box_combine(w_off, w_cm, box_axis_sum(ty[ow], ty[ow - 1], ty[ow + 1]),\n"
            "                             uring[slot<kUSlots>(n) * kPlane + ow]);",
            "acc[0] = uring[slot<kUSlots>(n) * kPlane + ow];"))
EXPAND = (("if ((n + 5) / 2 <= jmax && i >= 0) expand_y((n + 5) / 2, i);", "(void)i;"),
          ("if (n / 2 + 2 <= jmax && i >= 0) expand_x(n / 2 + 2, i);", "(void)i;"))
TAPS = (("for (int dz = -1; dz <= 1; ++dz) {", "for (int dz = 0; dz <= 0; ++dz) {"),)
AHEAD = "constexpr int kAhead = 2;"
BOUNDS = "__global__ void __launch_bounds__(kNT)"


def edit(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"prolong_march.cu no longer has {old!r}")
        src = src.replace(old, new)
    return src


def variants(src):
    return {
        "full": src,
        "no-copies": edit(src, [(c, "(void)g;") for c in COPIES]),
        "no-compute": edit(src, COMPUTE),
        "no-expand": edit(src, EXPAND),
        "one-plane": edit(src, TAPS),
        "ahead-1": edit(src, [(AHEAD, AHEAD.replace("2", "1"))]),
        "ahead-3": edit(src, [(AHEAD, AHEAD.replace("2", "3"))]),
        "min-blocks-5": edit(src, [(BOUNDS, BOUNDS.replace("(kNT)", "(kNT, 5)"))]),
        "min-blocks-6": edit(src, [(BOUNDS, BOUNDS.replace("(kNT)", "(kNT, 6)"))]),
    }


def build(root, texts):
    root.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC / "common.cuh", root / "common.cuh")
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
                entry = f"{m[1]}{('list', 'box', 'dense27')[int(m[2])]}{m[3]}"
            elif "Used " in line:
                regs.append(f"{entry}:{line.split('Used ')[1].split(' registers')[0]}")
        print(f"  {name}: registers (dtype, route, mode 0-3) {' '.join(regs)}")
        f = ctypes.CDLL(str(root / f"{name}.so")).amg_k4_launch
        f.restype, f.argtypes = tt._K4_SIGNATURES["amg_k4_launch"]
        entries[name] = f
    return entries


def case(dev, rng, gs, kind):
    """Four input sets (x, b, s, ec), the taps and the mode of one launch."""
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    if kind == "box":
        w = tuple(26.0 if o == (0, 0, 0) else -1.0 for o in offs)
    else:
        w = -rng.random(27)
        w[13] = 30.0
    cgs = tt.coarse_shape_of(gs)
    sets = [(cs.rand_pad(rng, gs, torch.float32, dev), cs.rand_pad(rng, gs, torch.float32, dev),
             0.02 * cs.rand_pad(rng, gs, torch.float32, dev),
             cs.rand_pad(rng, cgs, torch.float32, dev)) for _ in range(4)]
    return sets, ts.taps_of(w, offs), kind != "box"


def launch(entry, dev, sets, taps, gs, zero_guess, plan, i, route=None):
    x, b, s, ec = sets[i % 4]
    out = torch.empty_like(b)
    w, dz, dy, dx, n = ts.tap_arrays(taps)
    box = ts.uniform_box_weights(taps)
    w_off, w_c = box if box is not None else (0.0, 0.0)
    zchunk, grid = plan
    _build.launch(entry, "K4 variant", dev, 0, None if zero_guess else x.data_ptr(),
                  b.data_ptr(), s.data_ptr(), ec.data_ptr(), out.data_ptr(), w, dz, dy, dx, n,
                  ts.tap_route(taps) if route is None else route, float(w_off), float(w_c - w_off), *gs, *b.shape,
                  *ec.shape, int(zero_guess), *grid, zchunk, 0.0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k4_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.toolchain()
    src = (_build.CSRC / "prolong_march.cu").read_text()
    entries = build(_build.BUILD_DIR / "variants_k4", variants(src))
    rng = np.random.default_rng(cs.SEED)
    for gs, kind in (((126,) * 3, "box"), ((63,) * 3, "taps"), ((32,) * 3, "taps")):
        sets, taps, zg = case(dev, rng, gs, kind)
        plan = tt.k4_plan(gs)
        x, b, s, ec = sets[0]
        want = tt.prolong_sweep_plain(None if zg else x, b, ec, taps, gs, 0.0, s, zg)
        got = launch(entries["full"], dev, sets, taps, gs, zg, plan, 0)
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, want))
        nbytes = tt.k4_bytes(gs, torch.float32, zg, True)
        print(f"K4 {kind} zero_guess={zg} at {gs} float32, plan {plan}: full equal to the plain "
              f"version bit for bit: {exact}; byte bound "
              f"{nbytes / cs.HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.2f} MB)")
        if not exact:
            return 1
        names = (list(entries) if gs[0] == 126 else
                 ["full", "no-copies", "no-expand", "one-plane", "ahead-1", "min-blocks-5"])
        for turn in (1, 2):
            for name in names:
                ms = cs.cuda_time(
                    lambda i, e=entries[name]: launch(e, dev, sets, taps, gs, zg, plan, i), 50)
                print(f"  turn {turn} {name:14s} {ms:.4f} ms", flush=True)
        if zg:
            for turn in (1, 2):
                ms = cs.cuda_time(lambda i: launch(entries["full"], dev, sets, taps, gs, zg, plan,
                                                   i, route=0), 50)
                print(f"  turn {turn} full, the route for any tap list: {ms:.4f} ms", flush=True)
        Zr, Yr, Xr = ts.padded_shape(gs)
        for zchunk in ((4, 8, 13, 16, 32) if gs[0] == 126 else (1, 2, 4, 5, 8)):
            if zchunk != plan[0]:
                p = (zchunk, (math.ceil(Xr / 32), math.ceil(Yr / 8), math.ceil(Zr / zchunk)))
                ms = cs.cuda_time(
                    lambda i, p=p: launch(entries["full"], dev, sets, taps, gs, zg, p, i), 50)
                print(f"  full under z-chunks of {zchunk:2d} ({math.prod(p[1])} blocks): "
                      f"{ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
