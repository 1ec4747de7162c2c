#!/usr/bin/env python3
"""The box march (amg_tpu_torch/csrc/box_march.cu) on the card under other
prefetch depths and launch plans: K1 `sweep_vec_norm` and K2 `sweep2_vec`,
`sweep3_vec` at 126^3 and K2 `sweep3` at 190^3, float32.

    python3 tools/torch_box_variants.py     # from the repository root, one GPU

Variants are text edits of box_march.cu, built into the git-ignored
amg_tpu_torch/_build/variants/; the port never loads them:
  ahead-1, ahead-2  kAhead, the planes of u, b and s in flight (the source's
                    own depth is also held bit for bit against the plain
                    version); timed under the plan of ops/stencil.py::box_plan
                    and under z-chunks of 8, 16 and 32 planes;
  no-copies         the cp.async copies removed (the rings hold whatever is
                    there): the compute and barriers alone;
  no-compute        the z- and y-sums store a copy, the x-phase skips the box
                    (it still writes its zeros): the copies, barriers and
                    stores alone;
  no-midbarrier     the barrier between the y- and x-phases removed (wrong
                    results): what that barrier costs.
The diagnostics run the source's depth under box_plan. Each is timed with
chip_smoke's CUDA-event timer over three input sets cycled past the L2.
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

AHEAD = re.compile(r"constexpr int kAhead = (\d+);")
DIAGNOSTICS = {
    "no-copies": [("cp_async16<false>(dst + q * kV, u + (v ? p * sp + soff[j] : 0), v);",
                   "(void)v;"),
                  ("if constexpr (kNeedB) cp_async16<true>(bd + bdst[j], b + g, v);", "(void)g;"),
                  ("if constexpr (kNeedS) cp_async16<true>(sd + bdst[j], s + g, v);", "")],
    "no-compute": [("t[e] = add_rn(pair0[j][e], v);", "t[e] = v;"),
                   ("dst[r * kWX] = box_axis_sum(c, m, p);", "dst[r * kWX] = p;"),
                   ("if (zin && (inx >> ((k - 1) * kXPer + j)) & 1u) {", "if (false) {")],
    "no-midbarrier": [("    __syncthreads();\n\n    // (c) x-phase", "\n    // (c) x-phase")],
}
CASES = (((126,) * 3, "sweep_vec_norm", 1), ((126,) * 3, "sweep_vec", 2),
         ((126,) * 3, "sweep_vec", 3), ((190,) * 3, "sweep", 3))
ZCHUNKS = (8, 16, 32)


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
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}\n{out[-3000:]}")
        lib = ctypes.CDLL(str(root / f"{name}.so"))
        restype, argtypes = ts._BOX_SIGNATURES["amg_box_launch"]
        lib.amg_box_launch.restype, lib.amg_box_launch.argtypes = restype, argtypes
        libs[name] = lib
    return libs


def plan_of(gs, zchunk):
    Zr, Yr, Xr = ts.padded_shape(gs)
    ty, tx = ts.BOX_TILE
    return zchunk, (math.ceil(Xr / tx), math.ceil(Yr / ty), math.ceil(Zr / zchunk))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_box_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.toolchain()
    src = (_build.CSRC / "box_march.cu").read_text()
    m = AHEAD.search(src)
    if m is None:
        raise RuntimeError("box_march.cu no longer sets kAhead")
    own = f"ahead-{m.group(1)}"
    texts = {f"ahead-{a}": AHEAD.sub(f"constexpr int kAhead = {a};", src) for a in (1, 2)}
    for name, edits in DIAGNOSTICS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"box_march.cu no longer has {old!r}")
            text = text.replace(old, new)
        texts[name] = text
    libs = build(_build.BUILD_DIR / "variants", texts)
    w, off = cs.box27()
    taps = ts.taps_of(w, off)
    box = ts.uniform_box_weights(taps)
    rng = np.random.default_rng(cs.SEED + 5)
    alpha = 1.0 / 52.0
    for gs, mode, k in CASES:
        sets = [tuple(cs.rand_pad(rng, gs, torch.float32, dev) for _ in range(3))
                for _ in range(3)]
        vec = "vec" in mode
        nbytes = (4 if vec else 3) * sets[0][0].numel() * 4
        bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
        plans = [("box_plan", ts.box_plan(gs, k))] + [
            (f"zchunk {z}", plan_of(gs, z)) for z in ZCHUNKS]
        print(f"{mode} K={k} at {gs} float32: byte bound {bound:.4f} ms", flush=True)
        u, b, s = sets[0]
        _build._loaded["box_march"] = libs[own]
        got = ts._launch_box(u, b, s if vec else None, box, gs, alpha, mode, k)
        if k == 1:
            want = ts.stencil_plain(u, b, taps, gs, alpha, s if vec else None, mode)
        else:
            want = ts.sweepk_plain(u, b, taps, gs, k, alpha, s if vec else None)
        if mode == "sweep_vec_norm":
            got, want = got[0], want[0]
        if not torch.equal(got, want):
            print("  the kernel differs from its plain version")
            return 1
        for turn in (1, 2):
            for name, lib in libs.items():
                _build._loaded["box_march"] = lib
                for pname, plan in (plans if name.startswith("ahead") else plans[:1]):
                    def kern(i, plan=plan):
                        uu, bb, ss = sets[i % 3]
                        return ts._launch_box(uu, bb, ss if vec else None, box, gs, alpha, mode,
                                              k, plan)

                    ms = cs.cuda_time(kern, 30)
                    print(f"  turn {turn} {name} {pname:10s} {plan}: {ms:.4f} ms", flush=True)
    _build._loaded.pop("box_march", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
