#!/usr/bin/env python3
"""What bounds K3 (amg_tpu_torch/csrc/transfer.cu) on the card: time it at
126^3 float32 beside diagnostic builds of the same source that each drop or
change one part of a z-step.

    python3 tools/torch_k3_variants.py     # from the repository root, one GPU

Variants (text edits of transfer.cu, built into the git-ignored
amg_tpu_torch/_build/variants/; the port never loads them):
  full          the kernel as it is;
  no-accumulate the 27 tap FMAs removed (copies, barriers, residual write and
                restriction remain): the copy pipeline's time;
  no-copies     the cp.async copies removed (the shared planes hold whatever
                is there): the compute's time;
  prefetch-1/3  one or three planes in flight instead of two (float32 only
                for 3: the float64 rings would exceed 48 KB of static shared
                memory).
Each is timed with chip_smoke's CUDA-event timer over four input sets cycled
past the L2, in two turns; `full` is also held against the plain version.
"""

from __future__ import annotations

import ctypes
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

ACC = ("acc[k][j][0] += W.w[2][dy][dx] * n[j + dx];",
       "acc[k][j][1] += W.w[1][dy][dx] * n[j + dx];",
       "acc[k][j][2] += W.w[0][dy][dx] * n[j + dx];")
COPIES = ("cp_async16(bd + q * Ch::kV, b + g, v);",
          "if constexpr (kMode == kK3Iterate) cp_async16(xd + q * Ch::kV, u + g, v);")
AHEAD = "constexpr int k3Ahead = 2;"
F64_CALL = "return k3_launch<double>(u, b, s, rc"


def edit(src, pairs):
    for old, new in pairs:
        if old not in src:
            raise RuntimeError(f"transfer.cu no longer has {old!r}")
        src = src.replace(old, new)
    return src


def variants(src):
    return {
        "full": src,
        "no-accumulate": edit(src, [(ACC[0], ""), (ACC[1], ""), (ACC[2], "(void)n;")]),
        "no-copies": edit(src, [(COPIES[0], "(void)g; (void)bd;"), (COPIES[1], "(void)xd;")]),
        "prefetch-1": edit(src, [(AHEAD, AHEAD.replace("2", "1"))]),
        "prefetch-3": edit(src, [(AHEAD, AHEAD.replace("2", "3")),
                                 (F64_CALL, F64_CALL.replace("double", "float"))]),
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
        f = ctypes.CDLL(str(root / f"{name}.so")).amg_k3_launch
        f.restype, f.argtypes = tt._SIGNATURES["amg_k3_launch"]
        entries[name] = f
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k3_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cs.toolchain()
    src = (_build.CSRC / "transfer.cu").read_text()
    entries = build(_build.BUILD_DIR / "variants", variants(src))
    gs = (126,) * 3
    cgs = tt.coarse_shape_of(gs)
    shape, cshape = ts.padded_shape(gs), ts.padded_shape(cgs)
    zchunk, grid = tt.k3_plan(gs)
    rng = np.random.default_rng(cs.SEED)
    offs = tuple((dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    w = -rng.random(27)
    w[13] = 30.0
    taps = ts.taps_of(w, offs)
    tap_args = ts.tap_arrays(taps)
    sets = [(cs.rand_pad(rng, gs, torch.float32, dev), cs.rand_pad(rng, gs, torch.float32, dev))
            for _ in range(4)]

    def launch(entry, i):
        u, b = sets[i % 4]
        rc = torch.empty(cshape, device=dev)
        _build.launch(entry, "K3 variant", dev, 0, u.data_ptr(), b.data_ptr(), None,
                      rc.data_ptr(), *tap_args, *gs, shape[1], shape[2], *cgs, *cshape, 0,
                      *grid, zchunk, 0.0)
        return rc

    want = tt.residual_restrict_plain(sets[0][0], sets[0][1], taps, gs)
    got = launch(entries["full"], 0)
    rel = float((got - want).abs().max() / want.abs().max())
    print(f"full against the plain version at {gs} float32: max rel err {rel:.3e}")
    if rel > cs.TOL["float32"]:
        return 1
    bound = tt.k3_bytes(gs, torch.float32, False, False) / cs.HBM_BYTES_PER_S * 1e3
    print(f"K3 at {gs} float32, plan zchunk {zchunk} grid {grid}, byte bound {bound:.4f} ms")
    for turn in (1, 2):
        for name, entry in entries.items():
            ms = cs.cuda_time(lambda i, e=entry: launch(e, i), 50)
            print(f"  turn {turn} {name:14s} {ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
