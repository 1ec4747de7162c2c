"""Build and load the CUDA kernels of `csrc/` (route: nvcc -> shared library
with a plain C interface -> ctypes).

Each source compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `amg_tpu_torch/_build/<name>_<hash>.so`, where the hash covers the
source, the shared header and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. `build()` starts one nvcc per missing
library, all at once, and waits for them. ptxas's register and shared-memory
report goes to `<name>_<hash>.log` beside the library.

Every C entry takes the stream last, launches on it, allocates nothing,
does not synchronise, and returns `cudaGetLastError()`; `launch()` passes the
device's current PyTorch stream and raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {
    "tap_march": "tap_march.cu", "box_march": "box_march.cu", "transfer": "transfer.cu",
    "prolong_march": "prolong_march.cu", "var_stencil": "var_stencil.cu",
}
_HEADERS = ("common.cuh",)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + _HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every library in `names` (default: all) whose target is
    missing, one nvcc each, in parallel. Returns {name: path}."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for n, out in targets.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        procs[n] = (
            subprocess.Popen(
                [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            tmp, log,
        )
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n}: nvcc exit {rc}\n{targets[n].with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, targets[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: str(p) for n, p in targets.items()}


def build_log(name: str) -> str:
    """nvcc/ptxas output of the library's last build (registers, spills)."""
    p = _target(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library `name` (built first if needed), with argtypes and
    restype set from {function: (restype, [argtypes])}."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(build([name])[name])
        for fn, (restype, argtypes) in signatures.items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
    return lib


def ptr(t):
    """A tensor's device address for a `c_void_p` argument (None: NULL)."""
    return None if t is None else t.data_ptr()


def launch(entry, what: str, device: torch.device, *args) -> None:
    """Call the C entry with `args` and the current stream of `device`, with
    `device` current; raise on a non-zero CUDA error."""
    with torch.cuda.device(device):
        err = entry(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
