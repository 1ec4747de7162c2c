"""Build and load the CUDA kernels of `csrc/` (route: nvcc -> shared library
with a plain C interface -> ctypes).

Each source compiles with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into `amg_tpu_torch/_build/<name>_<hash>.so`, where the hash covers the
source, the shared header and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. `build()` starts one nvcc per missing
library, all at once, and waits for them; `prefetch()` starts them and
returns, for a caller that has host work to do meanwhile. ptxas's register
and shared-memory report goes to `<name>_<hash>.log` beside the library.

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
    "ell_spmv": "ell_spmv.cu",
}
_HEADERS = ("common.cuh",)
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}
_pending: dict = {}  # name: (nvcc process, temporary output, log file) from prefetch()


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


def _start(name: str, out: Path):
    """One nvcc for library `name` into a temporary beside `out`."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen([nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, log


def prefetch(names) -> None:
    """Start nvcc for each library in `names` whose target is missing, and
    return at once: a caller with host work ahead (a set-up) overlaps a cold
    build with it. The next build() or load() of the library waits for it."""
    BUILD_DIR.mkdir(exist_ok=True)
    for n in names:
        if n not in _pending and not _target(n).exists():
            _pending[n] = _start(n, _target(n))


def build(names=None) -> dict:
    """Compile every library in `names` (default: all) whose target is
    missing, one nvcc each, in parallel, and wait for them and for those
    that prefetch() started. Returns {name: path}."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {n: _pending.pop(n) for n in names if n in _pending}
    for n, out in targets.items():
        if n not in procs and not out.exists():
            procs[n] = _start(n, out)
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


def launch(entry, what: str, device, *args) -> None:
    """Call the C entry with `args` and the current stream of `device` (a
    torch.device or a device index), with `device` current; raise on a
    non-zero CUDA error. The device is switched only when it is not the
    current one, and the stream is read as its raw handle: a launch costs
    the host little beyond the ctypes call."""
    index = device if isinstance(device, int) else device.index
    current = torch.cuda.current_device()
    if index is None or index == current:
        err = entry(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            err = entry(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
