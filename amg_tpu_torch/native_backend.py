"""ctypes bindings of the port's native setup library (`native/amg_setup.cpp`).

The library is compiled with g++ at first use,

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared

into `amg_tpu_torch/_build/libamgsetup_<hash>.so`, where the hash covers the
source and the flags (the kernels of `ops/_build.py` are kept the same way).
These are the reference's flags, so the same source and compiler give the
same machine code and the same bits.

Unlike the reference, nothing falls back silently: `"hmis"` coarsening is this
library's algorithm, and a library that cannot be built raises. The scipy /
numpy routes stay as the plain versions; `AMG_TPU_NATIVE=0` selects them for
SpGEMM, transpose and interpolation (`use_native`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "native" / "amg_setup.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None

_i32p = ctypes.POINTER(ctypes.c_int32)
_f64p = ctypes.POINTER(ctypes.c_double)
_i8p = ctypes.POINTER(ctypes.c_int8)


def use_native() -> bool:
    """SpGEMM, transpose and interpolation through this library unless
    AMG_TPU_NATIVE=0 (the environment switch the reference reads too)."""
    return os.environ.get("AMG_TPU_NATIVE", "1") != "0"


def _target() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libamgsetup_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if its target is missing; returns its path.
    Raises RuntimeError when there is no g++ or the build fails."""
    out = _target()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if cxx is None:
        raise RuntimeError("the native setup library needs g++ (or $CXX), which is not on PATH")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"native setup library build failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.spgemm_csr.restype = ctypes.c_int64
    lib.spgemm_csr.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _f64p,
        _i32p, _i32p, _f64p,
        ctypes.POINTER(_i32p), ctypes.POINTER(_i32p), ctypes.POINTER(_f64p),
    ]
    lib.csr_transpose.restype = None
    lib.csr_transpose.argtypes = [
        ctypes.c_int32, ctypes.c_int32, _i32p, _i32p, _f64p,
        _i32p, _i32p, _f64p,
    ]
    for name in ("pmis_coarsen", "hmis_coarsen"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_int32, _i32p, _i32p, ctypes.c_uint64, _i8p]
    for name in ("interp_direct", "interp_extpi"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _f64p,
            _i32p, _i32p,
            _i8p, _i32p,
            ctypes.POINTER(_i32p), ctypes.POINTER(_i32p), ctypes.POINTER(_f64p),
        ]
    lib.amg_free.restype = None
    lib.amg_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _ptr(a, typ):
    return a.ctypes.data_as(typ)


def _take_csr(lib, rows, nnz, pi, pj, pv):
    """Copy a library-allocated CSR result into numpy and free it."""
    try:
        indptr = np.ctypeslib.as_array(pi, shape=(rows + 1,)).copy()
        indices = np.ctypeslib.as_array(pj, shape=(max(nnz, 1),))[:nnz].copy()
        data = np.ctypeslib.as_array(pv, shape=(max(nnz, 1),))[:nnz].copy()
    finally:
        lib.amg_free(pi)
        lib.amg_free(pj)
        lib.amg_free(pv)
    return indptr, indices, data


def spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, shape_a, shape_b):
    """C = A @ B. Returns (indptr, indices, data) numpy arrays."""
    lib = _load()
    m, k = shape_a
    k2, n = shape_b
    if k != k2:
        raise ValueError(f"spgemm: inner sizes differ, {shape_a} @ {shape_b}")
    ai, aj, av = _i32(a_indptr), _i32(a_indices), _f64(a_data)
    bi, bj, bv = _i32(b_indptr), _i32(b_indices), _f64(b_data)
    ci, cj, cv = _i32p(), _i32p(), _f64p()
    nnz = lib.spgemm_csr(
        m, k, n,
        _ptr(ai, _i32p), _ptr(aj, _i32p), _ptr(av, _f64p),
        _ptr(bi, _i32p), _ptr(bj, _i32p), _ptr(bv, _f64p),
        ctypes.byref(ci), ctypes.byref(cj), ctypes.byref(cv),
    )
    return _take_csr(lib, m, nnz, ci, cj, cv)


def transpose(indptr, indices, data, shape):
    lib = _load()
    m, n = shape
    ai, aj, av = _i32(indptr), _i32(indices), _f64(data)
    nnz = int(ai[m])
    bi = np.zeros(n + 1, dtype=np.int32)
    bj = np.zeros(max(nnz, 1), dtype=np.int32)
    bv = np.zeros(max(nnz, 1), dtype=np.float64)
    lib.csr_transpose(
        m, n, _ptr(ai, _i32p), _ptr(aj, _i32p), _ptr(av, _f64p),
        _ptr(bi, _i32p), _ptr(bj, _i32p), _ptr(bv, _f64p),
    )
    return bi, bj[:nnz], bv[:nnz]


def _coarsen(name, s_indptr, s_indices, n, seed):
    lib = _load()
    si, sj = _i32(s_indptr), _i32(s_indices)
    cf = np.zeros(n, dtype=np.int8)
    getattr(lib, name)(n, _ptr(si, _i32p), _ptr(sj, _i32p), ctypes.c_uint64(seed),
                       cf.ctypes.data_as(_i8p))
    return cf


def pmis(s_indptr, s_indices, n, seed: int = 0):
    """PMIS C/F split (1 = C, 0 = F) with the library's splitmix64 randoms."""
    return _coarsen("pmis_coarsen", s_indptr, s_indices, n, seed)


def hmis(s_indptr, s_indices, n, seed: int = 0):
    """HMIS: a Ruge-Stueben first pass biasing PMIS rounds (1 = C, 0 = F)."""
    return _coarsen("hmis_coarsen", s_indptr, s_indices, n, seed)


def interpolation(kind, a_indptr, a_indices, a_data, s_indptr, s_indices, cf, cmap, n, nc):
    """kind: 'direct' | 'ext+i'. Returns (indptr, indices, data)."""
    lib = _load()
    fn = lib.interp_direct if kind == "direct" else lib.interp_extpi
    ai, aj, av = _i32(a_indptr), _i32(a_indices), _f64(a_data)
    si, sj = _i32(s_indptr), _i32(s_indices)
    cfa = np.ascontiguousarray(cf, dtype=np.int8)
    cm = _i32(cmap)
    pi, pj, pv = _i32p(), _i32p(), _f64p()
    nnz = fn(
        n, nc,
        _ptr(ai, _i32p), _ptr(aj, _i32p), _ptr(av, _f64p),
        _ptr(si, _i32p), _ptr(sj, _i32p),
        cfa.ctypes.data_as(_i8p), _ptr(cm, _i32p),
        ctypes.byref(pi), ctypes.byref(pj), ctypes.byref(pv),
    )
    return _take_csr(lib, n, nnz, pi, pj, pv)
