"""Dtype and device policy (counterpart of amg_tpu/dtypes.py).

  * host-side setup: always float64 (numpy/scipy);
  * device solve path: float64 on the CPU (parity with the reference), float32
    (production) or float64 on the CUDA device — the H100 has native f64, so
    the reference's double-single machinery is not ported;
  * index arrays: int32;
  * float32 matrix products (the dense coarsest solve) need full float32:
    PyTorch's default (`torch.backends.cuda.matmul.allow_tf32` False), which
    `chip_smoke.py` also sets explicitly.

Entry points take `device=None`, which means the CUDA device; they raise when
there is none instead of falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

INDEX_DTYPE = np.int32
SETUP_DTYPE = np.float64


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device (raises without one); else
    `torch.device(device)`, with a bare "cuda" pinned to the current index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        device = "cuda"
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d
