"""Solve-state checkpoint and resume (counterpart of
amg_tpu/utils/checkpoint.py): an npz round-trip of the solve state with
enough metadata to resume a tolerance loop where it stopped. The solvers
take an initial guess, so a resume passes the saved x back as x0."""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    """A host numpy array of a tensor on any device, or of an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def save_solve_state(path: str, x, b, *, iters=0, history=None, meta=None):
    """Persist a solve's resumable state. `x`/`b` are tensors on any device
    or host arrays; history is the NaN-padded relative residual history."""
    np.savez(
        path,
        x=_host(x),
        b=_host(b),
        iters=int(iters),
        history=(_host(history) if history is not None else np.zeros(0)),
        meta=np.array(repr(meta or {}), dtype=object),
    )


def load_solve_state(path: str) -> dict:
    """Load a checkpoint. Returns {x, b, iters, history, meta} as host
    arrays; feed x back as x0 to resume (the tolerance loop keeps no state
    beyond x)."""
    import ast

    with np.load(path, allow_pickle=True) as z:
        return {
            "x": z["x"],
            "b": z["b"],
            "iters": int(z["iters"]),
            "history": z["history"],
            "meta": ast.literal_eval(str(z["meta"])),
        }
