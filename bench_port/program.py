"""The system under test, as the benchmark calls it: the generic AMG set-up of
`amg_tpu_torch` on the benchmark's own inputs.

The entries (`entries/<entry>.py`) build on this; nothing else of the
benchmark imports the program. The inputs are handed over as the program's
user would hand them: the CSR matrix through `CSRMatrix.from_scipy` (a copy,
so the program cannot touch the matrix the reference judges with), the
constant stencil as a `StencilOperator`, the near-nullspace candidates as an
array.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from amg_tpu_torch.setup.hierarchy import HierarchyParams, build_hierarchy
from amg_tpu_torch.solve.cycles import CycleConfig, CycleType
from amg_tpu_torch.sparse.csr import CSRMatrix
from amg_tpu_torch.sparse.stencil import StencilOperator


class Generic(NamedTuple):
    hh: Any  # the host hierarchy (HostHierarchy)
    hier: Any  # the device Hierarchy


def build_generic(inputs: dict, config: dict, device, dtype: torch.dtype) -> Generic:
    """`build_hierarchy` with the configuration's HierarchyParams; level 0
    keeps the stencil where the inputs carry one."""
    params = HierarchyParams(dtype=dtype, **config.get("hierarchy", {}))
    stencil = None
    if "stencil" in inputs:
        st = inputs["stencil"]
        stencil = StencilOperator(
            weights=torch.as_tensor(np.asarray(st["weights"], dtype=np.float64)),
            offsets=tuple(tuple(o) for o in st["offsets"]),
            grid_shape=tuple(st["grid_shape"]))
    hh, hier = build_hierarchy(CSRMatrix.from_scipy(inputs["A"].copy()), params,
                               fine_stencil=stencil,
                               near_nullspace=inputs.get("near_nullspace"), device=device)
    return Generic(hh=hh, hier=hier)


def cycle_config(solver: dict) -> CycleConfig:
    """The CycleConfig of a traffic file's solver block (the CLI's defaults
    for what it leaves out)."""
    return CycleConfig(cycle=CycleType(solver.get("cycle", "mult")),
                       use_smoothed_transfers=bool(solver.get("use_smoothed_transfers", False)))
