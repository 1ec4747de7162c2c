"""Hierarchy containers (counterpart of amg_tpu/setup/hierarchy.py:94-158).

`Level`/`Hierarchy` hold the device side (torch operators and tensors),
`HostLevel`/`HostHierarchy` the float64 host setup. The multadd and AFACj
transfer fields of the reference's Level arrive with those cycles.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from amg_tpu_torch.smooth.smoothers import SmootherData
from amg_tpu_torch.sparse.csr import CSRMatrix


class Level(NamedTuple):
    """One device-side level. P maps level k+1 -> k; R maps k -> k+1 (both
    None on the coarsest level)."""

    A: Any  # StencilOperator | VarStencilOperator | DiaKernelOperator
    P: Optional[Any]  # StructuredProlong | MaskedTransfer
    R: Optional[Any]  # StructuredRestrict | MaskedTransfer
    sm: SmootherData


class Hierarchy(NamedTuple):
    levels: Tuple[Level, ...]
    coarse_Ainv: torch.Tensor  # dense inverse of the coarsest operator

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.coarse_Ainv.device

    @property
    def dtype(self) -> torch.dtype:
        return self.coarse_Ainv.dtype


@dataclass
class HostLevel:
    A: CSRMatrix
    P: Optional[CSRMatrix] = None
    R: Optional[CSRMatrix] = None
    weight: float = 1.0


@dataclass
class HostHierarchy:
    levels: List[HostLevel] = field(default_factory=list)
    # (level dicts, coarse_Ainv): the float64 arrays that
    # convert.hierarchy_from_arrays turns into a device Hierarchy of any dtype
    arrays: Optional[tuple] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)
