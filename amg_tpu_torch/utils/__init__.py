"""Counterpart of amg_tpu/utils/: the drivers (`runner.run_experiment`, the
CLI `python -m amg_tpu_torch.utils.cli`), their options and statistics."""

from amg_tpu_torch.utils.config import SolverOptions
from amg_tpu_torch.utils.stats import SolveStats

__all__ = ["SolverOptions", "SolveStats"]
