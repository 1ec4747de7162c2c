"""Counterpart of amg_tpu/ops/."""
