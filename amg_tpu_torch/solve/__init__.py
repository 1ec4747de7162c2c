"""Counterpart of amg_tpu/solve/."""
