"""Counterpart of amg_tpu/sparse/."""
