"""Counterpart of amg_tpu/smooth/."""
