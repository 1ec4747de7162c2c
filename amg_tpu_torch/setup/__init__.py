"""Counterpart of amg_tpu/setup/."""
