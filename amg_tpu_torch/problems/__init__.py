"""Counterpart of amg_tpu/problems/."""
