"""Subpackage of pbmm_tpu_torch (see the package docstring)."""
