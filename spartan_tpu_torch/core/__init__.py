"""Subpackage of spartan_tpu_torch."""
