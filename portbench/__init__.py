"""The benchmark of gubernator_tpu_torch (see README.md)."""
