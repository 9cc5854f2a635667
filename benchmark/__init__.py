"""The benchmark of quilt_tpu_torch (see README.md)."""
