"""PyTorch + CUDA port of quilt_tpu for one NVIDIA H100.

The JAX package (quilt_tpu) is the reference; this package imports torch
and never jax, directly or through a quilt_tpu module whose imports reach
jax. The slice ported so far is QUILT1 diploid imputation through the
batched engine (`python -m quilt_tpu_torch impute ...`).
"""
