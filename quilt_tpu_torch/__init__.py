"""PyTorch + CUDA port of quilt_tpu for one NVIDIA H100.

The JAX package (quilt_tpu) is the reference; this package imports torch,
never jax, and nothing of quilt_tpu: the host modules it needs (config,
io, out, utils, panel, native) are its own copies under the same names.
Ported so far: QUILT1 and QUILT2 imputation, diploid and NIPT, through the
batched engine (`python -m quilt_tpu_torch impute|impute2 ...`) and, for a
lone sample, the per-sample engine, for small panels (fused FB kernels) and
large ones (K-split FB kernels); QUILT-HLA (`hla-prepare` / `hla`) through
the per-sample engine with the fused FB's gamma capture.
"""
