"""The port's benchmark programs, on one NVIDIA GPU:

    python -m quilt_tpu_torch.bench {fb,gibbs,full} [--samples N] [--out DIR]

- fb: the fused full-panel FB's cell updates a second (one JSON line);
- gibbs: the Gibbs call at 7 to 256 chains and its fixed / per-sweep split
  (bench_torch_gibbs.json);
- full: the FB kernels, the panel-sharded FB, the K-split FB at K = 40,960
  and 98,304, and end-to-end samples/s of QUILT1, QUILT2, NIPT, ONT reads,
  HLA typing and a 98,304-haplotype panel (bench_torch_full.json).

Each builds its world from a seed on the host, times on the card and
refuses to run without one: no figure here comes from the CPU. The world
builders and the run functions also take device="cpu" at a small size, for
the tests."""
