"""Device time a batch of the Gibbs call's hand-written sweep kernels
(csrc/gibbs_sweep.cu): the spans `sweep.fwd` and `sweep.bwd` around each
launch (kernels/gibbs.py:run_gibbs_chains), by CUDA events at their edges,
so the kernels and the waits inside their spans. None where the program
has no such spans, or no card."""
from benchmark.metrics._sections import ms_per_batch

LAYER = "Gibbs call"
UNIT = "ms/batch"
MOVES = "samples_per_s"
SWEEPS = ("sweep.fwd", "sweep.bwd")


def read(records):
    return ms_per_batch(records["device_s"], SWEEPS, records["batches"])
