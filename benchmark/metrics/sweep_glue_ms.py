"""Device time a batch of the Gibbs call outside its sweep kernels: the
device time of `gibbs:sweep_kernel` less that of the spans `sweep.fwd` and
`sweep.bwd` (sweep_kernels_ms), by CUDA events. That is the call's torch
glue (slot emissions and words, block moves, per-iteration sums), the read
emissions built inside it (`sweep.read_lem`, where the whole-panel cache is
over its budget) and the card's waits on the host there. None where the
program has no sweep spans, or no card."""
from benchmark.metrics._sections import ms_per_batch
from benchmark.metrics.sweep_kernels_ms import SWEEPS

LAYER = "Gibbs call"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    t = records["device_s"]
    whole = ms_per_batch(t, ("gibbs:sweep_kernel",), records["batches"])
    sweeps = ms_per_batch(t, SWEEPS, records["batches"])
    if whole is None or sweeps is None:
        return None
    return whole - sweeps
