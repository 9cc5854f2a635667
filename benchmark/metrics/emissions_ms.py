"""Device time a batch of the emissions (kernels/emissions.py): the
whole-panel read emissions, their per-call subset and the FB's genotype
likelihoods, by CUDA events at the sections' edges."""
from benchmark.metrics._sections import EMISSIONS, ms_per_batch

LAYER = "emissions"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    return ms_per_batch(records["device_s"], EMISSIONS, records["batches"])
