"""Device time a batch of the Gibbs calls (kernels/gibbs.py,
gibbs_sweep.py, gibbs_dosage.py): every gibbs:* section but the emission
subset, by CUDA events at the sections' edges."""
from benchmark.metrics._sections import EMISSIONS, family, ms_per_batch

LAYER = "Gibbs call"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    t = records["device_s"]
    return ms_per_batch(t, family(t, "gibbs:", EMISSIONS), records["batches"])
