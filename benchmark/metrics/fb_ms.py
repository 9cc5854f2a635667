"""Device time a batch of the full-panel FB calls (kernels/fb.py: fb_plan,
the fused and K-split cores, the re-selection): every fb:* section but the
genotype likelihoods, by CUDA events at the sections' edges."""
from benchmark.metrics._sections import EMISSIONS, family, ms_per_batch

LAYER = "FB call"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    t = records["device_s"]
    return ms_per_batch(t, family(t, "fb:", EMISSIONS), records["batches"])
