"""The Gibbs sweep kernels' share of their roofline (csrc/gibbs_sweep.cu):
the least time the card could take for a batch's forward and backward
sweeps (benchmark/work.py, from the algorithm's sizes) over the device
time of the engine's gibbs:sweep_kernel section a batch."""
from benchmark.metrics._sections import least_s

LAYER = "kernels"
UNIT = "%"
MOVES = "samples_per_s"


def read(records):
    t = records["device_s"].get("gibbs:sweep_kernel")
    if not t:
        return None
    return 100.0 * least_s(records["work"]["gibbs"]) / (t / records["batches"])
