"""The all-SNP Gibbs call's share of its roofline (csrc/gibbs_sweep.cu on
the all-SNP grids): the least time the card could take for a batch's
all-SNP sweeps (benchmark/work.py, from the algorithm's sizes; the
method's `rare` work) over the device time of the engine's
rare:sweep_kernel section a batch. None where the cell counts no such
work or the program has no such section."""
from benchmark.metrics._sections import least_s

LAYER = "kernels"
UNIT = "%"
MOVES = "samples_per_s"


def read(records):
    t = records["device_s"].get("rare:sweep_kernel")
    w = records["work"].get("rare")
    if not t or not w:
        return None
    return 100.0 * least_s(w) / (t / records["batches"])
