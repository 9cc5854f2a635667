"""The whole batch's share of the card's peak: the least time of its
Gibbs sweeps and full-panel FB (benchmark/work.py) over the batch's wall
time in the traced window. It bounds every kernel's roofline share from
above in what it means for a batch, whatever kernel a change removes."""
from benchmark.metrics._sections import least_s

LAYER = "device"
UNIT = "%"
MOVES = "samples_per_s"


def read(records):
    if records["platform"] != "gpu":
        return None
    w = records["work"]
    return 100.0 * (least_s(w["gibbs"]) + least_s(w["fb"])) / (
        records["window_s"] / records["batches"])
