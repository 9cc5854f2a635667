"""The full-panel FB kernels' share of their roofline (csrc/fb.cu,
fb_tiled.cu, whichever form fb_plan takes): the least time the card could
take for a batch's forward-backward over the whole panel
(benchmark/work.py, the same count for every form) over the device time of
the engine's fb:kernel section a batch."""
from benchmark.metrics._sections import least_s

LAYER = "kernels"
UNIT = "%"
MOVES = "samples_per_s"


def read(records):
    t = records["device_s"].get("fb:kernel")
    if not t:
        return None
    return 100.0 * least_s(records["work"]["fb"]) / (t / records["batches"])
