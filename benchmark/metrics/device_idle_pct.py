"""The share of the traced window in which no kernel, copy or fill ran on
the device (torch.profiler's trace). Left out where the tracer recorded
nothing."""
LAYER = "device"
UNIT = "%"
MOVES = "samples_per_s"


def read(records):
    tr = records.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
