"""Host time a batch that no span of the program names: the self time of
the root span `impute` (engine/driver.py:quilt_impute), the entry
`impute.self` of the engine's section timers, on the host clock."""
from benchmark.metrics._sections import ms_per_batch

LAYER = "driver and batched engine, host side"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    return ms_per_batch(records["host_s"], ("impute.self",), records["batches"])
