"""Host time a batch of the driver and batched engine's host stages
(engine/driver.py, engine/batch.py, inputs.py, out/vcf_writer.py): the
engine's own section timers on the host clock."""
from benchmark.metrics._sections import HOST, ms_per_batch

LAYER = "driver and batched engine, host side"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    return ms_per_batch(records["host_s"], HOST, records["batches"])
