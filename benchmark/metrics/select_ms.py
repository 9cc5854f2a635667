"""Host time a batch of the msPBWT re-selection (panel/mspbwt.py,
engine/batch.py:select_mspbwt): the engine's section `select:mspbwt` on
the host clock, the symbols of the rounded haplotype dosages, the host
match scan over the indices, the ranking, interleave and fill. None where
the program runs no msPBWT selection."""
from benchmark.metrics._sections import ms_per_batch

LAYER = "msPBWT selection (panel/mspbwt.py, engine/batch.py:select_mspbwt)"
UNIT = "ms/batch"
MOVES = "samples_per_s"


def read(records):
    return ms_per_batch(records["host_s"], ("select:mspbwt",), records["batches"])
