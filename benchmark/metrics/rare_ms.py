"""Device time a batch of the rare/common all-SNP Gibbs calls
(engine/batch.py:run_all_snp_gibbs): the sections `rare:bits_build` (the
subset words from the all-SNP panel) and `rare:sweep_kernel` (the read
emissions, the sweeps and the dosage pass, which nests in it), by CUDA
events at their edges. None where the program runs no all-SNP call."""
from benchmark.metrics._sections import ms_per_batch

LAYER = "rare/common all-SNP call"
UNIT = "ms/batch"
MOVES = "samples_per_s"
RARE = ("rare:bits_build", "rare:sweep_kernel")


def read(records):
    return ms_per_batch(records["device_s"], RARE, records["batches"])
