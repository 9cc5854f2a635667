from .reads import SampleReads, snap_reads_to_grid, downsample_reads
from .simulate import simulate_panel, simulate_sample_reads, SimTruth

__all__ = [
    "SampleReads",
    "snap_reads_to_grid",
    "downsample_reads",
    "simulate_panel",
    "simulate_sample_reads",
    "SimTruth",
]
