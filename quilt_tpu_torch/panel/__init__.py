"""Reference-panel preparation (host) and the msPBWT haplotype search of
the port (host index and match scan; the query symbols on the device)."""
from .prepare import (
    PreparedReference,
    assign_positions_to_grid,
    compress_panel,
    interpolate_genetic_map,
    make_smoothed_rate,
    prepare_panel,
    sigma_from_cm_grid,
    trans_rates,
)

__all__ = [
    "PreparedReference",
    "assign_positions_to_grid",
    "compress_panel",
    "interpolate_genetic_map",
    "make_smoothed_rate",
    "prepare_panel",
    "sigma_from_cm_grid",
    "trans_rates",
]
