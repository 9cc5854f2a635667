"""What the per-layer readers share: the engine's timed sections of each
layer, and a section family's time a batch."""
from __future__ import annotations

from typing import Dict, Iterable, Optional

# host stages of the driver and batched engine (engine/driver.py, engine/batch.py)
HOST = ("inputs_build", "vcf:columns", "vcf:write", "consensus", "final_fetch")
# emissions (kernels/emissions.py)
EMISSIONS = ("emat:full_build", "gibbs:lem_subset", "fb:gl_build")


def ms_per_batch(times: Dict[str, float], names: Iterable[str], batches: int) -> Optional[float]:
    """The sections' total in ms a batch; None where none of them ran."""
    hit = [times[n] for n in names if n in times]
    return 1e3 * sum(hit) / batches if hit and batches else None


def family(times: Dict[str, float], prefix: str, leave_out: Iterable[str] = ()) -> list:
    """The sections named prefix*, but those left out."""
    return [n for n in times if n.startswith(prefix) and n not in set(leave_out)]


def least_s(work) -> float:
    """The least time of (bytes, operations) at the card's published peaks."""
    from benchmark.work import bound_s
    return bound_s(*work)
