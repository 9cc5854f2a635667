from .db import HLAGene, HLAAlleleDB, simulate_hla_db
from .prepare import HLAPrepared, prepare_hla_reference
from .typing import type_hla_sample, HLATypingResult, write_hla_summaries

__all__ = [
    "HLAGene",
    "HLAAlleleDB",
    "simulate_hla_db",
    "HLAPrepared",
    "prepare_hla_reference",
    "type_hla_sample",
    "HLATypingResult",
    "write_hla_summaries",
]
