from .vcf_writer import write_quilt_vcf, info_score, hwe_exact
from .metrics import r2_by_freq, calculate_pse
from .bgzf import BgzfWriter, bgzf_open

__all__ = [
    "write_quilt_vcf",
    "info_score",
    "hwe_exact",
    "r2_by_freq",
    "calculate_pse",
    "BgzfWriter",
    "bgzf_open",
]
