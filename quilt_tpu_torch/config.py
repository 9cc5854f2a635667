"""Configuration for quilt_tpu_torch (a copy of quilt_tpu/config.py: the
same fields, names and defaults, so a command line or a prepared reference
moves between the two packages unchanged).

Single source of truth for every user-facing parameter. The CLI layer
(`quilt_tpu_torch/cli.py`) is generated from these dataclasses, mirroring how the
reference generates its optparse CLIs from roxygen-documented function
signatures (reference: QUILT/R/quilt.R:3-96, QUILT.R:6-533).

Defaults follow the reference's QUILT2 defaults (QUILT/R/quilt.R:97-186)
unless noted.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PrepareConfig:
    """Parameters for reference-panel preparation.

    Mirrors QUILT_prepare_reference() (reference:
    QUILT/R/quilt-prepare-reference.R:35-530).
    """

    outputdir: str = ""
    chr: str = ""
    regionStart: Optional[int] = None
    regionEnd: Optional[int] = None
    buffer: int = 0
    reference_vcf_file: str = ""
    reference_haplotype_file: str = ""
    reference_legend_file: str = ""
    reference_sample_file: str = ""
    reference_populations: Optional[List[str]] = None
    reference_phred: int = 30
    reference_exclude_samplelist_file: str = ""
    region_exclude_file: str = ""
    genetic_map_file: str = ""
    nGen: float = 100.0
    impute_rare_common: bool = False
    rare_af_threshold: float = 0.001
    nMaxDH: Optional[int] = None          # None => auto (255 with uint8 hapMatcher)
    make_fake_vcf_with_sites_list: bool = False
    output_sites_filename: Optional[str] = None
    expRate: float = 1.0
    minRate: float = 0.1
    maxRate: float = 100.0
    use_mspbwt: bool = False
    mspbwt_nindices: int = 4
    temporary_prepared_reference_filename: str = ""
    output_file: str = ""

    # Internal / derived
    ref_error: float = 0.001


@dataclass
class ImputeConfig:
    """Parameters for imputation.

    Mirrors QUILT() (reference: QUILT/R/quilt.R:97-186). Field names keep the
    reference's CLI flag spelling for drop-in familiarity.
    """

    outputdir: str = ""
    chr: str = ""
    regionStart: Optional[int] = None
    regionEnd: Optional[int] = None
    buffer: int = 0
    bamlist: str = ""
    # CRAM support: versions 3.0 (raw/gzip/bzip2/lzma/rANS4x8 codecs) with
    # .crai region seeks; CRAM 3.1-only codecs (rANS Nx16, adaptive
    # arithmetic, fqzcomp, name tokenizer) are rejected with a clear
    # message — recode with `samtools view -O cram,version=3.0`
    cramlist: str = ""
    sampleNames_file: str = ""
    reference: str = ""
    nCores: int = 1
    nGibbsSamples: int = 7
    n_seek_its: int = 3
    n_burn_in_seek_its: Optional[int] = None   # default: n_seek_its - 2
    Ksubset: int = 600
    Knew: int = 600
    K_top_matches: int = 5
    heuristic_match_thin: float = 0.1
    output_filename: Optional[str] = None
    RData_objects_to_save: Optional[List[str]] = None
    output_RData_filename: Optional[str] = None
    prepared_reference_filename: str = ""
    save_prepared_reference: bool = False
    temporary_prepared_reference_filename: str = ""
    nGen: float = 100.0
    reference_vcf_file: str = ""
    reference_haplotype_file: str = ""
    reference_legend_file: str = ""
    reference_sample_file: str = ""
    reference_populations: Optional[List[str]] = None
    reference_phred: int = 30
    reference_exclude_samplelist_file: str = ""
    region_exclude_file: str = ""
    genetic_map_file: str = ""
    posfile: str = ""
    genfile: str = ""
    phasefile: str = ""
    maxDifferenceBetweenReads: float = 1e10
    make_plots: bool = False
    verbose: bool = True
    shuffle_bin_radius: int = 5000
    iSizeUpperLimit: int = 600
    bqFilter: int = 17
    panel_size: Optional[int] = None
    seed: int = 1
    hla_run: bool = False
    downsampleToCov: float = 30.0
    minGLValue: float = 1e-10
    minimum_number_of_sample_reads: int = 2
    print_extra_timing_information: bool = False
    n_gibbs_burn_in_its: int = 20
    use_small_eHapsCurrent_tc: bool = True
    small_ref_panel_gibbs_iterations: int = 20
    small_ref_panel_block_gibbs_iterations: List[int] = field(
        default_factory=lambda: [3, 6, 9])
    overwrite_existing_vcf: bool = True
    impute_rare_common: bool = False
    rare_af_threshold: float = 0.001
    make_heuristic_plot: bool = False
    heuristic_approach: str = "A"
    use_mspbwt: bool = False
    mspbwtL: int = 3
    mspbwtM: int = 1
    # block-Gibbs boundary detection: "gamma" = on-the-fly from the live
    # FB state each block iteration (reference:
    # Rcpp_define_blocked_snps_using_gamma_on_the_fly,
    # QUILT/src/gibbs-nipt-block.cpp:311-527, the production behavior);
    # "map" = static boundaries from the genetic map's smoothed
    # recombination rate (the pre-round-4 approximation)
    block_gibbs_boundary_detection: str = "gamma"
    # quantile threshold on the smoothed jump rate (reference default:
    # block_gibbs_quantile_prob = 0.95, functions.R:2393)
    block_gibbs_quantile_prob: float = 0.95
    # static cap on boundaries per row (the reference is uncapped; the
    # kernels need a fixed shape — top-N peaks by smoothed rate are kept)
    max_block_gibbs_boundaries: int = 32
    override_default_params_for_small_ref_panel: bool = True
    gamma_physically_closest_to: Optional[int] = None
    use_eMatDH_special_symbols: Optional[bool] = None
    use_sample_is_diploid: bool = True
    method: str = "diploid"           # "diploid" or "nipt"
    fflist: str = ""                  # fetal fractions, one per sample (nipt)
    use_bx_tag: bool = True
    bxTagUpperLimit: int = 50000
    addOptimalHapsToVCF: bool = False
    estimate_bq_using_truth_read_labels: bool = False
    output_read_label_prob: bool = False
    use_eigen: bool = True            # kept for CLI parity; no-op here
    use_hapMatcherR: bool = True      # uint8 hapMatcher (always true here)
    ref_error: float = 0.001
    output_gt_phased_genotypes: bool = True
    useSoftClippedBases: bool = False
    record_read_label_usage: bool = False
    record_interim_dosages: bool = False
    plot_per_sample_likelihoods: bool = False
    # device batching knobs (no reference equivalent)
    sample_batch: int = 8             # samples imputed per device batch
    precision: str = "float32"
    mesh_data: int = 1                # data-parallel axis size
    mesh_panel: int = 1               # panel(K)-sharding axis size
    # multi-process execution (not served by this package yet): samples are
    # data-parallel across processes, process 0 writes the merged VCF
    distributed_nproc: int = 1        # number of cooperating processes
    distributed_rank: int = 0         # this process's id (0-based)
    distributed_coordinator: str = "" # coordinator host:port (rank 0's)

    def resolved_n_burn_in_seek_its(self) -> int:
        if self.n_burn_in_seek_its is None:
            return max(self.n_seek_its - 2, 0)
        return self.n_burn_in_seek_its


def config_fields(cls):
    """Yield (name, type, default, doc) for CLI generation."""
    for f in dataclasses.fields(cls):
        yield f
