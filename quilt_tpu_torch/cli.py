"""Command line of the port:

    python -m quilt_tpu_torch prepare ...   (the JAX package's prepare)
    python -m quilt_tpu_torch impute ...    (QUILT1 diploid, on the GPU)
    python -m quilt_tpu_torch prepare2 ...  (prepare with the QUILT2 defaults)
    python -m quilt_tpu_torch impute2 ...   (QUILT2 diploid, on the GPU)

The flags are the JAX package's (generated from quilt_tpu.config); the
QUILT2 verbs default use_mspbwt and impute_rare_common to TRUE, as the JAX
package's do. The readers and the reference preparation are reused from
it, as they import nothing of jax. `impute` and `impute2` run on the CUDA
device and refuse options outside the ported slice; without a GPU they
exit non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from quilt_tpu.cli import _add_dataclass_args, _config_from_args, cmd_prepare
from quilt_tpu.config import ImputeConfig, PrepareConfig
from quilt_tpu.utils import print_message


def cmd_impute(args, device, quilt2: bool = False) -> int:
    from quilt_tpu.io.bam import bam_chromosome_length, bam_sample_name, load_bam_reads
    from quilt_tpu.io.vcf import read_genfile, read_phasefile, read_posfile
    from quilt_tpu.panel.prepare import PreparedReference, truncate_panel

    from .engine.driver import check_slice, quilt_impute

    cfg: ImputeConfig = _config_from_args(ImputeConfig, args)
    try:
        check_slice(cfg)
    except NotImplementedError as e:
        print(str(e), file=sys.stderr)
        return 2
    region_name = cfg.chr
    if cfg.regionStart is not None:
        region_name += f".{cfg.regionStart}.{cfg.regionEnd}"
    out_file = cfg.output_filename or os.path.join(cfg.outputdir, f"quilt.{region_name}.vcf.gz")
    if not cfg.overwrite_existing_vcf and os.path.exists(out_file):
        print(f"Output {out_file} already exists and --overwrite_existing_vcf=FALSE",
              file=sys.stderr)
        return 1
    prep_file = cfg.prepared_reference_filename or os.path.join(
        cfg.outputdir, "RData", f"QUILT_prepared_reference.{region_name}.npz")
    if not os.path.exists(prep_file) and cfg.reference_vcf_file:
        print_message("No prepared reference found; preparing now")
        if not cfg.save_prepared_reference and cfg.temporary_prepared_reference_filename:
            prep_file = cfg.temporary_prepared_reference_filename
        pargs = argparse.Namespace(**vars(args))
        pargs.output_file = prep_file
        if quilt2 and not getattr(pargs, "use_mspbwt", False):
            pargs.use_mspbwt = True
            pargs.impute_rare_common = True
        rc = cmd_prepare(pargs)
        if rc:
            return rc
    prep = PreparedReference.load(prep_file)
    if cfg.panel_size is not None and cfg.panel_size < prep.K:
        print_message(f"Truncating panel to {cfg.panel_size} haplotypes")
        prep = truncate_panel(prep, cfg.panel_size)

    bam_files: List[str] = []
    for lst in (cfg.bamlist, cfg.cramlist):
        if lst:
            with open(lst) as fh:
                bam_files += [line.strip() for line in fh if line.strip()]
    if not bam_files:
        print("--bamlist or --cramlist with at least one file is required", file=sys.stderr)
        return 1
    if cfg.sampleNames_file:
        with open(cfg.sampleNames_file) as fh:
            names = [line.strip() for line in fh if line.strip()]
    else:
        names = [bam_sample_name(b) or os.path.basename(b).split(".")[0] for b in bam_files]
    chrlen = bam_chromosome_length(bam_files[0], prep.chrom)
    if chrlen is None:
        print_message(f"Warning: chromosome {prep.chrom} not in the header of "
                      f"{bam_files[0]}; reads will not be found")
    # under rare/common the reads are loaded, and the outputs written, on
    # the all-SNP axis
    rc_mode = cfg.impute_rare_common and prep.pos_all is not None
    pos, ref_allele, alt_allele, grid = (
        (prep.pos_all, prep.ref_allele_all, prep.alt_allele_all, prep.grid_all) if rc_mode
        else (prep.pos, prep.ref_allele, prep.alt_allele, prep.grid))
    samples = [
        load_bam_reads(
            b, chrom=prep.chrom, snp_pos=pos, ref_allele=ref_allele,
            alt_allele=alt_allele, grid=grid, bqFilter=cfg.bqFilter,
            iSizeUpperLimit=cfg.iSizeUpperLimit, downsampleToCov=cfg.downsampleToCov,
            use_bx_tag=cfg.use_bx_tag, bxTagUpperLimit=cfg.bxTagUpperLimit,
            seed=cfg.seed, cram_fasta=cfg.reference or None,
            useSoftClippedBases=cfg.useSoftClippedBases,
        )
        for b in bam_files
    ]
    truth_gen = truth_haps = None
    if cfg.posfile and (cfg.genfile or cfg.phasefile):
        _, pos_t, _, _ = read_posfile(cfg.posfile)
        idx = {p: i for i, p in enumerate(pos_t)}
        sel = np.array([idx.get(p, -1) for p in pos])
        ok = sel >= 0
        if cfg.genfile:
            gnames, gen = read_genfile(cfg.genfile)
            truth_gen = np.full((len(pos), len(names)), np.nan)
            for j, nm in enumerate(names):
                if nm in gnames:
                    truth_gen[ok, j] = gen[sel[ok], gnames.index(nm)]
        if cfg.phasefile:
            pnames, phase = read_phasefile(cfg.phasefile)
            truth_haps = np.full((len(pos), len(names), 2), np.nan)
            for j, nm in enumerate(names):
                if nm in pnames:
                    truth_haps[ok, j, :] = phase[sel[ok], pnames.index(nm), :2]
            if truth_gen is None:
                truth_gen = truth_haps.sum(axis=2)
    os.makedirs(cfg.outputdir or ".", exist_ok=True)
    quilt_impute(prep, samples, names, cfg, device, output_filename=out_file,
                 truth_gen=truth_gen, truth_haps=truth_haps)
    return 0


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> int:
    """Run one subcommand. `impute` runs on `device`, by default the CUDA
    device, which must exist (tests pass device="cpu")."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        prog="python -m quilt_tpu_torch",
        description="QUILT1 / QUILT2 diploid imputation on an NVIDIA GPU (PyTorch + CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    quilt2 = {"use_mspbwt": True, "impute_rare_common": True}
    _add_dataclass_args(sub.add_parser("prepare", help="prepare reference panel"),
                        PrepareConfig)
    _add_dataclass_args(sub.add_parser(
        "prepare2", help="prepare reference panel (QUILT2 defaults: use_mspbwt + "
        "impute_rare_common)"), PrepareConfig, overrides=quilt2)
    _add_dataclass_args(sub.add_parser("impute", help="impute (QUILT1 diploid)"),
                        ImputeConfig)
    _add_dataclass_args(sub.add_parser(
        "impute2", help="impute (QUILT2 diploid: use_mspbwt + impute_rare_common)"),
        ImputeConfig, overrides=quilt2)
    args = parser.parse_args(argv)
    print_message("quilt_tpu_torch invocation: " + " ".join(argv))
    if args.command in ("prepare", "prepare2"):
        return cmd_prepare(args)
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print(f"quilt_tpu_torch {args.command} needs a CUDA GPU, and none is available",
                  file=sys.stderr)
            return 1
        device = "cuda"
    return cmd_impute(args, device, quilt2=args.command == "impute2")
