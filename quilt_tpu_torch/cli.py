"""Command line of the port:

    python -m quilt_tpu_torch prepare ...   (reference preparation, on the host)
    python -m quilt_tpu_torch impute ...    (QUILT1 diploid, on the GPU)
    python -m quilt_tpu_torch prepare2 ...  (prepare with the QUILT2 defaults)
    python -m quilt_tpu_torch impute2 ...   (QUILT2 diploid, on the GPU)
    python -m quilt_tpu_torch hla-prepare ... (HLA reference preparation, on the host)
    python -m quilt_tpu_torch hla ...       (HLA allele typing, on the GPU)

The flags are the JAX package's, generated from the config dataclasses
(config.py, a copy of quilt_tpu/config.py); the QUILT2 verbs default
use_mspbwt and impute_rare_common to TRUE, as the JAX package's do.
`prepare` and `hla-prepare` are copies of quilt_tpu/cli.py:cmd_prepare /
cmd_hla_prepare over the port's own readers and reference preparation.
`impute`, `impute2` and `hla` run on the CUDA device; without a GPU they
exit non-zero. --mesh_data / --mesh_panel run on a mesh of the visible
cards (a mesh larger than the cards exits non-zero); --distributed_nproc N
with --distributed_rank R (and --distributed_coordinator host:port, default
localhost:12321) runs one process of N: each reads and imputes its shard of
the BAMs on card R mod (the host's cards), and process 0 writes the VCF.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from typing import List, Optional

import numpy as np

from .config import ImputeConfig, PrepareConfig
from .utils import print_message, set_verbosity


def _add_dataclass_args(
    parser: argparse.ArgumentParser, cls, overrides: Optional[dict] = None
) -> None:
    overrides = overrides or {}
    for f in dataclasses.fields(cls):
        name = f"--{f.name}"
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else (f.default_factory() if f.default_factory is not dataclasses.MISSING else None)
        )
        if f.name in overrides:
            default = overrides[f.name]
        if f.type in ("bool", bool):
            parser.add_argument(
                name, type=lambda x: x.upper() in ("TRUE", "1", "YES"),
                default=default, metavar="TRUE/FALSE",
            )
        elif f.type in ("int", int, "Optional[int]"):
            parser.add_argument(name, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(name, type=float, default=default)
        elif "List[int]" in str(f.type):
            parser.add_argument(
                name, type=lambda s: [int(x) for x in s.split(",")],
                default=default,
            )
        elif "List[str]" in str(f.type) or "Optional[List[str]]" in str(f.type):
            parser.add_argument(
                name, type=lambda s: s.split(","), default=default
            )
        else:
            parser.add_argument(name, type=str, default=default)


def _config_from_args(cls, args) -> object:
    kw = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name):
            kw[f.name] = getattr(args, f.name)
    return cls(**kw)


def _read_region_exclude(path: str, chrom: str):
    """Regions to exclude, from a space-separated file with header
    Name Chr Start End (reference: remove_sites_from_pos_to_use,
    prepare_reference_functions.R:39-56)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"Cannot find region_exclude_file: {path}")
    out = []
    with open(path) as fh:
        header = fh.readline().split()
        cols = {c.lower(): i for i, c in enumerate(header)}
        for line in fh:
            p = line.split()
            if not p:
                continue
            if p[cols.get("chr", 1)] != chrom:
                continue
            out.append((int(p[cols.get("start", 2)]),
                        int(p[cols.get("end", 3)])))
    if not out:
        print_message(
            "Warning: no regions to exclude from region_exclude_file "
            "(is the chr the same?)"
        )
    return out


def _write_sites_vcf(path: str, chrom, pos, ref_allele, alt_allele) -> None:
    """Minimal sites-only VCF, bgzipped + tabixed (reference:
    make_face_vcf_with_sites_list, prepare_reference_functions.R:1-33)."""
    from .out.bgzf import BgzfWriter
    from .out.tabix import TabixIndexer

    idx = TabixIndexer()
    with BgzfWriter(path) as w:
        w.write("##fileformat=VCFv4.2\n")
        w.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for i in range(len(pos)):
            vbeg = w.tell_virtual()
            w.write(
                f"{chrom}\t{pos[i]}\t.\t{ref_allele[i]}\t{alt_allele[i]}"
                f"\t.\tPASS\t.\n"
            )
            idx.add(str(chrom), int(pos[i]), vbeg, w.tell_virtual())
    idx.write(path + ".tbi")


def cmd_prepare(args) -> int:
    from .io.vcf import read_panel_vcf, read_genetic_map
    from .panel.prepare import prepare_panel

    cfg: PrepareConfig = _config_from_args(PrepareConfig, args)
    if not cfg.reference_vcf_file and not cfg.reference_haplotype_file:
        print(
            "--reference_vcf_file or --reference_haplotype_file is required",
            file=sys.stderr,
        )
        return 1
    # confidence in reference alleles (reference:
    # quilt-prepare-reference.R:127 ref_error <- 10^(-reference_phred/10))
    cfg.ref_error = 10.0 ** (-cfg.reference_phred / 10.0)
    region_start = (
        None if cfg.regionStart is None else cfg.regionStart - cfg.buffer
    )
    region_end = None if cfg.regionEnd is None else cfg.regionEnd + cfg.buffer
    keep = None
    exclude = None
    if cfg.reference_sample_file:
        import csv
        rows = list(csv.reader(open(cfg.reference_sample_file), delimiter=" "))
        header, rows = rows[0], rows[1:]
        if cfg.reference_populations:
            keep = [r[0] for r in rows if r[1] in cfg.reference_populations]
    if cfg.reference_exclude_samplelist_file:
        exclude = [
            l.split()[0] for l in open(cfg.reference_exclude_samplelist_file)
        ]
    presplit = None
    if (cfg.reference_vcf_file and cfg.chr and keep is None
            and exclude is None and not cfg.region_exclude_file):
        # streaming packed ingest (tabix/CSI region seek, native rare/common
        # split): the [K, nSNPs] allele matrix is never inflated on host
        try:
            from .io.native import native_available, read_panel_vcf_packed
            if native_available():
                presplit = read_panel_vcf_packed(
                    cfg.reference_vcf_file,
                    region_chrom=cfg.chr or None,
                    region_start=region_start,
                    region_end=region_end,
                    rare_af_threshold=(
                        cfg.rare_af_threshold
                        if cfg.impute_rare_common else None
                    ),
                )
        except Exception as e:
            print_message(f"Streaming panel ingest failed ({e}); "
                          f"using row-matrix path")
            presplit = None
    if presplit is not None:
        p_chrom = cfg.chr
        p_pos = presplit["pos"]
        p_ref, p_alt = presplit["ref_allele"], presplit["alt_allele"]
        p_haps = None
        p_names = presplit["sample_names"]
        print_message(
            f"Read panel VCF (streaming): {presplit['K']} haplotypes x "
            f"{len(p_pos)} SNPs ({presplit['n_skipped']} skipped"
            f"{', indexed' if presplit['used_index'] else ''})"
        )
    elif cfg.reference_vcf_file:
        panel = read_panel_vcf(
            cfg.reference_vcf_file,
            region_chrom=cfg.chr or None,
            region_start=region_start,
            region_end=region_end,
            keep_samples=keep,
            exclude_samples=exclude,
        )
        p_chrom, p_pos = panel.chrom, panel.pos
        p_ref, p_alt, p_haps = panel.ref_allele, panel.alt_allele, panel.haps
        p_names = panel.sample_names
    else:
        from .io.vcf import read_hap_legend
        p_pos, p_ref, p_alt, p_haps, p_names = read_hap_legend(
            cfg.reference_haplotype_file, cfg.reference_legend_file,
            cfg.reference_sample_file,
            region_start=region_start, region_end=region_end,
        )
        p_chrom = cfg.chr
    if cfg.region_exclude_file:
        # drop panel sites inside excluded regions (reference:
        # remove_sites_from_pos_to_use, prepare_reference_functions.R:39-56)
        excl = _read_region_exclude(cfg.region_exclude_file, p_chrom)
        keep_mask = np.ones(len(p_pos), dtype=bool)
        for start, end in excl:
            keep_mask &= ~((p_pos >= start) & (p_pos <= end))
        n_drop = int((~keep_mask).sum())
        if n_drop:
            print_message(
                f"Excluding {n_drop} sites in {len(excl)} regions from "
                f"region_exclude_file"
            )
            p_pos = p_pos[keep_mask]
            p_ref = np.asarray(p_ref)[keep_mask]
            p_alt = np.asarray(p_alt)[keep_mask]
            p_haps = p_haps[:, keep_mask]      # haps is [K, nSNPs]
    gmap_pos = gmap_cm = None
    if cfg.genetic_map_file:
        gmap_pos, gmap_cm = read_genetic_map(cfg.genetic_map_file)
    prep = prepare_panel(
        chrom=p_chrom,
        pos=p_pos,
        ref_allele=p_ref,
        alt_allele=p_alt,
        haps=p_haps,
        gmap_pos=gmap_pos,
        gmap_cm=gmap_cm,
        nGen=cfg.nGen,
        expRate=cfg.expRate,
        minRate=cfg.minRate,
        maxRate=cfg.maxRate,
        ref_error=cfg.ref_error,
        nMaxDH=cfg.nMaxDH,
        regionStart=cfg.regionStart,
        regionEnd=cfg.regionEnd,
        buffer=cfg.buffer,
        impute_rare_common=cfg.impute_rare_common,
        rare_af_threshold=cfg.rare_af_threshold,
        use_mspbwt=cfg.use_mspbwt,
        mspbwt_nindices=cfg.mspbwt_nindices,
        sample_names=p_names if p_names is not None and len(p_names) else None,
        presplit=presplit,
    )
    out = cfg.output_file
    if not out:
        region_name = cfg.chr or p_chrom
        if cfg.regionStart is not None:
            region_name += f".{cfg.regionStart}.{cfg.regionEnd}"
        out = os.path.join(
            cfg.outputdir, "RData",
            f"QUILT_prepared_reference.{region_name}.npz",
        )
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    prep.save(out)
    print_message(f"Saved prepared reference to {out}")
    if cfg.make_fake_vcf_with_sites_list:
        region_name = cfg.chr or p_chrom
        if cfg.regionStart is not None:
            region_name += f".{cfg.regionStart}.{cfg.regionEnd}"
        sites = cfg.output_sites_filename or os.path.join(
            cfg.outputdir, f"quilt.sites.{region_name}.vcf.gz"
        )
        _write_sites_vcf(sites, p_chrom, p_pos, p_ref, p_alt)
        print_message(f"Wrote sites VCF to {sites}")
    return 0



def _mesh_fits(cfg: ImputeConfig, device) -> bool:
    """The mesh the config asks for fits the visible cards (else says so)."""
    from .dist.mesh import default_devices, mesh_from_config

    try:
        mesh_from_config(cfg, default_devices(device))
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return False
    return True


def cmd_impute(args, device, quilt2: bool = False) -> int:
    cfg: ImputeConfig = _config_from_args(ImputeConfig, args)
    if cfg.distributed_nproc <= 1:
        return _impute(cfg, args, device, quilt2)
    import torch

    from .dist.hosts import DEFAULT_COORDINATOR, init_multihost

    # one process of a group: processes sharing a host share its cards
    if torch.device(device).type == "cuda":
        device = f"cuda:{cfg.distributed_rank % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    init_multihost(cfg.distributed_coordinator or DEFAULT_COORDINATOR, cfg.distributed_nproc,
                   cfg.distributed_rank)
    try:
        return _impute(cfg, args, device, quilt2)
    finally:
        torch.distributed.destroy_process_group()


def _impute(cfg: ImputeConfig, args, device, quilt2: bool) -> int:
    from .dist.hosts import process_info, reduce_sum_across_hosts, sample_shards
    from .engine.driver import quilt_impute
    from .io.bam import bam_chromosome_length, bam_sample_name, load_bam_reads
    from .io.vcf import read_genfile, read_phasefile, read_posfile
    from .panel.prepare import PreparedReference, truncate_panel

    if not _mesh_fits(cfg, device):
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
    rank, nproc = process_info()
    need = not os.path.exists(prep_file) and bool(cfg.reference_vcf_file)
    if nproc > 1:
        # the processes agree before any prepares; process 0 prepares
        need = bool(reduce_sum_across_hosts({"n": np.array([int(need)])})["n"][0])
    if need:
        print_message("No prepared reference found; preparing now")
        if not cfg.save_prepared_reference and cfg.temporary_prepared_reference_filename:
            prep_file = cfg.temporary_prepared_reference_filename
        pargs = argparse.Namespace(**vars(args))
        pargs.output_file = prep_file
        if quilt2 and not getattr(pargs, "use_mspbwt", False):
            pargs.use_mspbwt = True
            pargs.impute_rare_common = True
        rc = cmd_prepare(pargs) if rank == 0 else 0
        if nproc > 1:
            import torch.distributed

            torch.distributed.barrier()
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
    load_one = partial(
        load_bam_reads, chrom=prep.chrom, snp_pos=pos, ref_allele=ref_allele,
        alt_allele=alt_allele, grid=grid, bqFilter=cfg.bqFilter,
        iSizeUpperLimit=cfg.iSizeUpperLimit, downsampleToCov=cfg.downsampleToCov,
        use_bx_tag=cfg.use_bx_tag, bxTagUpperLimit=cfg.bxTagUpperLimit,
        seed=cfg.seed, cram_fasta=cfg.reference or None,
        useSoftClippedBases=cfg.useSoftClippedBases,
    )
    # in a process group each process reads only its shard of the BAMs
    local = [int(i) for i in sample_shards(len(bam_files), nproc)[rank]]
    samples = [None] * len(bam_files)
    if cfg.nCores > 1 and len(local) > 1:
        # read extraction in nCores processes (quilt_tpu/cli.py:388-393)
        with ProcessPoolExecutor(max_workers=cfg.nCores,
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            for i, r in zip(local, ex.map(load_one, [bam_files[i] for i in local])):
                samples[i] = r
    else:
        for i in local:
            samples[i] = load_one(bam_files[i])
    ff_values = None
    if cfg.method == "nipt":
        if not cfg.fflist:
            print("--fflist is required for method=nipt", file=sys.stderr)
            return 1
        ff_values = np.loadtxt(cfg.fflist, ndmin=1)
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
                 ff_values=ff_values, truth_gen=truth_gen, truth_haps=truth_haps,
                 region_name=region_name)
    return 0


def cmd_hla_prepare(args) -> int:
    """QUILT_HLA_prepare_reference equivalent: allele DB (+ prepared
    reference panel) -> kmer database + allele-labeled haplotypes."""
    from .hla.db import load_hla_db
    from .hla.prepare import prepare_hla_reference, save_hla_prepared
    from .panel.prepare import PreparedReference

    if args.ipd_igmt_alignments_zip_file:
        from .hla.db import HLAGene
        from .hla.imgt import load_imgt_zip

        if not args.region:
            print("--region is required with --ipd_igmt_alignments_zip_file", file=sys.stderr)
            return 1
        if args.region_end:
            gene = HLAGene(name=args.region, chrom=args.region_chrom,
                           start=args.region_start, end=args.region_end)
            strand = args.region_strand
        else:
            # built-in ancillary gene table (reference:
            # hla_ancillary_files/hlagenes.txt + supplementary strand info)
            from .hla.ancillary import gene_info, gene_strand
            gene = gene_info(args.region)
            if gene is None:
                print(f"unknown HLA gene {args.region}; pass --region_start/--region_end",
                      file=sys.stderr)
                return 1
            strand = gene_strand(args.region)
            print_message(f"HLA gene {gene.name}: {gene.chrom}:{gene.start}-{gene.end} "
                          f"strand {strand} (ancillary table)")
        db = load_imgt_zip(args.ipd_igmt_alignments_zip_file, gene, strand=strand)
        print_message(f"Parsed IPD-IMGT alignment for {gene.name}: "
                      f"{db.n_alleles} four-digit alleles x {db.gene.length} bp")
    elif args.hla_db:
        db = load_hla_db(args.hla_db)
    else:
        print("one of --hla_db / --ipd_igmt_alignments_zip_file is required", file=sys.stderr)
        return 1
    prep = PreparedReference.load(args.prepared_reference_filename)
    hla_types = None
    if args.hla_types_panel:
        from .hla.prepare import load_hla_types_panel
        region = args.region or db.gene.name.split("-")[-1]
        hla_types = load_hla_types_panel(args.hla_types_panel, region)
    hla = prepare_hla_reference(db, prep, k=args.kmer_size, hla_types=hla_types)
    save_hla_prepared(hla, args.output_file)
    print_message(f"Saved prepared HLA reference to {args.output_file}")
    return 0


def cmd_hla(args, device) -> int:
    """QUILT_HLA equivalent (quilt_tpu/cli.py:cmd_hla): impute each sample
    through the per-sample engine with gamma capture at the gene centre,
    take the gene's reads (the mapped gene-region reads and the reads on
    the gene's HLA alt contigs), type the alleles, and write the four
    summary tables; a comma-separated list of prepared HLA references types
    several genes in one invocation."""
    from .engine.context import RegionContext
    from .engine.sample import impute_one_sample
    from .hla.prepare import load_hla_prepared
    from .hla.typing import GeneRead, type_hla_sample, write_hla_summaries
    from .io.bam import (
        bam_sample_name, load_bam_reads, load_bam_sequences, load_hla_alt_contig_reads,
    )
    from .panel.prepare import PreparedReference

    cfg: ImputeConfig = _config_from_args(ImputeConfig, args)
    set_verbosity(cfg.verbose)
    if not _mesh_fits(cfg, device):
        return 2
    prep = PreparedReference.load(cfg.prepared_reference_filename)
    with open(cfg.bamlist) as fh:
        bam_files = [line.strip() for line in fh if line.strip()]
    names = [bam_sample_name(b) or os.path.basename(b).split(".")[0] for b in bam_files]
    refseq_contigs = None
    if args.hla_refseq_file:
        # contig-name list (reference's refseq file; get_that2 greps its
        # second column for HLA-<gene> names)
        from .out.bgzf import bgzf_open
        refseq_contigs = [
            line.split("\t")[0].removeprefix("SN:")
            for line in bgzf_open(args.hla_refseq_file)
            if line.strip() and not line.startswith("#")
        ]
    hla_files = [f for f in args.prepared_hla_reference_filename.split(",") if f]
    for hla_file in hla_files:
        hla = load_hla_prepared(hla_file)
        gene = hla.db.gene
        cfg.hla_run = True
        cfg.gamma_physically_closest_to = (gene.start + gene.end) // 2
        ctx = RegionContext.build(prep, cfg, device)
        results = {}
        for i, bam in enumerate(bam_files):
            reads = load_bam_reads(
                bam, prep.chrom, prep.pos, prep.ref_allele, prep.alt_allele,
                prep.grid, bqFilter=cfg.bqFilter,
                downsampleToCov=cfg.downsampleToCov, seed=cfg.seed,
            )
            res = impute_one_sample(ctx, reads, cfg, seed=cfg.seed + i)
            raw = load_bam_sequences(bam, gene.chrom, gene.start - 300, gene.end + 300)
            gene_reads = [GeneRead(pos0=p0, seq=seq, qual=q) for (_qn, p0, seq, q) in raw]
            if not args.no_hla_alt_contig_reads:
                # second read source: reads mapped to the gene's HLA alt
                # contigs (get_that2 / filter_that2, hla_functions.R:544-669),
                # placed on the allele alignment by kmer seeding
                alt_raw = load_hla_alt_contig_reads(
                    bam, gene.name, gene.chrom, gene.start, gene.end,
                    contig_names=[c for c in refseq_contigs if c.startswith(f"HLA-{gene.name}")]
                    if refseq_contigs else None,
                )
                gene_reads += [GeneRead(pos0=-1, seq=seq, qual=q) for (_qn, seq, q) in alt_raw]
                if alt_raw:
                    print_message(f"{bam}: +{len(alt_raw)} HLA alt-contig reads for {gene.name}")
            gam = res.hla_gamma_total if res.imputed else None
            results[names[i]] = type_hla_sample(hla, gene_reads, gammas=gam, device=device)
        ctx.timers.report()
        write_hla_summaries(results, names, cfg.outputdir or ".", gene.name)
        print_message(f"Wrote HLA summaries for {len(names)} samples ({gene.name})")
    return 0


def main(argv: Optional[List[str]] = None, device: Optional[str] = None) -> int:
    """Run one subcommand. `impute`, `impute2` and `hla` run on `device`, by
    default the CUDA device, which must exist (tests pass device="cpu")."""
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(
        prog="python -m quilt_tpu_torch",
        description="QUILT1 / QUILT2 imputation, diploid or NIPT (--method nipt --fflist), "
                    "and QUILT-HLA typing, on an NVIDIA GPU (PyTorch + CUDA port)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    quilt2 = {"use_mspbwt": True, "impute_rare_common": True}
    _add_dataclass_args(sub.add_parser("prepare", help="prepare reference panel"),
                        PrepareConfig)
    _add_dataclass_args(sub.add_parser(
        "prepare2", help="prepare reference panel (QUILT2 defaults: use_mspbwt + "
        "impute_rare_common)"), PrepareConfig, overrides=quilt2)
    _add_dataclass_args(sub.add_parser("impute", help="impute (QUILT1)"),
                        ImputeConfig)
    _add_dataclass_args(sub.add_parser(
        "impute2", help="impute (QUILT2: use_mspbwt + impute_rare_common)"),
        ImputeConfig, overrides=quilt2)
    p_hp = sub.add_parser("hla-prepare", help="prepare HLA reference")
    p_hp.add_argument("--hla_db", default="", help="prebuilt allele DB (.npz)")
    p_hp.add_argument("--ipd_igmt_alignments_zip_file", default="",
                      help="IPD-IMGT/HLA release zip with alignments/<gene>_gen.txt "
                           "(reference's flag spelling)")
    p_hp.add_argument("--region", default="", help="HLA gene name for --ipd_igmt_... (e.g. A)")
    p_hp.add_argument("--region_chrom", default="chr6")
    p_hp.add_argument("--region_start", type=int, default=0)
    p_hp.add_argument("--region_end", type=int, default=0)
    p_hp.add_argument("--region_strand", type=int, default=1)
    p_hp.add_argument("--prepared_reference_filename", required=True)
    p_hp.add_argument("--output_file", required=True)
    p_hp.add_argument("--kmer_size", type=int, default=10)
    p_hp.add_argument("--hla_types_panel", default="",
                      help="tab-separated unphased HLA types per reference sample "
                           "(Sample.ID + HLA.<gene>.1/.2 columns); enables the two-step "
                           "haplotype phasing")
    p_hla = sub.add_parser("hla", help="HLA allele typing")
    _add_dataclass_args(p_hla, ImputeConfig)
    p_hla.add_argument("--prepared_hla_reference_filename", required=True,
                       help="prepared HLA npz; comma-separate to type several genes in one "
                            "invocation")
    p_hla.add_argument("--hla_refseq_file", default="",
                       help="contig-name list restricting the HLA alt-contig read source "
                            "(reference's refseq file)")
    p_hla.add_argument("--no_hla_alt_contig_reads", action="store_true",
                       help="disable the HLA alt-contig read source")
    args = parser.parse_args(argv)
    print_message("quilt_tpu_torch invocation: " + " ".join(argv))
    if args.command in ("prepare", "prepare2"):
        return cmd_prepare(args)
    if args.command == "hla-prepare":
        return cmd_hla_prepare(args)
    if device is None:
        import torch

        if not torch.cuda.is_available():
            print(f"quilt_tpu_torch {args.command} needs a CUDA GPU, and none is available",
                  file=sys.stderr)
            return 1
        device = "cuda"
    if args.command == "hla":
        return cmd_hla(args, device)
    return cmd_impute(args, device, quilt2=args.command == "impute2")
