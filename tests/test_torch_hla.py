"""QUILT-HLA and the per-sample engine of the port on the CPU (plain kernel
versions), against the JAX package on the same numpy-seeded inputs:

- impute_one_sample with hla_run on the world of tests/test_hla.py:20-49:
  the FB captures each chain's gamma at the gene grid (every captured row a
  distribution over the K haplotypes within 1e-5), and the top two alleles
  of allele_prior_from_gamma(hla_gamma_total) are the truth, as
  tests/test_hla.py:113-160 asserts of the JAX engine;
- type_hla_sample in both packages on the same reads and gammas (A = 200
  alleles, R = 300 reads): the pair scan within rtol 1e-6 + atol 1e-2
  (float32 Kahan sums of order 1e4, summed in another order), the pair
  posteriors within atol 1e-4, the same top pair;
- the CLI world of tests/test_cli_hla.py:14-80 through `hla-prepare` and
  `hla` (device="cpu"): the truth pair typed;
- a lone sample through quilt_impute goes through the per-sample engine, as
  in the JAX driver (QUILT1, NIPT, QUILT2): r2 within 0.02 (QUILT1, NIPT
  maternal) / 0.1 (QUILT2, as tests/test_torch_quilt2.py) of the JAX
  per-sample engine's on the same world (both draw their uniforms from one
  NumPy generator in the same order and agree to rounding here; a uniform
  within rounding of a label boundary may still part a chain);
- the region context rebuilds when gamma_physically_closest_to changes."""
import os
import types

import numpy as np
import pytest
import torch

import quilt_tpu.hla.typing as jax_typing
from quilt_tpu.config import ImputeConfig as JaxConfig
from quilt_tpu.engine import quilt_impute as jax_quilt_impute
from quilt_tpu.hla import prepare_hla_reference as jax_prepare_hla
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.out.metrics import r2_simple
from quilt_tpu.panel import prepare_panel

from quilt_tpu_torch.cli import main
from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine import driver
from quilt_tpu_torch.engine.context import RegionContext
from quilt_tpu_torch.engine.sample import impute_one_sample
from quilt_tpu_torch.hla import HLAGene, prepare_hla_reference, simulate_hla_db
from quilt_tpu_torch.hla import typing as port_typing
from quilt_tpu_torch.hla.db import BASES, alleles_at_positions, save_hla_db
from quilt_tpu_torch.io.bam_writer import BamWriter, write_panel_vcf
from quilt_tpu_torch.panel import prepare_panel as prepare_panel_t

torch.set_num_threads(2)


def _gene_panel(rng, gene, n_alleles, n_variant_sites, K, prepare=prepare_panel_t):
    """An allele database and a panel over its variant sites in which each
    haplotype carries one allele's states (tests/test_hla.py:20-49)."""
    db = simulate_hla_db(rng, gene, n_alleles=n_alleles, n_variant_sites=n_variant_sites)
    var_sites = np.flatnonzero((db.seqs != db.seqs[0][None, :]).any(axis=0))
    pos = gene.start + var_sites.astype(np.int64)
    ref = np.array([BASES[b] for b in db.seqs[0, var_sites]])
    alt = np.array([BASES[db.seqs[:, s][db.seqs[:, s] != db.seqs[0, s]][0]] for s in var_sites])
    hap_allele = rng.integers(0, db.n_alleles, K)
    states, _ = alleles_at_positions(db, pos, ref, alt)
    haps = np.stack([np.where(states[hap_allele[k]] == 1, 1, 0)
                     for k in range(K)]).astype(np.uint8)
    prep = prepare(chrom="chr6", pos=pos, ref_allele=ref, alt_allele=alt, haps=haps,
                   nMaxDH=32)
    return db, prep, hap_allele, haps, (pos, ref, alt)


@pytest.fixture(scope="module")
def hla_world():
    rng = np.random.default_rng(7)
    gene = HLAGene("HLA-A", "chr6", 10_001, 13_000)
    db, prep, hap_allele, _, _ = _gene_panel(rng, gene, 6, 60, 40)
    return rng, gene, db, prep


def test_hla_run_through_the_per_sample_engine(hla_world):
    rng, gene, db, prep = hla_world
    hla = prepare_hla_reference(db, prep, k=8)
    true_a = (1, 3)
    states, _ = alleles_at_positions(db, prep.pos, prep.ref_allele, prep.alt_allele)
    truth = np.stack([np.where(states[a] == 1, 1, 0) for a in true_a]).astype(np.uint8)
    reads, _ = simulate_sample_reads(rng, truth, prep.pos, prep.grid, coverage=2.0,
                                     read_length_bp=400, phred=28)
    cfg = ImputeConfig(nGibbsSamples=3, n_seek_its=1, Ksubset=40, Knew=40,
                       small_ref_panel_gibbs_iterations=8, hla_run=True,
                       gamma_physically_closest_to=(gene.start + gene.end) // 2,
                       override_default_params_for_small_ref_panel=False)
    ctx = RegionContext.build(prep, cfg, "cpu")
    assert ctx.hla_capture
    g = int(prep.grid[np.abs(prep.pos - cfg.gamma_physically_closest_to).argmin()])
    assert ctx.fb_inputs.capture_grid == g
    res = impute_one_sample(ctx, reads, cfg, seed=11)
    assert res.hla_gammas.shape == (3, 2, prep.K)
    np.testing.assert_allclose(res.hla_gammas.sum(axis=2), 1.0, atol=1e-5)
    np.testing.assert_allclose(res.hla_gamma_total, res.hla_gammas.sum(axis=(0, 1)))
    prior = hla.allele_prior_from_gamma(res.hla_gamma_total)
    top2 = set(np.argsort(-prior)[:2].tolist())
    assert top2 == set(true_a), f"gamma alleles {top2} vs truth {set(true_a)}"


def _jax_pair_read_logsum():
    """The JAX package's pair scan, nested in its type_hla_sample (it closes
    over nothing of the enclosing function)."""
    code = next(c for c in jax_typing.type_hla_sample.__code__.co_consts
                if getattr(c, "co_name", "") == "_pair_read_logsum")
    assert not code.co_freevars
    return types.FunctionType(code, vars(jax_typing))


def test_typing_matches_jax():
    rng = np.random.default_rng(21)
    gene = HLAGene("HLA-B", "chr6", 5_001, 8_000)
    db, prep, _, _, _ = _gene_panel(rng, gene, 200, 120, 120)
    hla_t = prepare_hla_reference(db, prep, k=10)
    hla_j = jax_prepare_hla(db, prep, k=10)
    true_a, L = (17, 140), 120
    reads_t, reads_j = [], []
    for r in range(300):
        start = int(rng.integers(0, gene.length - L))
        seq = db.seqs[true_a[r % 2], start:start + L].copy()
        seq = np.where(rng.random(L) < 0.01, (seq + 1) % 4, seq).astype(np.uint8)
        qual = rng.integers(20, 40, L)
        reads_t.append(port_typing.GeneRead(pos0=gene.start - 1 + start, seq=seq, qual=qual))
        reads_j.append(jax_typing.GeneRead(pos0=gene.start - 1 + start, seq=seq, qual=qual))
    gam = rng.dirichlet(np.full(prep.K, 0.3), size=3)

    LL = np.stack([port_typing.read_allele_loglik(rd, hla_t) for rd in reads_t])
    got = port_typing._pair_read_logsum(LL, "cpu")
    ref = _jax_pair_read_logsum()(LL)
    assert np.abs(ref).max() > 1e4
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-2)

    res_t = port_typing.type_hla_sample(hla_t, reads_t, gammas=gam, device="cpu")
    res_j = jax_typing.type_hla_sample(hla_j, reads_j, gammas=gam)
    for mode in ("pairs_combined", "pairs_quilt_only"):
        pt = {(a, b): p for a, b, p in getattr(res_t, mode)}
        pj = {(a, b): p for a, b, p in getattr(res_j, mode)}
        assert pt.keys() == pj.keys() and len(pt) == 200 * 201 // 2
        keys = list(pt)
        np.testing.assert_allclose([pt[k] for k in keys], [pj[k] for k in keys], atol=1e-4)
        assert getattr(res_t, mode)[0][:2] == getattr(res_j, mode)[0][:2]
    expected = {db.allele_names[a] for a in true_a}
    assert {res_t.bestallele1, res_t.bestallele2} == expected


def test_cli_hla_on_cpu(tmp_path):
    """tests/test_cli_hla.py:14-80 through the port's verbs."""
    rng = np.random.default_rng(7)
    gene = HLAGene("HLA-B", "chr6", 5_001, 8_000)
    db, _, _, haps, (pos, ref, alt) = _gene_panel(rng, gene, 5, 50, 30)
    vcf = str(tmp_path / "panel.vcf.gz")
    write_panel_vcf(vcf, "chr6", pos, ref, alt, haps)
    db_path = str(tmp_path / "hla_db.npz")
    save_hla_db(db, db_path)
    true_a = (0, 2)
    bam = str(tmp_path / "s.bam")
    with BamWriter(bam, "chr6", 20_000, sample_name="HS") as w:
        L = 150
        for r in range(80):
            start = int(rng.integers(0, gene.length - L))
            seq = "".join(BASES[b] for b in db.seqs[true_a[r % 2], start:start + L])
            w.write_read(f"r{r}", gene.start - 1 + start, seq, [30] * L)
    bamlist = tmp_path / "bamlist.txt"
    bamlist.write_text(bam + "\n")
    outdir = str(tmp_path / "out")
    prep_file = str(tmp_path / "prep.npz")
    hla_prep = str(tmp_path / "hla_prep.npz")
    assert main(["prepare", "--outputdir", outdir, "--chr", "chr6",
                 "--reference_vcf_file", vcf, "--output_file", prep_file]) == 0
    assert main(["hla-prepare", "--hla_db", db_path, "--prepared_reference_filename",
                 prep_file, "--output_file", hla_prep, "--kmer_size", "8"]) == 0
    hla = ["hla", "--outputdir", outdir, "--chr", "chr6", "--bamlist", str(bamlist),
           "--prepared_reference_filename", prep_file,
           "--prepared_hla_reference_filename", hla_prep,
           "--nGibbsSamples", "2", "--n_seek_its", "1", "--Ksubset", "30", "--Knew", "30",
           "--small_ref_panel_gibbs_iterations", "6",
           "--override_default_params_for_small_ref_panel", "FALSE",
           "--downsampleToCov", "1000"]
    assert main(hla, device="cpu") == 0
    top = open(os.path.join(outdir, "quilt.hla.output.combined.topresult.HLA-B.txt")
               ).read().splitlines()
    assert len(top) == 2
    fields = top[1].split("\t")
    assert {fields[2], fields[3]} == {db.allele_names[a] for a in true_a}
    assert len([f for f in os.listdir(outdir) if f.startswith("quilt.hla.output")]) == 4


def test_cli_hla_needs_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["hla", "--outputdir", str(tmp_path), "--chr", "chr6",
                 "--prepared_hla_reference_filename", "x.npz"]) == 1


BASE = dict(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
            small_ref_panel_gibbs_iterations=8, seed=21)


def _lone_sample(monkeypatch, prep, reads, truth_gen, cfg_kw, ff_values=None):
    """One sample through both packages' quilt_impute; the port's must go
    through impute_one_sample and not the batched engine. Returns the
    port's and the JAX package's results."""
    calls = []
    real = driver.impute_one_sample
    monkeypatch.setattr(driver, "impute_one_sample",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(driver, "impute_samples_batched", None)
    out = driver.quilt_impute(prep, [reads], ["S0"], ImputeConfig(**cfg_kw), "cpu",
                              ff_values=ff_values, truth_gen=truth_gen)
    assert calls == [1]
    ref = jax_quilt_impute(prep, [reads], ["S0"], JaxConfig(**cfg_kw), ff_values=ff_values,
                           truth_gen=truth_gen)
    return out.results[0], ref.results[0]


def test_lone_sample_quilt1(monkeypatch):
    rng = np.random.default_rng(5)
    haps, pos = simulate_panel(rng, K=100, nSNPs=448)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * 448),
                         alt_allele=np.array(["G"] * 448), haps=haps, nMaxDH=64)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=1.5,
                                     read_length_bp=500, phred=25)
    tg = truth.sum(axis=0).astype(float)
    res, ref = _lone_sample(monkeypatch, prep, reads, tg[:, None], BASE)
    r2, r2_ref = r2_simple(tg, res.dosage), r2_simple(tg, ref.dosage)
    assert r2 > 0.9 and abs(r2 - r2_ref) < 0.02, (r2, r2_ref)
    np.testing.assert_allclose(res.gp.sum(0), 1.0, atol=1e-4)
    assert set(np.unique(res.phased_haps)) <= {0.0, 1.0}
    assert res.hla_gammas is None


def test_lone_sample_nipt(monkeypatch):
    rng = np.random.default_rng(9)
    haps, pos = simulate_panel(rng, K=100, nSNPs=448, region_span=60_000)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * 448),
                         alt_allele=np.array(["G"] * 448), haps=haps, nMaxDH=64)
    truth = simulate_truth_mosaic(rng, haps, n_latent=3)
    reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=4.0,
                                     read_length_bp=400, phred=25, ff=0.2)
    tm = (truth[0] + truth[1]).astype(float)
    res, ref = _lone_sample(monkeypatch, prep, reads, tm[:, None],
                            {**BASE, "method": "nipt"}, ff_values=np.array([0.2]))
    r2, r2_ref = r2_simple(tm, res.mat_dosage), r2_simple(tm, ref.mat_dosage)
    assert r2 > 0.85 and abs(r2 - r2_ref) < 0.02, (r2, r2_ref)
    r2f = r2_simple((truth[0] + truth[2]).astype(float), res.fet_dosage)
    assert r2f > 0.5 and res.phased_haps.shape == (3, 448), r2f


def test_lone_sample_quilt2(monkeypatch):
    """msPBWT selection and the rare/common all-SNP calls of the
    per-sample engine (the world of tests/test_torch_quilt2.py)."""
    rng = np.random.default_rng(7)
    K, nSNPs = 100, 640
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    for s in rng.choice(nSNPs, 40, replace=False):
        haps[:, s] = 0
        haps[rng.integers(0, K), s] = 1
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64,
                         impute_rare_common=True, rare_af_threshold=0.03, use_mspbwt=True)
    truth = simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid_all, coverage=2.0,
                                     read_length_bp=500, phred=25)
    tg = truth.sum(axis=0).astype(float)
    res, ref = _lone_sample(monkeypatch, prep, reads, tg[:, None],
                            {**BASE, "use_mspbwt": True, "impute_rare_common": True})
    r2, r2_ref = r2_simple(tg, res.dosage), r2_simple(tg, ref.dosage)
    assert r2 > 0.85 and abs(r2 - r2_ref) < 0.1, (r2, r2_ref)
    rare = ~prep.snp_is_common
    assert res.dosage.shape == (nSNPs,) and np.abs(res.dosage[rare] - tg[rare]).mean() < 0.3


def test_region_context_follows_the_gene_centre(hla_world):
    _, gene, _, prep = hla_world
    kw = dict(nGibbsSamples=2, n_seek_its=1, Ksubset=40, Knew=40, hla_run=True,
              override_default_params_for_small_ref_panel=False)
    a = driver._region_context(prep, ImputeConfig(**kw, gamma_physically_closest_to=gene.start),
                               "cpu")
    assert driver._region_context(
        prep, ImputeConfig(**kw, gamma_physically_closest_to=gene.start), "cpu") is a
    b = driver._region_context(prep, ImputeConfig(**kw, gamma_physically_closest_to=gene.end),
                               "cpu")
    assert b is not a and b.fb_inputs.capture_grid == prep.nGrids - 1
    assert a.fb_inputs.capture_grid == 0
    c = driver._region_context(prep, ImputeConfig(**kw), "cpu")
    assert c.fb_inputs.capture_grid == prep.nGrids // 2
    assert not driver._region_context(prep, ImputeConfig(**{**kw, "hla_run": False}),
                                      "cpu").hla_capture
