"""The port's QUILT2 paths on the CPU (plain kernel versions): msPBWT
selection and rare/common all-SNP imputation through the batched engine,
against truth and against the JAX engine on the world of
tests/test_engine_batched.py:test_batched_rare_common (prepared with
msPBWT indices too), and `prepare2` + `impute2` through the CLI.

The engines draw from different generators, so they are compared
statistically: per sample, r2 > 0.85 and within 0.1 of the JAX engine's,
and with rare/common the mean dosage error at rare sites < 0.3."""
import numpy as np
import pytest
import torch

from quilt_tpu.config import ImputeConfig
from quilt_tpu.engine import quilt_impute as jax_quilt_impute
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.out.bgzf import bgzf_open
from quilt_tpu.panel import prepare_panel

from quilt_tpu_torch import cli
from quilt_tpu_torch.engine.driver import quilt_impute
from quilt_tpu_torch.engine.rare_common import restrict_reads_to_common
from quilt_tpu_torch.simulate import write_bam_world

torch.set_num_threads(2)

BASE = dict(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
            small_ref_panel_gibbs_iterations=8, seed=13, sample_batch=4)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    K, nSNPs = 100, 640
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    for s in rng.choice(nSNPs, 40, replace=False):
        haps[:, s] = 0
        haps[rng.integers(0, K), s] = 1
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64,
                         impute_rare_common=True, rare_af_threshold=0.03, use_mspbwt=True)
    samples, truths = [], []
    for i in range(3):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid_all, coverage=2.0,
                                         read_length_bp=500 + 100 * i, phred=25)
        samples.append(reads)
        truths.append(truth)
    truth_gen = np.stack([t.sum(axis=0) for t in truths], axis=1).astype(float)
    return prep, samples, truth_gen


@pytest.mark.parametrize("use_mspbwt,impute_rare_common", [
    (True, True), (True, False), (False, True),
])
def test_quilt2_engine_matches_jax(world, use_mspbwt, impute_rare_common, tmp_path):
    prep, samples, truth_gen = world
    if not impute_rare_common:
        # without rare/common the engines impute the common SNPs from
        # common-SNP reads
        samples = [restrict_reads_to_common(r, prep.snp_is_common, prep.grid) for r in samples]
        truth_gen = truth_gen[prep.snp_is_common]
    names = [f"S{i}" for i in range(len(samples))]
    cfg = ImputeConfig(use_mspbwt=use_mspbwt, impute_rare_common=impute_rare_common, **BASE)
    out = quilt_impute(prep, samples, names, cfg, "cpu",
                       output_filename=str(tmp_path / "port.vcf.gz"), truth_gen=truth_gen)
    ref = jax_quilt_impute(prep, samples, names, cfg, truth_gen=truth_gen)
    rare = ~prep.snp_is_common
    n_out = truth_gen.shape[0]
    for i, (r2, r2_ref) in enumerate(zip(out.r2_per_sample, ref.r2_per_sample)):
        assert r2 > 0.85, f"sample {i}: port r2 {r2}"
        assert abs(r2 - r2_ref) < 0.1, f"sample {i}: port {r2} vs jax {r2_ref}"
        res = out.results[i]
        assert res.dosage.shape == (n_out,) and res.gp.shape == (3, n_out)
        np.testing.assert_allclose(res.gp.sum(0), 1.0, atol=1e-4)
        if impute_rare_common:
            err = np.abs(res.dosage[rare] - truth_gen[rare, i]).mean()
            assert err < 0.3, f"sample {i}: rare-SNP dosage error {err}"
    body = [l for l in bgzf_open(str(tmp_path / "port.vcf.gz")) if not l.startswith("#")]
    assert len(body) == n_out


def test_cli_prepare2_and_impute2_on_cpu(tmp_path):
    vcf, gmap, bamlist, truths, nSNPs = write_bam_world(str(tmp_path), np.random.default_rng(3),
                                                        n_rare=24)
    outdir = str(tmp_path / "out")
    assert cli.main(["prepare2", "--outputdir", outdir, "--chr", "chr20",
                     "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
                     "--nGen", "100", "--rare_af_threshold", "0.03"]) == 0
    assert cli.main(["impute2", "--outputdir", outdir, "--chr", "chr20", "--bamlist", bamlist,
                     "--nGibbsSamples", "3", "--n_seek_its", "2", "--Ksubset", "48",
                     "--Knew", "48", "--small_ref_panel_gibbs_iterations", "8"],
                    device="cpu") == 0
    from quilt_tpu.panel.prepare import PreparedReference
    prep = PreparedReference.load(f"{outdir}/RData/QUILT_prepared_reference.chr20.npz")
    assert (~prep.snp_is_common).sum() >= 24 and prep.ms_indices is not None
    body = [l for l in bgzf_open(f"{outdir}/quilt.chr20.vcf.gz") if not l.startswith("#")]
    assert len(body) == nSNPs                      # every all-SNP site
    for i in range(2):
        ds = np.array([float(l.split("\t")[9 + i].split(":")[2]) for l in body])
        r2 = np.corrcoef(ds, truths[i].sum(axis=0))[0, 1] ** 2
        assert r2 > 0.85, f"sample {i} r2 {r2}"
