"""The port's batched engine and CLI on the CPU (plain kernel versions),
against truth and against the JAX engine on the same synthetic world.

The two engines draw their randomness from different generators, so they
are compared statistically: each sample's r2 against truth is > 0.9 for
the port and within 0.03 of the JAX engine's."""
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
from quilt_tpu_torch.engine.context import context_fields
from quilt_tpu_torch.dist.hosts import process_info
from quilt_tpu_torch.engine.driver import _region_context, quilt_impute
from quilt_tpu_torch.simulate import write_bam_world

torch.set_num_threads(2)

BASE = dict(nGibbsSamples=3, n_seek_its=2, Ksubset=48, Knew=48,
            small_ref_panel_gibbs_iterations=8, seed=21, sample_batch=4)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    K, nSNPs, N = 100, 448, 4
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64)
    samples, truths = [], []
    for i in range(N):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=1.5,
                                         read_length_bp=400 + 100 * i, phred=25)
        samples.append(reads)
        truths.append(truth)
    truth_gen = np.stack([t.sum(axis=0) for t in truths], axis=1).astype(float)
    return prep, samples, truth_gen


def test_engine_accuracy_matches_jax(world, tmp_path):
    prep, samples, truth_gen = world
    names = [f"S{i}" for i in range(len(samples))]
    cfg = ImputeConfig(**BASE)
    out = quilt_impute(prep, samples, names, cfg, "cpu",
                       output_filename=str(tmp_path / "port.vcf.gz"), truth_gen=truth_gen)
    ref = jax_quilt_impute(prep, samples, names, cfg, truth_gen=truth_gen)
    for i, (r2, r2_ref) in enumerate(zip(out.r2_per_sample, ref.r2_per_sample)):
        assert r2 > 0.9, f"sample {i}: port r2 {r2}"
        assert abs(r2 - r2_ref) < 0.03, f"sample {i}: port {r2} vs jax {r2_ref}"
        res = out.results[i]
        assert res.gp.shape == (3, prep.nSNPs)
        np.testing.assert_allclose(res.gp.sum(0), 1.0, atol=1e-4)
        assert set(np.unique(res.phased_haps)) <= {0.0, 1.0}
    body = [l for l in bgzf_open(str(tmp_path / "port.vcf.gz")) if not l.startswith("#")]
    assert len(body) == prep.nSNPs


def test_engine_without_whole_panel_cache(world, monkeypatch):
    """Over the whole-panel eMatRead gate the engine builds each Gibbs
    call's emissions from the packed subset words (emat_read_from_bits)."""
    import quilt_tpu_torch.kernels.emissions as tem
    from quilt_tpu_torch.engine import batch

    monkeypatch.setattr(batch, "_CPU_LEM_BUDGET", 0)
    calls = []
    emat = tem.emat_read_from_bits
    monkeypatch.setattr(batch, "emat_read_from_bits",
                        lambda *a, **k: calls.append(1) or emat(*a, **k))
    prep, samples, truth_gen = world
    cfg = ImputeConfig(**{**BASE, "n_seek_its": 1, "n_burn_in_seek_its": 0})
    out = quilt_impute(prep, samples[:2], ["a", "b"], cfg, "cpu", truth_gen=truth_gen[:, :2])
    assert len(calls) == 2                     # one seek + one phasing call
    assert min(out.r2_per_sample) > 0.9, out.r2_per_sample


def test_region_context_key_is_derived(world):
    """The context cache key is the set of config fields the context build
    read: a change to one of them rebuilds, a change elsewhere reuses."""
    prep = world[0]
    _, fields = context_fields(prep, ImputeConfig(**BASE), "cpu")
    assert {"Ksubset", "Knew", "n_seek_its", "n_burn_in_seek_its",
            "heuristic_match_thin", "shuffle_bin_radius",
            "block_gibbs_quantile_prob", "max_block_gibbs_boundaries"} <= fields
    assert not {"outputdir", "seed", "nGibbsSamples", "sample_batch"} & fields
    from quilt_tpu_torch.engine.driver import _region_context

    a = _region_context(prep, ImputeConfig(**BASE), "cpu")
    assert _region_context(prep, ImputeConfig(**{**BASE, "seed": 5}), "cpu") is a
    assert _region_context(prep, ImputeConfig(**{**BASE, "heuristic_match_thin": 0.2}),
                           "cpu") is not a


@pytest.mark.parametrize("override", [
    {"mesh_data": 2}, {"distributed_nproc": 2}, {"mesh_panel": 2},
])
def test_out_of_slice_options_are_refused(world, override):
    """The multi-GPU options are ported; what is refused is a mesh larger
    than its devices (here the one CPU device), with the JAX function's
    ValueError. distributed_nproc alone, outside a process group, builds the
    one-device context: quilt_impute takes the process count from the group,
    as the JAX package's quilt_impute does."""
    cfg = ImputeConfig(**{**BASE, **override})
    if "distributed_nproc" in override:
        assert process_info() == (0, 1)
        assert _region_context(world[0], cfg, "cpu").mesh is None
    else:
        with pytest.raises(ValueError, match="devices"):
            _region_context(world[0], cfg, "cpu")


def test_cli_prepare_and_impute_on_cpu(tmp_path):
    vcf, gmap, bamlist, truths, nSNPs = write_bam_world(str(tmp_path), np.random.default_rng(3))
    outdir = str(tmp_path / "out")
    assert cli.main(["prepare", "--outputdir", outdir, "--chr", "chr20",
                     "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
                     "--nGen", "100"]) == 0
    imp = ["impute", "--outputdir", outdir, "--chr", "chr20", "--bamlist", bamlist,
           "--nGibbsSamples", "3", "--n_seek_its", "2", "--Ksubset", "48",
           "--Knew", "48", "--small_ref_panel_gibbs_iterations", "8"]
    assert cli.main(imp, device="cpu") == 0
    lines = list(bgzf_open(f"{outdir}/quilt.chr20.vcf.gz"))
    header = [l for l in lines if l.startswith("#CHROM")][0]
    assert header.rstrip("\n").split("\t")[9:] == ["SAMP0", "SAMP1"]
    body = [l for l in lines if not l.startswith("#")]
    assert len(body) == nSNPs
    for i in range(2):
        ds = np.array([float(l.split("\t")[9 + i].split(":")[2]) for l in body])
        r2 = np.corrcoef(ds, truths[i].sum(axis=0))[0, 1] ** 2
        assert r2 > 0.85, f"sample {i} r2 {r2}"
    # a mesh larger than the devices is refused; NIPT wants its fetal fractions
    assert cli.main(imp + ["--mesh_panel", "2"], device="cpu") == 2
    assert cli.main(imp + ["--method", "nipt"], device="cpu") == 1


def test_cli_impute_needs_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["impute", "--outputdir", str(tmp_path), "--chr", "chr20"]) == 1


def test_cli_ncores_loads_bams_in_processes(tmp_path, monkeypatch):
    """nCores > 1 reads the BAMs in a pool of that many processes
    (quilt_tpu/cli.py:388-393) and writes the VCF of nCores = 1."""
    import concurrent.futures

    vcf, gmap, bamlist, _, _ = write_bam_world(str(tmp_path), np.random.default_rng(4))
    outdir = str(tmp_path / "out")
    assert cli.main(["prepare", "--outputdir", outdir, "--chr", "chr20",
                     "--reference_vcf_file", vcf, "--genetic_map_file", gmap,
                     "--nGen", "100"]) == 0
    pools = []
    real = cli.ProcessPoolExecutor

    def counting(*a, **k):
        pools.append(k["max_workers"])
        return real(*a, **k)

    monkeypatch.setattr(cli, "ProcessPoolExecutor", counting)
    bodies = []
    for n in ("1", "2"):
        out = str(tmp_path / f"n{n}.vcf.gz")
        assert cli.main(["impute", "--outputdir", outdir, "--chr", "chr20", "--bamlist",
                         bamlist, "--nGibbsSamples", "2", "--n_seek_its", "1",
                         "--Ksubset", "48", "--Knew", "48",
                         "--small_ref_panel_gibbs_iterations", "4", "--nCores", n,
                         "--output_filename", out], device="cpu") == 0
        bodies.append([l for l in bgzf_open(out) if not l.startswith("#")])
    assert pools == [2] and issubclass(real, concurrent.futures.Executor)
    assert bodies[0] == bodies[1] and len(bodies[0]) > 100
