"""The port's engine on a mesh of CPU devices (quilt_impute with mesh_data /
mesh_panel and devices=["cpu"] * n): the port of tests/test_dist_engine.py
(slow-marked in the JAX suite; here its world at 320 SNPs and 5 sweeps a
Gibbs call, which keeps the three runs near 30 s), the data-only mesh
bit for bit, and a NIPT run on the mesh.

Tolerances: both runs r2 > 0.9 against truth; mesh against one device
within the JAX test's acceptance tolerances (compare_vcf ds_tol 0.1, gt_tol
0.03, r2_min 0.97; per-sample DS correlation r2 > 0.98): the sharded FB's
sums run in another order, which can flip near-tie haplotype selections.
mesh_data = 2, mesh_panel = 1 runs the single-device FB (same family) and
splits only the Gibbs chains, which are independent: the VCF is the
single-device VCF, byte for byte."""
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tools")

from compare_vcf import compare  # noqa: E402

from quilt_tpu_torch.config import ImputeConfig  # noqa: E402
from quilt_tpu_torch.dist.mesh import mesh_from_config  # noqa: E402
from quilt_tpu_torch.engine.driver import quilt_impute  # noqa: E402
from quilt_tpu_torch.io import simulate_panel, simulate_sample_reads  # noqa: E402
from quilt_tpu_torch.io.simulate import simulate_truth_mosaic  # noqa: E402
from quilt_tpu_torch.out.metrics import r2_simple  # noqa: E402
from quilt_tpu_torch.panel import prepare_panel  # noqa: E402

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8
COMMON = dict(nGibbsSamples=2, n_seek_its=2, Ksubset=64, Knew=64,
              small_ref_panel_gibbs_iterations=4, seed=7, verbose=False,
              override_default_params_for_small_ref_panel=False)


@pytest.fixture(scope="module")
def world():
    """tests/test_dist_engine.py's world at 320 SNPs: K = 150, nMaxDH 16
    (escapes in the sharded FB), 2 samples at 1.5x."""
    rng = np.random.default_rng(31)
    K, nSNPs = 150, 320
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=16)
    assert len(prep.panel.esc_k) > 0
    samples, truths = [], []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=1.5,
                                         read_length_bp=600, phred=25)
        samples.append(reads)
        truths.append(truth)
    return prep, samples, np.stack([t.sum(axis=0) for t in truths], axis=1)


@pytest.fixture(scope="module")
def single(world, tmp_path_factory):
    prep, samples, truth_gen = world
    path = str(tmp_path_factory.mktemp("single") / "single.vcf.gz")
    out = quilt_impute(prep, samples, ["S0", "S1"], ImputeConfig(**COMMON), "cpu",
                       output_filename=path, truth_gen=truth_gen)
    return out, path


def test_engine_mesh_matches_single_device(world, single, tmp_path):
    prep, samples, truth_gen = world
    out_single, v_single = single
    v_mesh = str(tmp_path / "mesh.vcf.gz")
    cfg = ImputeConfig(mesh_data=2, mesh_panel=4, **COMMON)
    out_mesh = quilt_impute(prep, samples, ["S0", "S1"], cfg, "cpu", output_filename=v_mesh,
                            truth_gen=truth_gen, devices=CPU8)
    from quilt_tpu_torch.engine.driver import _region_context

    ctx = _region_context(prep, cfg, "cpu", CPU8)
    assert ctx.mesh.shape == (2, 4) and ctx.sharded_fb is not None
    assert ctx.sharded_fb.exchanges > 0
    for r2s, r2m in zip(out_single.r2_per_sample, out_mesh.r2_per_sample):
        assert r2s > 0.9 and r2m > 0.9, (r2s, r2m)
    report = compare(v_mesh, v_single, ds_tol=0.1, gt_tol=0.03, r2_min=0.97)
    assert report["pass"], report
    for i in range(2):
        ds_m, ds_s = out_mesh.results[i].dosage, out_single.results[i].dosage
        assert np.corrcoef(ds_m, ds_s)[0, 1] ** 2 > 0.98


def test_data_mesh_gives_the_single_device_vcf(world, single, tmp_path):
    prep, samples, truth_gen = world
    v_mesh = str(tmp_path / "data.vcf.gz")
    cfg = ImputeConfig(mesh_data=2, mesh_panel=1, **COMMON)
    quilt_impute(prep, samples, ["S0", "S1"], cfg, "cpu", output_filename=v_mesh,
                 truth_gen=truth_gen, devices=CPU8)
    with open(v_mesh, "rb") as a, open(single[1], "rb") as b:
        assert a.read() == b.read()


def test_lone_sample_on_the_mesh(world):
    """A lone sample goes through the per-sample engine (as in the JAX
    driver), whose FB is the sharded one and whose Gibbs calls split over
    the mesh too."""
    prep, samples, truth_gen = world
    cfg = ImputeConfig(mesh_data=1, mesh_panel=2, **COMMON)
    out = quilt_impute(prep, samples[:1], ["S0"], cfg, "cpu", truth_gen=truth_gen[:, :1],
                       devices=CPU8)
    from quilt_tpu_torch.engine.driver import _region_context

    assert _region_context(prep, cfg, "cpu", CPU8).sharded_fb.exchanges > 0
    assert out.r2_per_sample[0] > 0.9


def test_nipt_on_the_mesh():
    """NIPT (3 latent haplotypes a chain) on a 2 x 2 mesh: the sharded FB
    and the split Gibbs call at nl = 3; the NIPT tests' accuracy floors
    (maternal r2 > 0.85, fetal > 0.5)."""
    rng = np.random.default_rng(2)
    K, nSNPs, ff = 100, 320, 0.2
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=40_000)
    prep = prepare_panel(chrom="chr21", pos=pos, ref_allele=np.array(["C"] * nSNPs),
                         alt_allele=np.array(["T"] * nSNPs), haps=haps, nMaxDH=64)
    samples, truths = [], []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=3)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=2.0,
                                         read_length_bp=300, phred=25, ff=ff)
        samples.append(reads)
        truths.append(truth)
    cfg = ImputeConfig(method="nipt", nGibbsSamples=2, n_seek_its=2, Ksubset=48, Knew=48,
                       small_ref_panel_gibbs_iterations=4, seed=4, verbose=False,
                       mesh_data=2, mesh_panel=2)
    out = quilt_impute(prep, samples, ["S0", "S1"], cfg, "cpu", ff_values=np.full(2, ff),
                       devices=CPU8)
    from quilt_tpu_torch.engine.driver import _region_context

    assert _region_context(prep, cfg, "cpu", CPU8).sharded_fb.exchanges > 0
    for t, res in zip(truths, out.results):
        assert r2_simple((t[0] + t[1]).astype(float), res.mat_dosage) > 0.85
        assert r2_simple((t[0] + t[2]).astype(float), res.fet_dosage) > 0.5


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2), (2, 2)])
def test_mesh_larger_than_its_devices_is_refused(mesh):
    cfg = ImputeConfig(mesh_data=mesh[0], mesh_panel=mesh[1])
    with pytest.raises(ValueError, match="devices"):
        mesh_from_config(cfg, ["cpu"] * (mesh[0] * mesh[1] - 1))
    assert mesh_from_config(cfg, ["cpu"] * mesh[0] * mesh[1]).shape == mesh
