"""The per-sample diagnostic outputs of the port against the JAX package's,
on one numpy-seeded world (40 haplotypes x 256 SNPs with msPBWT indices,
two samples at 1.2x) run through both quilt_impute's:

- each of the nine options (make_heuristic_plot, record_read_label_usage,
  record_interim_dosages, output_read_label_prob, RData_objects_to_save,
  output_RData_filename, make_plots, plot_per_sample_likelihoods,
  addOptimalHapsToVCF) writes the same files, and the same npz keys with the
  same shapes, as the JAX package (make_heuristic_plot reruns each sample
  under both msPBWT approaches on the same context; NIPT's read classes
  under make_plots); OHD lands in the VCF with r2 > 0.9 against truth;
- optimal_hap_dosages is deterministic: within 5e-3 of the JAX function
  (the JAX FB's bf16 panel expansion), also on a context built for msPBWT
  selection (no FB inputs until it asks);
- the CLI with the record options, as tests/test_cli_flags.py runs the
  JAX one."""
import os

import numpy as np
import pytest
import torch

from quilt_tpu.config import ImputeConfig as JaxConfig
from quilt_tpu.engine import quilt_impute as jax_impute
from quilt_tpu.engine.sample import RegionContext as JaxContext
from quilt_tpu.engine.sample import optimal_hap_dosages as jax_ohd
from quilt_tpu.io import simulate_panel, simulate_sample_reads
from quilt_tpu.io.simulate import simulate_truth_mosaic
from quilt_tpu.out.bgzf import bgzf_open
from quilt_tpu.panel import prepare_panel

from quilt_tpu_torch import cli
from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine import driver
from quilt_tpu_torch.engine.sample import optimal_hap_dosages
from quilt_tpu_torch.panel.prepare import PreparedReference
from quilt_tpu_torch.panel.prepare import prepare_panel as prepare_panel_t
from quilt_tpu_torch.simulate import write_bam_world

torch.set_num_threads(2)

BASE = dict(nGibbsSamples=2, n_seek_its=2, Ksubset=32, Knew=32, sample_batch=2,
            small_ref_panel_gibbs_iterations=2, small_ref_panel_block_gibbs_iterations=[2],
            seed=3, verbose=False, override_default_params_for_small_ref_panel=False)


def _world(nipt=False):
    rng = np.random.default_rng(12 + nipt)
    K, nSNPs = 40, 256
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=50_000)
    kw = dict(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
              alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=32, use_mspbwt=True)
    prep_j = prepare_panel(**kw)
    samples, truths = [], []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=3 if nipt else 2)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep_j.grid, coverage=1.2,
                                         read_length_bp=400, phred=25, ff=0.2 if nipt else 0.0)
        samples.append(reads)
        truths.append(truth[:2])
    return dict(prep_j=prep_j, prep_t=prepare_panel_t(**kw), samples=samples,
                truth_gen=np.stack([t.sum(0) for t in truths], 1).astype(float),
                truth_haps=np.stack([t.T for t in truths], 1).astype(float))


@pytest.fixture(scope="module")
def world():
    return _world()


def _run_both(w, tmp_path, opts, nipt=False):
    """Both packages' quilt_impute with `opts`, each into its own output
    directory; returns {package: output directory}."""
    dirs = {}
    for pkg in ("jax", "port"):
        d = str(tmp_path / pkg)
        os.makedirs(d, exist_ok=True)
        o = {k: (v.replace("@", d) if isinstance(v, str) else v) for k, v in opts.items()}
        kw = dict(output_filename=os.path.join(d, "quilt.chr20.vcf.gz"),
                  truth_gen=w["truth_gen"], truth_haps=w["truth_haps"], region_name="chr20",
                  ff_values=np.full(2, 0.2) if nipt else None)
        extra = dict(method="nipt") if nipt else {}
        opts_ = {**BASE, **extra, "outputdir": d, **o}
        if pkg == "jax":
            jax_impute(w["prep_j"], w["samples"], ["S0", "S1"], JaxConfig(**opts_), **kw)
        else:
            driver.quilt_impute(w["prep_t"], w["samples"], ["S0", "S1"], ImputeConfig(**opts_),
                                "cpu", **kw)
        dirs[pkg] = d
    return dirs


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


def _npz_shapes(path):
    with np.load(path) as z:
        return {k: z[k].shape for k in z.files}


_FLAGS = {
    "make_heuristic_plot": {"make_heuristic_plot": True},
    "record_read_label_usage": {"record_read_label_usage": True},
    "record_interim_dosages": {"record_interim_dosages": True},
    "output_read_label_prob": {"output_read_label_prob": True},
    "RData_objects_to_save": {"RData_objects_to_save": ["dosage", "per_it_likelihoods", "gp"]},
    "output_RData_filename": {"output_RData_filename": "@/objects.npz"},
    "make_plots": {"make_plots": True, "record_read_label_usage": True},
    "plot_per_sample_likelihoods": {"plot_per_sample_likelihoods": True},
    # the per-sample engine, as the other options: the batched engine's OHD
    # is the same driver code (test_only_diagnostics_leave_the_batched_engine)
    "addOptimalHapsToVCF": {"addOptimalHapsToVCF": True, "sample_batch": 1},
}


@pytest.mark.parametrize("flag", list(_FLAGS))
def test_option_writes_what_jax_writes(world, tmp_path, flag):
    dirs = _run_both(world, tmp_path, _FLAGS[flag])
    files = {pkg: _files(d) for pkg, d in dirs.items()}
    assert files["port"] == files["jax"]
    assert len(files["port"]) > 2 or flag == "addOptimalHapsToVCF", files["port"]
    for f in files["port"]:
        paths = [os.path.join(dirs[p], f) for p in ("jax", "port")]
        if f.endswith(".npz"):
            shapes = [_npz_shapes(p) for p in paths]
            assert shapes[0] == shapes[1], f
            assert shapes[0], f
        elif f.endswith(".diagnostics.tsv.gz"):
            a, b = (np.loadtxt(p, skiprows=1) for p in paths)
            assert a.shape == b.shape and np.isfinite(b).all()
        elif f.endswith(".tsv"):
            rows = [[l.split("\t")[:2] for l in open(p).read().splitlines()] for p in paths]
            assert rows[0] == rows[1], f
    vcfs = [list(bgzf_open(os.path.join(dirs[p], "quilt.chr20.vcf.gz"))) for p in ("jax", "port")]
    fmt = [[l for l in v if l.startswith("##FORMAT")] for v in vcfs]
    assert fmt[0] == fmt[1]
    body = [l for l in vcfs[1] if not l.startswith("#")]
    assert body[0].split("\t")[8] == [l for l in vcfs[0] if not l.startswith("#")][0].split("\t")[8]
    if flag == "addOptimalHapsToVCF":
        assert body[0].split("\t")[8] == "GT:GP:DS:HD:OHD"
        for i in range(2):
            ohd = np.array([[float(x) for x in l.split("\t")[9 + i].split(":")[4].split(",")]
                            for l in body])
            assert np.isfinite(ohd).all()
            r2 = np.corrcoef(ohd.sum(1), world["truth_gen"][:, i])[0, 1] ** 2
            assert r2 > 0.9, r2
    if flag == "record_interim_dosages":
        # the chains' mean Gibbs dosage after each seek iteration
        with np.load(os.path.join(dirs["port"], "RData", "quilt.output.chr20.npz")) as z:
            sd = z["seek_dosages_S0"]
        assert sd.shape == (2, 256) and np.isfinite(sd).all() and (sd >= 0).all()


def test_nipt_read_classes_are_plotted(tmp_path):
    """NIPT under make_plots and output_read_label_prob: the read classes of
    the last Gibbs call (H_class) are dumped and plotted, as in JAX."""
    w = _world(nipt=True)
    dirs = _run_both(w, tmp_path, {"make_plots": True, "output_read_label_prob": True},
                     nipt=True)
    assert _files(dirs["port"]) == _files(dirs["jax"])
    assert any(f.startswith("plots/hclass.") for f in _files(dirs["port"]))
    npz = os.path.join("RData", "quilt.output.chr20.npz")
    shapes = [_npz_shapes(os.path.join(dirs[p], npz)) for p in ("jax", "port")]
    assert shapes[0] == shapes[1] and "H_class_S0" in shapes[1]


@pytest.mark.parametrize("opts, batched", [
    ({"addOptimalHapsToVCF": True}, True), ({}, True), ({"make_plots": True}, False),
    ({"record_interim_dosages": True}, False), ({"make_heuristic_plot": True}, False),
])
def test_only_diagnostics_leave_the_batched_engine(world, opts, batched, monkeypatch):
    """OHD alone keeps the batched engine; an option of the per-sample
    engine's diagnostics sends every sample there
    (quilt_tpu/engine/driver.py:146-158)."""
    engines = []
    monkeypatch.setattr(driver, "impute_samples_batched",
                        lambda ctx, reads, *a, **k: engines.append("batched") or
                        [driver.SampleResult(imputed=False)] * len(reads))
    monkeypatch.setattr(driver, "impute_one_sample",
                        lambda *a, **k: engines.append("one") or driver.SampleResult(imputed=False))
    driver.quilt_impute(world["prep_t"], world["samples"], ["S0", "S1"],
                        ImputeConfig(**{**BASE, **opts}), "cpu")
    assert engines == (["batched"] if batched else ["one", "one"])


@pytest.mark.parametrize("use_mspbwt", [False, True])
def test_optimal_hap_dosages_match_jax(world, use_mspbwt):
    opts = dict(BASE, use_mspbwt=use_mspbwt)
    ctx_t = driver._region_context(world["prep_t"], ImputeConfig(**opts), "cpu")
    ctx_j = JaxContext.build(world["prep_j"], JaxConfig(**opts))
    assert (ctx_t.fb_inputs is None) == use_mspbwt
    for i in range(2):
        got = optimal_hap_dosages(ctx_t, world["samples"][i], ImputeConfig(**opts),
                                  world["truth_haps"][:, i])
        ref = np.asarray(jax_ohd(ctx_j, world["samples"][i], JaxConfig(**opts),
                                 world["truth_haps"][:, i]))[:, :256]
        assert got.shape == (2, 256)
        np.testing.assert_allclose(got, ref, atol=5e-3)
    assert ctx_t.fb_inputs is not None


def test_cli_record_flags(tmp_path):
    """prepare with reference_phred and the sites list, then impute with
    panel_size, the record options, output_RData_filename and the timers;
    the overwrite guard (tests/test_cli_flags.py:test_flags_end_to_end)."""
    vcf, gmap, bamlist, truths, nSNPs = write_bam_world(
        str(tmp_path), np.random.default_rng(4), K=40, nSNPs=96, n_samples=1)
    outdir = str(tmp_path / "out")
    assert cli.main(["prepare", "--outputdir", outdir, "--chr", "chr20",
                     "--reference_vcf_file", vcf, "--reference_phred", "20",
                     "--make_fake_vcf_with_sites_list", "TRUE"]) == 0
    prep = PreparedReference.load(f"{outdir}/RData/QUILT_prepared_reference.chr20.npz")
    assert abs(prep.ref_error - 0.01) < 1e-12
    assert os.path.exists(f"{outdir}/quilt.sites.chr20.vcf.gz")
    npz_out = str(tmp_path / "objects.npz")
    argv = ["impute", "--outputdir", outdir, "--chr", "chr20", "--bamlist", bamlist,
            "--panel_size", "30", "--nGibbsSamples", "2", "--n_seek_its", "2",
            "--Ksubset", "16", "--Knew", "16", "--small_ref_panel_gibbs_iterations", "4",
            "--record_interim_dosages", "TRUE", "--record_read_label_usage", "TRUE",
            "--output_RData_filename", npz_out, "--make_plots", "TRUE",
            "--print_extra_timing_information", "TRUE"]
    assert cli.main(argv, device="cpu") == 0
    with np.load(npz_out) as z:
        assert "seek_dosages_SAMP0" in z and "read_label_usage_SAMP0" in z
        assert z["read_label_usage_SAMP0"].shape[0] == 2       # n_seek_its
        assert z["seek_dosages_SAMP0"].shape == (2, nSNPs)
    assert os.path.exists(f"{outdir}/plots/haps.SAMP0.chr20.diagnostics.tsv.gz")
    assert cli.main(argv + ["--overwrite_existing_vcf", "FALSE"], device="cpu") == 1
