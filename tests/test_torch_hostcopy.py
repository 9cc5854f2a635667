"""The port's own copies of the JAX package's jax-free host modules
(config, utils, io, out, panel, native, kernels.nipt, hla, out.plots,
dist.ligate): the same seeded numpy inputs
through a copy and through its quilt_tpu original give equal results, and
files written by one package are read by the other."""
import ast
import dataclasses
import filecmp
import pathlib

import numpy as np
import pytest
import torch

import quilt_tpu.config as cfg_j
import quilt_tpu.dist.ligate as lig_j
import quilt_tpu.engine.sample as sample_j
import quilt_tpu.engine.selection as sel_j
import quilt_tpu.hla.db as hdb_j
import quilt_tpu.hla.prepare as hprep_j
import quilt_tpu.io.bam as bam_j
import quilt_tpu.io.bam_writer as bamw_j
import quilt_tpu.io.native as native_j
import quilt_tpu.io.simulate as sim_j
import quilt_tpu.io.vcf as vcf_j
import quilt_tpu.kernels.nipt as nipt_j
import quilt_tpu.out.bgzf as bgzf_j
import quilt_tpu.out.metrics as metrics_j
import quilt_tpu.out.plots as plots_j
import quilt_tpu.out.vcf_writer as vcfw_j
import quilt_tpu.panel.mspbwt as ms_j
import quilt_tpu.panel.prepare as prep_j
import quilt_tpu.utils as utils_j

import quilt_tpu_torch.config as cfg_t
import quilt_tpu_torch.dist.ligate as lig_t
import quilt_tpu_torch.engine.sample as sample_t
import quilt_tpu_torch.engine.selection as sel_t
import quilt_tpu_torch.hla.db as hdb_t
import quilt_tpu_torch.hla.prepare as hprep_t
import quilt_tpu_torch.io.bam as bam_t
import quilt_tpu_torch.io.bam_writer as bamw_t
import quilt_tpu_torch.io.native as native_t
import quilt_tpu_torch.io.simulate as sim_t
import quilt_tpu_torch.io.vcf as vcf_t
import quilt_tpu_torch.kernels.nipt as nipt_t
import quilt_tpu_torch.out.metrics as metrics_t
import quilt_tpu_torch.out.plots as plots_t
import quilt_tpu_torch.out.vcf_writer as vcfw_t
import quilt_tpu_torch.panel.mspbwt as ms_t
import quilt_tpu_torch.panel.prepare as prep_t
import quilt_tpu_torch.utils as utils_t

torch.set_num_threads(2)


def _same(a, b, path=""):
    """Deep equality of arrays, dataclasses, lists, dicts and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


@pytest.mark.parametrize("name", ["ImputeConfig", "PrepareConfig"])
def test_config_fields_and_defaults(name):
    fj = dataclasses.fields(getattr(cfg_j, name))
    ft = dataclasses.fields(getattr(cfg_t, name))
    assert [(f.name, str(f.type)) for f in fj] == [(f.name, str(f.type)) for f in ft]
    _same(dataclasses.asdict(getattr(cfg_j, name)()), dataclasses.asdict(getattr(cfg_t, name)()))
    if name == "ImputeConfig":
        assert (cfg_j.ImputeConfig(n_seek_its=5).resolved_n_burn_in_seek_its()
                == cfg_t.ImputeConfig(n_seek_its=5).resolved_n_burn_in_seek_its())


@pytest.mark.parametrize("nSNPs", [64, 77])
def test_bit_packing(nSNPs):
    haps = np.random.default_rng(3).integers(0, 2, (9, nSNPs)).astype(np.uint8)
    packed = utils_t.pack_bits_32(haps)
    np.testing.assert_array_equal(packed, utils_j.pack_bits_32(haps))
    np.testing.assert_array_equal(utils_t.unpack_bits_32(packed, nSNPs),
                                  utils_j.unpack_bits_32(packed, nSNPs))
    np.testing.assert_array_equal(utils_t.unpack_bits_32(packed, nSNPs), haps)


def _simulate(mod, seed=5, K=60, nSNPs=200):
    rng = np.random.default_rng(seed)
    haps, pos = mod.simulate_panel(rng, K=K, nSNPs=nSNPs)
    grid = (np.arange(nSNPs) // 32).astype(np.int32)
    truth = mod.simulate_truth_mosaic(rng, haps, n_latent=2)
    reads, sim = mod.simulate_sample_reads(rng, truth, pos, grid, coverage=1.5,
                                           read_length_bp=400, phred=25)
    return haps, pos, truth, reads, sim


def test_simulators_from_one_seed():
    a, b = _simulate(sim_j), _simulate(sim_t)
    for x, y in zip(a[:3], b[:3]):
        np.testing.assert_array_equal(x, y)
    _same(a[3], b[3], "reads")
    _same(a[4], b[4], "sim")


def _prepare(mod, quilt2):
    haps, pos = sim_j.simulate_panel(np.random.default_rng(9), K=80, nSNPs=300)
    if quilt2:
        haps[:, ::7] = 0
        haps[3, ::7] = 1
    opts = dict(impute_rare_common=True, use_mspbwt=True, mspbwt_nindices=3,
                rare_af_threshold=0.03) if quilt2 else {}
    n = len(pos)
    return mod.prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * n),
                             alt_allele=np.array(["G"] * n), haps=haps, nMaxDH=16, **opts)


@pytest.mark.parametrize("quilt2", [False, True], ids=["prepare", "prepare2"])
def test_prepare_panel_field_by_field(quilt2):
    a, b = _prepare(prep_j, quilt2), _prepare(prep_t, quilt2)
    assert a.panel.nMaxDH == b.panel.nMaxDH and len(a.panel.esc_k) > 0
    _same(a, b, "prep")
    if quilt2:
        assert len(a.ms_indices) == 3 and (~a.snp_is_common).sum() > 10


@pytest.mark.parametrize("quilt2", [False, True], ids=["prepare", "prepare2"])
@pytest.mark.parametrize("saver, loader", [(prep_j, prep_t), (prep_t, prep_j)],
                         ids=["jax-to-port", "port-to-jax"])
def test_prepared_reference_moves_between_packages(tmp_path, quilt2, saver, loader):
    prep = _prepare(saver, quilt2)
    path = str(tmp_path / "ref.npz")
    prep.save(path)
    _same(saver.PreparedReference.load(path), loader.PreparedReference.load(path), "prep")
    _same(prep.panel, loader.PreparedReference.load(path).panel, "panel")


def test_mspbwt_build_and_batch_selection():
    a, b = _prepare(prep_j, True), _prepare(prep_t, True)
    ia = ms_j.build_mspbwt_indices(a.panel.hapMatcher, n_indices=3)
    ib = ms_t.build_mspbwt_indices(b.panel.hapMatcher, n_indices=3)
    _same(ia, ib, "indices")
    rng = np.random.default_rng(4)
    hd = rng.random((3, 2, a.nSNPs))
    z = np.stack([[ms_j.symbols_from_hap_dosage(hd[r, h], a.panel.distinctHapsB, a.nSNPs)
                   for h in range(2)] for r in range(3)])
    z_t = np.stack([[ms_t.symbols_from_hap_dosage(hd[r, h], b.panel.distinctHapsB, b.nSNPs)
                     for h in range(2)] for r in range(3)])
    np.testing.assert_array_equal(z, z_t)
    prev = [rng.choice(a.K, 10, replace=False) for _ in range(3)]
    sel = [mod.select_new_haps_mspbwt_batch(idx, p.panel, z, 20, p.K, prev,
                                            np.random.default_rng(8))
           for mod, idx, p in ((ms_j, ia, a), (ms_t, ib, b))]
    _same(sel[0], sel[1], "selection")
    # the port's device symbols agree with the host symbols of both
    dev = ms_t.symbols_device(torch.from_numpy(hd).float(),
                              ms_t.distinct_hap_bits(b.panel, "cpu"), b.nSNPs).numpy()
    firm = np.abs(hd - 0.5).reshape(3, 2, -1) > 1e-6
    assert firm.all()
    np.testing.assert_array_equal(dev, z)


def _vcf_bytes(mod, path):
    rng = np.random.default_rng(2)
    n = 50
    gp = rng.dirichlet(np.ones(3), size=n).T
    haps = rng.integers(0, 2, (2, n)).astype(float)
    col = mod.diploid_sample_column(gp, haps, gp[1] + 2 * gp[2])
    counts = rng.integers(0, 5, (n, 3))
    mod.write_quilt_vcf(
        path, chrom="chr20", pos=np.arange(100, 100 + n), ref_allele=np.array(["A"] * n),
        alt_allele=np.array(["G"] * n), sample_names=["s1", "s2"], sample_columns=[col, col],
        eaf=rng.random(n), info=mod.info_score(rng.random(n), rng.random(n), 2),
        hwe=mod.hwe_from_counts(counts), allele_count=rng.random((n, 2)),
    )


def test_vcf_writer_bytes(tmp_path):
    pj, pt = str(tmp_path / "j.vcf.gz"), str(tmp_path / "t.vcf.gz")
    _vcf_bytes(vcfw_j, pj)
    _vcf_bytes(vcfw_t, pt)
    assert filecmp.cmp(pj, pt, shallow=False)
    assert filecmp.cmp(pj + ".tbi", pt + ".tbi", shallow=False)


def _write_bam(mod, path, pos, hap):
    rng = np.random.default_rng(6)
    with mod.BamWriter(path, "chrX", 5000, sample_name="NA1") as w:
        for r in range(40):
            start0 = int(rng.integers(400, 900))
            seq = []
            for off in range(100):
                si = np.searchsorted(pos, start0 + 1 + off)
                hit = si < len(pos) and pos[si] == start0 + 1 + off
                seq.append(("G" if hap[si] else "A") if hit else "C")
            w.write_read(f"r{r}", start0, "".join(seq), [28] * 100)


@pytest.mark.parametrize("writer, reader", [(bamw_j, bam_t), (bamw_t, bam_j)],
                         ids=["jax-writes", "port-writes"])
def test_bam_crosses_packages(tmp_path, writer, reader):
    pos = np.arange(500, 500 + 40 * 13, 13, dtype=np.int64)
    hap = np.random.default_rng(1).integers(0, 2, 40)
    grid = (np.arange(40) // 32).astype(np.int32)
    ref, alt = np.array(["A"] * 40), np.array(["G"] * 40)
    pj, pt = str(tmp_path / "j.bam"), str(tmp_path / "t.bam")
    _write_bam(bamw_j, pj, pos, hap)
    _write_bam(bamw_t, pt, pos, hap)
    assert filecmp.cmp(pj, pt, shallow=False)
    path = pj if writer is bamw_j else pt
    other = bam_j if reader is bam_t else bam_t
    kw = dict(downsampleToCov=10000, use_bx_tag=False, use_native=False)
    got = reader.load_bam_reads(path, "chrX", pos, ref, alt, grid, **kw)
    own = other.load_bam_reads(path, "chrX", pos, ref, alt, grid, **kw)
    assert got.nReads > 10
    _same(got, own, "reads")
    assert reader.bam_sample_name(path) == "NA1"
    assert reader.bam_chromosome_length(path, "chrX") == 5000


def test_metrics():
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 2, (300, 2)).astype(float)
    test = np.clip(truth + rng.normal(0, 0.3, truth.shape), 0, 1)
    test[100:] = test[100:, ::-1]
    assert metrics_t.r2_simple(truth.sum(1), test.sum(1)) == metrics_j.r2_simple(
        truth.sum(1), test.sum(1))
    _same(metrics_t.calculate_pse(test, truth), metrics_j.calculate_pse(test, truth))
    af = rng.random(300)
    np.testing.assert_array_equal(
        metrics_t.r2_by_freq(np.array([0.0, 0.3, 1.0]), af, truth.sum(1), test.sum(1)),
        metrics_j.r2_by_freq(np.array([0.0, 0.3, 1.0]), af, truth.sum(1), test.sum(1)))


def test_native_and_python_io_agree(tmp_path):
    if not native_t.native_available():
        pytest.skip("no C++ toolchain")
    haps, pos = sim_t.simulate_panel(np.random.default_rng(12), K=30, nSNPs=77)
    ref = np.array(list("ACGT" * 20))[:77]
    alt = np.array(list("TACG" * 20))[:77]
    p = str(tmp_path / "p.vcf.gz")
    bamw_t.write_panel_vcf(p, "chr2", pos, ref, alt, haps)
    py = vcf_t.read_panel_vcf(p, use_native=False)
    n_pos, n_ref, n_alt, rhb_t, names, _ = native_t.read_panel_vcf_native(p)
    np.testing.assert_array_equal(n_pos, py.pos)
    np.testing.assert_array_equal(n_ref, py.ref_allele)
    np.testing.assert_array_equal(utils_t.unpack_bits_32(rhb_t, 77), py.haps)
    assert names == py.sample_names
    _same(py, vcf_j.read_panel_vcf(p, use_native=False), "panel")
    if native_j.native_available():
        for x, y in zip(native_j.read_panel_vcf_native(p), (n_pos, n_ref, n_alt, rhb_t, names)):
            _same(x, y, "native")
    # the native panel compression and msPBWT build equal the NumPy ones
    rhb = utils_t.pack_bits_32(haps)
    _same(prep_t.compress_panel(rhb, 77, ref_error=0.001, nMaxDH=8),
          prep_j.compress_panel(rhb, 77, ref_error=0.001, nMaxDH=8), "panel")


@pytest.mark.parametrize("ff", [0.0, 0.1, 0.35])
def test_nipt_tables_and_oracles(ff):
    """kernels/nipt.py: the relabelling tables, the per-ff class tables and
    the NumPy oracles of the read classification and the relabelling
    choices give equal results in both packages."""
    for name in ("PERMS", "INVS", "CLASS_PERM", "MUL", "CLASS_PERM_INV"):
        np.testing.assert_array_equal(getattr(nipt_t, name), getattr(nipt_j, name))
    assert nipt_t.CLASS_SUM_CUTOFF == nipt_j.CLASS_SUM_CUTOFF
    for fn in ("nipt_prior", "make_rlc", "class_log_p"):
        np.testing.assert_array_equal(getattr(nipt_t, fn)(ff), getattr(nipt_j, fn)(ff))
    rng = np.random.default_rng(int(ff * 100))
    prior, rlc = nipt_t.nipt_prior(ff), nipt_t.make_rlc(ff)
    for _ in range(20):
        gain, pC = rng.random(3), rng.random(3)
        lose_C, h = float(rng.random()), int(rng.integers(0, 3))
        assert (nipt_t.classify_read_np(gain, lose_C, pC, h, prior, rlc)
                == nipt_j.classify_read_np(gain, lose_C, pC, h, prior, rlc))
        cmat, ns = rng.random((3, 3)), rng.integers(0, 30, 8).astype(float)
        np.testing.assert_array_equal(nipt_t.perm_choice_probs_np(cmat, ns, ff),
                                      nipt_j.perm_choice_probs_np(cmat, ns, ff))
        rc = rng.integers(0, 50, 3).astype(float)
        np.testing.assert_array_equal(nipt_t.entire_relabel_probs_np(rc, ff),
                                      nipt_j.entire_relabel_probs_np(rc, ff))
        assert nipt_t.log_dmultinom_np(rc, prior) == nipt_j.log_dmultinom_np(rc, prior) \
            or ff == 0.0
        u = float(rng.random())
        p = rng.dirichlet(np.ones(6))
        assert nipt_t.sample_index_np(p, u) == nipt_j.sample_index_np(p, u)


ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", ["__init__", "db", "imgt", "ancillary", "prepare"])
def test_hla_module_is_a_copy(name):
    """The jax-free HLA modules are the JAX package's, statement for
    statement (hla/typing.py is a port: tests/test_torch_hla.py)."""
    src = [(ROOT / pkg / "hla" / f"{name}.py").read_text() for pkg in ("quilt_tpu", "quilt_tpu_torch")]
    assert ast.dump(ast.parse(src[0])) == ast.dump(ast.parse(src[1]))


def _hla_prepared(db_mod, prep_mod, panel_mod):
    """An allele database simulated from one seed and a panel whose
    haplotypes carry its alleles, prepared by one package's modules."""
    rng = np.random.default_rng(4)
    gene = db_mod.HLAGene("HLA-C", "chr6", 2_001, 3_500)
    db = db_mod.simulate_hla_db(rng, gene, n_alleles=12, n_variant_sites=40)
    var = np.flatnonzero((db.seqs != db.seqs[0][None, :]).any(axis=0))
    pos = gene.start + var.astype(np.int64)
    ref = np.array([db_mod.BASES[b] for b in db.seqs[0, var]])
    alt = np.array([db_mod.BASES[(b + 1) % 4] for b in db.seqs[0, var]])
    states, _ = db_mod.alleles_at_positions(db, pos, ref, alt)
    haps = (states[rng.integers(0, 12, 50)] == 1).astype(np.uint8)
    prep = panel_mod.prepare_panel(chrom="chr6", pos=pos, ref_allele=ref, alt_allele=alt,
                                   haps=haps, nMaxDH=32)
    return prep_mod.prepare_hla_reference(db, prep, k=8)


def test_prepare_hla_reference_field_by_field():
    a = _hla_prepared(hdb_j, hprep_j, prep_j)
    b = _hla_prepared(hdb_t, hprep_t, prep_t)
    assert (a.hap_labels >= 0).sum() > 40 and len(a.kmers) > 1000
    _same(a, b, "hla")
    gamma = np.random.default_rng(1).dirichlet(np.ones(50))
    np.testing.assert_array_equal(a.allele_prior_from_gamma(gamma),
                                  b.allele_prior_from_gamma(gamma))


@pytest.mark.parametrize("saver, loader", [(hprep_j, hprep_t), (hprep_t, hprep_j)],
                         ids=["jax-to-port", "port-to-jax"])
def test_hla_prepared_moves_between_packages(tmp_path, saver, loader):
    hla = _hla_prepared(hdb_j, hprep_j, prep_j) if saver is hprep_j else \
        _hla_prepared(hdb_t, hprep_t, prep_t)
    path = str(tmp_path / "hla.npz")
    saver.save_hla_prepared(hla, path)
    _same(saver.load_hla_prepared(path), loader.load_hla_prepared(path), "hla")
    _same(hla.db, loader.load_hla_prepared(path).db, "db")


def _host_case(name, rng):
    """(function name, module pair, args) of one host helper of the
    per-sample engine, on inputs drawn from rng."""
    haps, pos, truth, reads, sim = _simulate(sim_t, seed=int(rng.integers(100)))
    nSNPs = len(pos)
    if name == "select_new_haps_from_topk":
        ti = rng.integers(0, 60, (12, 8))
        return (sel_j, sel_t), (ti, rng.random((12, 8)), 20, 60,
                                rng.choice(60, 10, replace=False))
    if name == "read_confidence":
        nl = int(rng.integers(2, 4))
        em = rng.random((nl, 50)) ** 8
        em[:, :3] = 0.0
        return (sel_j, sel_t), (em,)
    if name == "gls_from_labels":
        return (sample_j, sample_t), (reads, sim.labels.astype(np.int32), 2, nSNPs, 1e-10)
    if name == "emat_read_vs_dosages":
        return (sample_j, sample_t), (reads, rng.random((2, nSNPs)))
    tv, ti = rng.random((16, 6, 8)), rng.integers(0, 60, (16, 6, 8))
    return (sample_j, sel_t), (tv, ti, np.array([1, 4, 9]), 2, 1, 8)


@pytest.mark.parametrize("name", ["select_new_haps_from_topk", "read_confidence",
                                  "gls_from_labels", "emat_read_vs_dosages",
                                  "_gather_topk_lists"])
def test_per_sample_host_helpers(name):
    """The per-sample engine's NumPy helpers, copied from modules of the JAX
    package that import jax, give equal results on equal inputs (and equal
    draws from equal generators)."""
    for seed in range(3):
        (mj, mt), args = _host_case(name, np.random.default_rng(seed))
        extra = ([np.random.default_rng(seed)], [np.random.default_rng(seed)]) \
            if name == "select_new_haps_from_topk" else ([], [])
        _same(getattr(mj, name)(*args, *extra[0]), getattr(mt, name)(*args, *extra[1]), name)


@pytest.mark.parametrize("path", ["out/plots.py", "dist/ligate.py"])
def test_diagnostic_module_is_a_copy(path):
    """out/plots.py and dist/ligate.py are the JAX package's, statement for
    statement."""
    src = [(ROOT / pkg / path).read_text() for pkg in ("quilt_tpu", "quilt_tpu_torch")]
    assert ast.dump(ast.parse(src[0])) == ast.dump(ast.parse(src[1]))


def _plot_case(name, rng):
    """(function name, kwargs) of one plotting function on seeded inputs."""
    n, G, C, R = 120, 24, 3, 40
    if name == "plot_sample_diagnostics":
        gp = rng.dirichlet(np.ones(3), n).T
        return dict(pos=np.sort(rng.choice(10_000, n, replace=False)), dosage=gp[1] + 2 * gp[2],
                    gp=gp, af=rng.random(n), truth_gen=rng.integers(0, 3, n).astype(float),
                    per_it_likelihoods=rng.normal(size=(9, C, 8)))
    if name == "plot_heuristic_comparison":
        return dict(traces={"QUILT1 top-K": list(rng.random(3)), "mspbwt A": list(rng.random(3))})
    if name == "plot_read_label_flips":
        return dict(read_label_usage=rng.integers(0, 3 if rng.random() < 0.5 else 2, (2, C, R)))
    if name == "plot_hclass":
        return dict(H_class=rng.integers(0, 8, (C, R)))
    L = np.cumsum(rng.integers(100, 2000, G))
    return dict(L_grid=L, smooth_rate=rng.random(G - 1), boundaries=np.array([3, 9, 17]),
                read_label_usage=rng.integers(0, 2, (2, C, R)), read_grids=rng.integers(0, G, R))


def _data_files(outdir):
    """{name: content} of the data files a plotting function wrote (arrays
    of each npz, rows of each table)."""
    out = {}
    for f in sorted((pathlib.Path(outdir) / "plots").iterdir()):
        if f.suffix == ".npz":
            with np.load(f) as z:
                out[f.name] = {k: z[k] for k in z.files}
        elif f.name.endswith(".tsv.gz"):
            out[f.name] = np.loadtxt(f, skiprows=1)
        elif f.suffix == ".tsv":
            out[f.name] = f.read_text()
    return out


@pytest.mark.parametrize("name", ["plot_sample_diagnostics", "plot_heuristic_comparison",
                                  "plot_read_label_flips", "plot_hclass", "plot_block_gibbs"])
def test_plots_write_equal_data_files(tmp_path, name):
    """Each plotting function writes the same data files from both
    packages (the figures only where matplotlib imports)."""
    for seed in range(2):
        kw = _plot_case(name, np.random.default_rng(seed))
        got = {}
        for pkg, mod in (("jax", plots_j), ("port", plots_t)):
            d = str(tmp_path / f"{pkg}{seed}")
            getattr(mod, name)(d, "S0", "chr20", **kw)
            got[pkg] = _data_files(d)
        assert got["port"], name
        _same(got["jax"], got["port"], name)


def test_ligation_from_both_packages(tmp_path):
    """quilt_chunk_map and ligate_vcfs of both packages on seeded chunks."""
    rng = np.random.default_rng(6)
    pos = np.sort(rng.choice(np.arange(1, 30_000_000), 4000, replace=False))
    cm = np.cumsum(rng.exponential(1e-3, len(pos)))
    _same(lig_j.quilt_chunk_map("chr1", pos, cm, min_bp=3_000_000, min_cm=0.5),
          lig_t.quilt_chunk_map("chr1", pos, cm, min_bp=3_000_000, min_cm=0.5), "chunks")
    paths = []
    for c, sites in enumerate((np.arange(100, 800, 100), np.arange(500, 1200, 100))):
        p = str(tmp_path / f"c{c}.vcf.gz")
        with bgzf_j.BgzfWriter(p) as w:
            w.write("##fileformat=VCFv4.0\n")
            w.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS0\tS1\n")
            for s in sites:
                gts = [("0|1", "1|0", "1|1", "0|0")[int(rng.integers(0, 4))] for _ in range(2)]
                w.write(f"1\t{s}\t.\tA\tG\t.\tPASS\t.\tGT:GP:DS:HD\t"
                        + "\t".join(f"{g}:1,0,0:0.5:0.2,0.3" for g in gts) + "\n")
        paths.append(p)
    outs = []
    for mod in (lig_j, lig_t):
        out = str(tmp_path / f"lig_{mod.__name__.split('.')[0]}.vcf.gz")
        mod.ligate_vcfs(paths, out)
        outs.append(list(bgzf_j.bgzf_open(out)))
    assert outs[0] == outs[1] and len([l for l in outs[0] if not l.startswith("#")]) == 11


@pytest.mark.parametrize("K,nGrids,kw", [(300, 40, {}), (97, 7, dict(n_founders=5, switch=0.3)),
                                         (64, 3, dict(mutation_per_bit=0.0))])
def test_fast_packed_panel_equals_bench_py(K, nGrids, kw):
    """quilt_tpu_torch.bench.common.fast_packed_panel is the root bench.py's,
    bit for bit from one seed (the port does not import bench.py)."""
    import importlib.util

    from quilt_tpu_torch.bench.common import fast_packed_panel

    path = pathlib.Path(__file__).resolve().parent.parent / "bench.py"
    spec = importlib.util.spec_from_file_location("_jax_side_bench", path)
    bench_j = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench_j)
    got = fast_packed_panel(np.random.default_rng(K), K, nGrids, **kw)
    want = bench_j.fast_packed_panel(np.random.default_rng(K), K, nGrids, **kw)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
