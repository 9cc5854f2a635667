"""QUILT2's cell (`quilt2_topmed`) at a small size on the CPU: the all-SNP
panel built on the device equal to its host version word for word; the
port's symbols, reported long matches, selection and Gibbs haplotype
dosages against the plain reference (benchmark/reference/quilt2.py); the
benchmark's quilt2 method judging a sound run correct and a planted fault
not; the QUILT2 spans and counters in `timing` and in the report, with the
QUILT1 path's span names unchanged."""
import inspect
import json
import shutil
import textwrap
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import benchmark.harness as harness  # noqa: E402
import quilt_tpu_torch.engine.batch as batch_mod  # noqa: E402
import quilt_tpu_torch.kernels.gibbs as gibbs_mod  # noqa: E402
import quilt_tpu_torch.panel.mspbwt as ms_mod  # noqa: E402
from benchmark.reference import hmm  # noqa: E402
from benchmark.reference import quilt2 as ref  # noqa: E402
from quilt_tpu_torch.config import ImputeConfig  # noqa: E402
from quilt_tpu_torch.engine.driver import quilt_impute  # noqa: E402
from quilt_tpu_torch.engine.rare_common import (  # noqa: E402
    all_snp_panel, all_snp_panel_device,
)
from quilt_tpu_torch.io.simulate import (  # noqa: E402
    simulate_panel, simulate_sample_reads, simulate_truth_mosaic,
)
from quilt_tpu_torch.kernels.gibbs import SlotLayout, run_gibbs_chains  # noqa: E402
from quilt_tpu_torch.kernels.emissions import emat_read_from_bits, gather_words  # noqa: E402
from quilt_tpu_torch.inputs import GibbsInputs, PaddedReads, gibbs_trans  # noqa: E402
from quilt_tpu_torch.panel.mspbwt import (  # noqa: E402
    build_mspbwt_indices, distinct_hap_bits, select_new_haps_mspbwt_batch, symbols_device,
)
from quilt_tpu_torch.panel.prepare import compress_panel, prepare_panel, trans_rates  # noqa: E402
from quilt_tpu_torch.utils import pack_bits_32  # noqa: E402
from quilt_tpu_torch.utils.log import SectionTimers  # noqa: E402

torch.set_num_threads(2)

CELL = "tiny2.tiny"


# ---------------------------------------------------------------------------
# The all-SNP panel on the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,n_all,rare_share,chunk_grids", [
    (37, 200, 0.6, 1),          # a ragged last grid, a grid a chunk
    (64, 261, 0.75, 3),         # ragged, chunks of 3 grids
    (50, 320, 0.0, 2),          # no rare site at all
    (20, 96, 0.9, 8),           # nearly all rare, one chunk
])
def test_the_all_snp_panel_built_on_the_device_equals_the_host_build(K, n_all, rare_share,
                                                                      chunk_grids):
    rng = np.random.default_rng(K + n_all)
    common = rng.random(n_all) >= rare_share
    common[0] = True
    haps = (rng.random((K, int(common.sum()))) < 0.4).astype(np.uint8)
    rare = np.flatnonzero(~common)
    info = [np.sort(rng.choice(rare, size=min(len(rare), int(rng.integers(0, 5))),
                               replace=False)).astype(np.int64) for _ in range(K)]
    info[1] = np.zeros(0, np.int64)                    # a haplotype with no rare site
    at31 = rare[rare % 32 == 31]
    if len(at31):                                      # a carrier at bit 31
        info[0] = np.union1d(info[0], at31[:1])
    G = -(-n_all // 32)
    rhb = pack_bits_32(haps)
    host = all_snp_panel(rhb, common, info, G)
    dev = all_snp_panel_device(torch.as_tensor(rhb.view(np.int32)), common, info, G,
                               chunk_bytes=K * 32 * 8 * chunk_grids)
    assert dev.dtype == torch.int32 and dev.shape == (K, G)
    np.testing.assert_array_equal(dev.numpy(), host)
    if len(at31):
        assert (dev.numpy()[0, at31[0] // 32] < 0)     # bit 31 set: a negative int32


# ---------------------------------------------------------------------------
# Symbols, matches and the selection against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ms_world():
    """A founder-mosaic panel of 300 haplotypes over 16 grids, its
    compression and msPBWT indices, and haplotype dosages near panel
    haplotypes (some grids flipped to words no haplotype carries)."""
    rng = np.random.default_rng(24)
    K, G = 300, 16
    founders = rng.integers(0, 1 << 32, size=(6, G), dtype=np.uint32)
    rhb = founders[rng.integers(0, 6, size=(K, G)), np.arange(G)]
    flip = rng.random((K, G)) < 0.15
    rhb = rhb ^ np.where(flip, np.uint32(1) << rng.integers(0, 32, (K, G)).astype(np.uint32),
                         np.uint32(0))
    panel = compress_panel(rhb, G * 32, nMaxDH=8)
    idx = build_mspbwt_indices(panel.hapMatcher, 4, egs=2)
    src = rng.integers(0, K, size=(5, 2))
    bits = ((rhb[src][..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(5, 2, G * 32)
    dos = np.where(bits == 1, 0.9, 0.1) + rng.normal(0, 0.05, bits.shape)
    dos[:, :, 40:44] = 1 - dos[:, :, 40:44]
    return rhb, panel, idx, dos.astype(np.float32)


def test_the_ports_symbols_are_the_references(ms_world):
    rhb, panel, _, dos = ms_world
    dh = ref.DistinctHaps(rhb, n_max=8)
    np.testing.assert_array_equal(dh.hap.numpy(), panel.hapMatcher)
    z = symbols_device(torch.as_tensor(dos), distinct_hap_bits(panel, "cpu"),
                       dos.shape[-1]).numpy()
    np.testing.assert_array_equal(z, ref.symbols(dos, dh.table, dos.shape[-1]))


def test_the_ports_matches_and_selection_are_the_references(ms_world, monkeypatch):
    rhb, panel, idx, dos = ms_world
    K = rhb.shape[0]
    dh = ref.DistinctHaps(rhb, n_max=8)
    z = ref.symbols(dos, dh.table, dos.shape[-1])                      # [5, 2, G]
    reported = []
    real = ms_mod.match_z_batch

    def keep(index, Z, *a, **kw):
        reported.append(real(index, Z, *a, **kw))
        return reported[-1]

    monkeypatch.setattr(ms_mod, "match_z_batch", keep)
    rng = np.random.default_rng(3)
    prev = [np.sort(rng.choice(K, 10, replace=False)) for _ in range(5)]
    state = rng.bit_generator.state
    news = select_new_haps_mspbwt_batch(idx, panel, z, 40, K, prev, rng, mspbwtL=3)
    per_query = [[] for _ in range(10)]
    n_matches = n_cols = 0
    for index, res in zip(idx, reported):
        Zi = z.reshape(10, -1)[:, index.grids]
        hi = panel.hapMatcher[:, index.grids]
        want, longest = ref.approach_a(Zi, torch.as_tensor(hi), index.cp_cols, 3, 4)
        for q, lst in enumerate(res):
            per_query[q].extend(lst)
            n_matches += len(lst)
            assert ref.false_matches(Zi[q], lst, hi, 3) == 0
            assert set(lst) == set(want[q])
        cols, missed = ref.missed_checkpoints(longest, index.cp_cols, res, 3)
        assert missed == 0
        n_cols += cols
        # a scan that reports nothing misses every checkpoint with a long match
        assert ref.missed_checkpoints(longest, index.cp_cols, [[]] * len(res), 3) == (cols, cols)
    assert n_matches > 20 and n_cols > 0
    again = ref.select_rows(per_query, 2, max(len(i.grids) for i in idx), 40, K, prev, state)
    for a, b in zip(news, again):
        np.testing.assert_array_equal(a, b)
    matched = [{k for h in range(2) for k, _, _ in per_query[2 * r + h]} for r in range(5)]
    assert sum(int(k) not in m for new, m in zip(news, matched) for k in new) > 0   # a fill
    # a fault the reference's match check tells: a reported match one grid too long
    q, (k, e, L) = next((q, m) for q, lst in enumerate(reported[0]) for m in lst
                        if m[2] < m[1] + 1)
    assert ref.false_matches(z.reshape(10, -1)[q, idx[0].grids], [(k, e, L + 1)],
                             panel.hapMatcher[:, idx[0].grids], 3) == 1


# ---------------------------------------------------------------------------
# The Gibbs haplotype dosages against the reference
# ---------------------------------------------------------------------------

def test_the_gibbs_calls_hap_dosages_are_the_references():
    rng = np.random.default_rng(5)
    K, nSNPs, S, Ksub, n_its = 60, 256, 2, 24, 5
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=40_000)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps)
    reads = []
    for _ in range(S):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=2.0,
                                     read_length_bp=300, phred=25)
        reads.append(r.sorted_by_grid())
    trans = trans_rates(prep.sigma)
    gin = GibbsInputs.build_batched(reads, trans, prep.nGrids)
    pr = PaddedReads.build_batched(reads, ref_error=prep.ref_error)
    layout = SlotLayout.build(gin, S, "cpu")
    which = torch.as_tensor(np.stack([np.sort(rng.choice(K, Ksub, replace=False))
                                      for _ in range(S)]))
    words = gather_words(torch.as_tensor(prep.rhb_t.view(np.int32)), which)
    em = emat_read_from_bits(words, torch.as_tensor(pr.u_pad), torch.as_tensor(pr.lr),
                             torch.as_tensor(pr.la), 1e10, R_out=gin.R)
    lem, skip = torch.log(em), (em.amax(1) - em.amin(1)) <= 1e-9
    g = torch.Generator().manual_seed(1)
    call = run_gibbs_chains(layout, torch.as_tensor(np.ascontiguousarray(
        gibbs_trans(trans, prep.nGrids).T)), lem, skip,
        torch.rand((n_its, S, gin.R), generator=g),
        torch.as_tensor(rng.integers(0, 2, (S, gin.R)).astype(np.int32)),
        torch.zeros(S, dtype=torch.int32), False, Ksub, words=words, ref_error=prep.ref_error)
    cfg = {"nGen": prep.nGen, "expRate": 1.0, "minRate": 0.1, "maxRate": 100.0}
    stay, jump = hmm.transitions(pos, cfg)
    tables = [hmm.sample_tables(r.u, r.bq, r.offsets, prep.ref_error) for r in reads]
    want = ref.gibbs_hap_dosages(tables, prep.rhb_t, which.numpy(),
                                 [call.H[s, :reads[s].nReads].numpy() for s in range(S)], stay,
                                 jump, 1e10, prep.ref_error, nSNPs)
    np.testing.assert_allclose(call.hap_dos[:, :, :nSNPs].double().numpy(), want, atol=2e-5)
    low = ref.gibbs_hap_dosages(tables, prep.rhb_t, which.numpy(),
                                [call.H[s, :reads[s].nReads].numpy() for s in range(S)], stay,
                                jump, 1e10, prep.ref_error, nSNPs, dtype=torch.bfloat16)
    assert np.abs(low - want).max() > 1e-3                 # the control is told apart


# ---------------------------------------------------------------------------
# The method's run of a tiny cell
# ---------------------------------------------------------------------------

def _tiny_root(dst: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under dst, with the port
    beside it, and a cell CELL: the quilt2_topmed configuration at K = 800,
    2,048 sites (512 common), rare under 1%, Ksubset 48, 2 chains, 5
    sweeps; 2 samples a batch at ~1x."""
    root = dst / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "quilt_tpu_torch").symlink_to(ROOT / "quilt_tpu_torch")
    cfg = json.loads((root / "benchmark/configs/quilt2_topmed.json").read_text())
    cfg.update(name="tiny2", K=800, nSNPs=2048)
    cfg["impute"].update(Ksubset=48, Knew=48, nGibbsSamples=2, rare_af_threshold=0.01,
                         small_ref_panel_gibbs_iterations=4,
                         small_ref_panel_block_gibbs_iterations=[3])
    (root / "benchmark/configs/tiny2.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "benchmark/traffic/cov1x.b8.json").read_text())
    tr.update(name="tiny", sample_batch=2, pool_batches=2)
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(tr))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": CELL, "config": "tiny2", "traffic": "tiny", "chips": 1,
                             "why": "test"})
    for m in man["per_layer"] + man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _tiny_root(tmp_path_factory.mktemp("quilt2_cell"))


def _run(root, monkeypatch, keep=None):
    # this process holds the JAX package (tests/conftest.py); the benchmark's
    # own tests check that a run loads none of it
    monkeypatch.setattr(harness, "forbidden_modules", lambda names=None: [])
    return harness.run_cell(root, CELL, 2**31 + 77, 0.0, False, device="cpu", keep=keep)


def _shift_symbols(monkeypatch):
    real = batch_mod.symbols_device
    monkeypatch.setattr(batch_mod, "symbols_device",
                        lambda *a, **kw: torch.roll(real(*a, **kw), 1, -1))


def _beta_ones(monkeypatch):
    real = gibbs_mod.bwd_sweep
    monkeypatch.setattr(gibbs_mod, "bwd_sweep", lambda *a, **kw: torch.ones_like(real(*a, **kw)))


def _no_matches(monkeypatch):
    monkeypatch.setattr(ms_mod, "match_z_batch", lambda index, Z, *a, **kw: [[] for _ in Z])


def _rank_off_by_one(monkeypatch):
    """match_z_batch with its insertion point one past the rank of each
    column's update."""
    src = textwrap.dedent(inspect.getsource(ms_mod.match_z_batch))
    line = "p[m] = lo + np.searchsorted(row[lo:hi], p[m])"
    assert src.count(line) == 1
    ns = dict(vars(ms_mod))
    exec(src.replace(line, line + " + 1"), ns)
    monkeypatch.setattr(ms_mod, "match_z_batch", ns["match_z_batch"])


def test_a_sound_run_of_the_cell_is_correct(tiny_root, monkeypatch):
    keep = {}
    res = _run(tiny_root, monkeypatch, keep)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"sweep_alpha_gap", "wrong_draw_share", "hap_dosage_gap",
                                  "select_gap"}
    assert res["checks"]["select_gap"]["value"] == 0.0
    sel = keep["compare"]["select"]["counts"]
    assert sel["matches"] > 0 and sel["rows"] > 0 and sel["sym_rows"] > 0
    assert sel["cols"] > 0 and sel["missed"] == 0
    kinds = {k[0] for k in keep["state"]["sweeps"]}
    assert kinds == {"seek", "rare"}
    assert keep["compare"]["sweep"]["reads"] > 1000
    assert res["metrics"]["r2_mean"]["value"] > 0.8
    # the control, the reference in bfloat16 in the program's place, is not correct
    ctrl = keep["method"].control(keep, "cpu")
    for k in ("sweep_alpha_gap", "hap_dosage_gap"):
        assert ctrl[k] > res["checks"][k]["limit"], ctrl


@pytest.mark.parametrize("fault,number", [(_shift_symbols, "select_gap"),
                                          (_beta_ones, "wrong_draw_share"),
                                          (_no_matches, "select_gap"),
                                          (_rank_off_by_one, "select_gap")])
def test_a_planted_fault_is_not_correct(tiny_root, monkeypatch, fault, number):
    fault(monkeypatch)
    res = _run(tiny_root, monkeypatch)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quilt2_run(tmp_path_factory):
    """The QUILT2 path (msPBWT, rare/common) on a tiny world with rare
    sites, timed, and its operator's report."""
    rng = np.random.default_rng(9)
    K, nSNPs = 80, 256
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=40_000)
    haps[:, 3::4] = 0
    haps[rng.integers(0, K, 64), 3 + 4 * np.arange(64)] = 1         # 64 singletons
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, use_mspbwt=True,
                         impute_rare_common=True, rare_af_threshold=0.02)
    samples = []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, prep.grid_all, coverage=1.0,
                                     read_length_bp=300, phred=25)
        samples.append(r)
    cfg = ImputeConfig(nGibbsSamples=2, n_seek_its=1, Ksubset=16, Knew=16,
                       small_ref_panel_gibbs_iterations=3, use_mspbwt=True,
                       impute_rare_common=True, rare_af_threshold=0.02,
                       small_ref_panel_block_gibbs_iterations=[2], seed=5, sample_batch=4,
                       print_extra_timing_information=True, verbose=True)
    out_dir = tmp_path_factory.mktemp("quilt2_spans")
    import io
    from contextlib import redirect_stderr
    err = io.StringIO()
    with redirect_stderr(err):
        out = quilt_impute(prep, samples, ["A", "B"], cfg, "cpu",
                           output_filename=str(out_dir / "q2.vcf.gz"))
    return prep, out, err.getvalue()


SPANS = {"select.symbols", "select.scan", "select.rank", "rare.init_labels", "rare.fwd",
         "rare.bwd", "rare.read_lem", "rare:dosage_kernel", "context.all_snp_panel"}
COUNTERS = {"select.matches", "select.fill", "rare.sites", "rare.carriers", "rare.retries"}


def test_quilt2_spans_and_counters_are_in_timing_and_the_report(quilt2_run):
    prep, out, report = quilt2_run
    t = out.timing
    assert SPANS - {"context.all_snp_panel"} <= set(t)
    assert "rare.retries" not in t or t["rare.retries"]["count"] >= 1
    for name in COUNTERS - {"rare.retries"}:
        assert name in t and t[name]["seconds"] == 0.0, name
    assert t["rare.sites"]["count"] == int((~prep.snp_is_common).sum()) >= 64
    assert t["rare.carriers"]["count"] == sum(len(x) for x in prep.rare_per_hap_info) >= 64
    assert t["select.matches"]["count"] >= 0 and t["select.fill"]["count"] >= 0
    for v in t.values():
        assert "seconds" in v and v["seconds"] >= 0
    assert "Counters:" in report and "rare.sites" in report and "select.scan" in report
    # the all-SNP call's sweeps are its own spans, not the seek calls'
    assert t["rare.fwd"]["calls"] == 2 * 4          # two all-SNP calls of 4 sweeps
    assert t["sweep.fwd"]["calls"] == 2 * 1 * 4     # seek + phasing calls of 4 sweeps


def test_the_context_build_is_a_span_of_the_call_that_builds_it():
    t = SectionTimers(True)
    rng = np.random.default_rng(1)
    K, nSNPs = 30, 128
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs, region_span=20_000)
    haps[:, 3::4] = 0
    haps[0, 3::4] = 1
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps,
                         impute_rare_common=True, rare_af_threshold=0.05)
    from quilt_tpu_torch.engine.context import RegionContext
    cfg = ImputeConfig(impute_rare_common=True, rare_af_threshold=0.05,
                       print_extra_timing_information=True)
    ctx = RegionContext.build(prep, cfg, "cpu", timers=t)
    assert ctx.timers is t and "context.all_snp_panel" in t.as_dict()
    assert ctx.rare_sites == int((~prep.snp_is_common).sum()) >= 32
    assert ctx.rare_carriers == sum(len(x) for x in prep.rare_per_hap_info) >= 32
    np.testing.assert_array_equal(
        ctx.tensors["rhb_all"].numpy(),
        all_snp_panel(prep.rhb_t, prep.snp_is_common, prep.rare_per_hap_info, ctx.nGrids_all))


def test_the_quilt1_path_keeps_its_span_names():
    rng = np.random.default_rng(11)
    K, nSNPs = 40, 192
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64)
    samples = []
    for _ in range(2):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        r, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=0.5,
                                     read_length_bp=400, phred=25)
        samples.append(r)
    cfg = ImputeConfig(nGibbsSamples=2, n_seek_its=1, Ksubset=32, Knew=32,
                       small_ref_panel_gibbs_iterations=3,
                       small_ref_panel_block_gibbs_iterations=[2], seed=5, sample_batch=4,
                       print_extra_timing_information=True, verbose=False)
    out = quilt_impute(prep, samples, ["A", "B"], cfg, "cpu")
    names = set(out.timing)
    assert {"sweep.fwd", "sweep.bwd", "sweep.lem_pad", "sweep.init", "sweep.slots",
            "sweep.per_it", "sweep.out", "gibbs:sweep_kernel"} <= names
    assert not {n for n in names if n.startswith(("rare", "select", "context."))}
    assert not {n for n in names if "count" in out.timing[n]}
