"""The port's benchmark programs (quilt_tpu_torch/bench) on the CPU, at
small sizes: their world builders and run functions complete with finite
outputs; the K-split FB at the split fb_plan takes for a 98,304-haplotype
panel matches the float64 oracle; every report and the command line refuse
a CPU device (no CPU number goes out under a device metric's name); and the
reports carry the keys of the JAX side's programs (BENCH_FULL.json,
BENCH_GIBBS.json, bench.py's JSON line) plus the named additions.

Tolerances: the K-split FB against the oracle as tests/test_torch_fb_tiled.py
holds it (dosage atol 1e-4, log-likelihood 1e-2)."""
import ast
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from quilt_tpu.oracle import haploid_dosage_versus_refs
from quilt_tpu.panel import compress_panel as jax_compress_panel

from quilt_tpu_torch.bench import __main__ as cli
from quilt_tpu_torch.bench import common
from quilt_tpu_torch.bench import fb as bfb
from quilt_tpu_torch.bench import full as bfull
from quilt_tpu_torch.bench import gibbs as bgibbs
from quilt_tpu_torch.dist.mesh import ShardedFB, make_mesh
from quilt_tpu_torch.engine.context import RegionContext
from quilt_tpu_torch.inputs import FBInputs
from quilt_tpu_torch.io.simulate import simulate_truth_mosaic
from quilt_tpu_torch.kernels import fb as fbk
from quilt_tpu_torch.panel.mspbwt import build_mspbwt_indices
from quilt_tpu_torch.panel.prepare import trans_rates
from quilt_tpu_torch.utils import unpack_bits_32

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS = 0.001
# small shapes of every section (a tenth of a second to a few seconds each)
TINY = bfull.Sizes(fb_K=256, fb_nSNPs=32 * 32, fb_rows=4, K=128, nSNPs=32 * 4, ksubset=16,
                   tiled_Ks=(512,), tiled_grids=16, tiled_rows=2, K_big=256, n_big=2,
                   hla_alleles=8, hla_K=40)
# what the port's reports add to the JAX programs' keys
ADDED_TOP = {"device_count", "nvidia_smi", "power_limit_w", "n_samples", "section_seconds"}
ADDED = {
    "fb_kernel": {"plan"},
    "sharded_fb_body": {"n_panel", "note"},
    "end_to_end": {"r2_min", "r2_mean", "peak_device_bytes"},
    "end_to_end_quilt2": {"r2_min", "r2_mean", "peak_device_bytes"},
    "end_to_end_nipt": {"r2_maternal_min", "r2_maternal_mean", "r2_fetal_min", "r2_fetal_mean",
                        "peak_device_bytes"},
    "end_to_end_ont": {"r2_min", "r2_mean", "peak_device_bytes"},
    "end_to_end_K100k": {"r2_min", "r2_mean", "peak_device_bytes", "fb_plan"},
    "end_to_end_K100k_quilt2": {"r2_min", "r2_mean", "peak_device_bytes", "mspbwt_rank"},
    "gibbs_sweep": {"backend"},
}


@pytest.fixture
def on_cpu(monkeypatch):
    """Lets the report functions run on the CPU, for their keys only: the
    CUDA guard, the card's report and the device synchronisations and
    memory statistics are stubbed in this test."""
    cpu = torch.device("cpu")
    for mod in (common, bfb, bgibbs, bfull):
        if hasattr(mod, "require_cuda"):
            monkeypatch.setattr(mod, "require_cuda", lambda device="cuda": cpu)
        if hasattr(mod, "device_report"):
            monkeypatch.setattr(mod, "device_report", lambda device="cuda": {
                "device": "cpu", "device_count": 0, "nvidia_smi": "", "power_limit_w": None})
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    return cpu


@pytest.fixture(scope="module")
def e2e():
    rng = np.random.default_rng(3)
    world = bfull.e2e_world(rng, 2, K=160, nSNPs=32 * 8)
    return rng, world


def _finite(*arrays):
    return all(np.isfinite(np.asarray(a, dtype=np.float64)).all() for a in arrays)


# -- fb_plan and the plain K-split FB at K = 98,304 --------------------------

def _fb_at(K, nGrids):
    """FBInputs of K haplotypes over nGrids grids (sizes only: fb_plan reads
    K_pad and the grids)."""
    return FBInputs(words=np.zeros((nGrids, 1), np.int32), trans=None, thin_flag=None, K=K,
                    K_pad=K, nGrids=nGrids, S=nGrids * 32, nSNPs=nGrids * 32)


@pytest.mark.parametrize("rows", [1, 2, 16, 28, 56, 112, 200])
def test_fb_plan_at_98304_takes_a_split_the_kernels_accept(rows):
    family, per_call, splits = fbk.fb_plan(rows, _fb_at(98304, 512))
    assert family == "tiled" and 1 <= per_call <= rows
    assert fbk._splits(98304, 98304 // splits) == splits


@pytest.mark.parametrize("rows, plan", [(16, ("tiled", 16, 16)), (112, ("tiled", 42, 8))])
def test_fb_plan_at_98304_takes_the_fastest_timed_split(rows, plan):
    """chip_smoke.py's "fb_plan timing" at 16 and 112 rows x 98,304 x 512
    grids (PERF.md): 16 blocks a row the fastest at 16 rows, 8 in the staged
    form at 112, whose checkpoints every 2 grids take three calls (42 + 42
    + 28 rows)."""
    assert fbk.fb_plan(rows, _fb_at(98304, 512)) == plan


@pytest.mark.parametrize("rows, plan", [(16, ("tiled", 16, 16)), (112, ("tiled", 21, 16))])
def test_fb_plan_at_194512_takes_the_fastest_timed_split(rows, plan):
    """The same at the TOPMed-sized panel (K = 194,512, K_pad 194,560): 16
    blocks a row in the staged form the fastest at both, 21 rows a call."""
    fb = FBInputs(words=np.zeros((512, 1), np.int32), trans=None, thin_flag=None, K=194512,
                  K_pad=194560, nGrids=512, S=512 * 32, nSNPs=512 * 32)
    assert fbk.fb_plan(rows, fb) == plan


@pytest.fixture(scope="module")
def panel_98304():
    """A 98,304-haplotype packed panel over 8 grids (few mutations, so the
    oracle's escape loop stays short), its FB inputs and 2 rows of GLs."""
    rng = np.random.default_rng(11)
    K, nGrids = 98304, 8
    rhb = common.fast_packed_panel(rng, K, nGrids, mutation_per_bit=1e-5)
    nSNPs = nGrids * 32
    panel = jax_compress_panel(rhb, nSNPs, ref_error=EPS, nMaxDH=255)
    trans = trans_rates(np.full(nGrids - 1, 0.99))
    fb = FBInputs.build(panel, trans, thinned_grids=np.arange(0, nGrids, 3))
    gl = np.ones((2, 2, fb.S), dtype=np.float32)
    gl[:, :, :nSNPs] = rng.uniform(0.05, 1.0, (2, 2, nSNPs))
    return panel, trans, fb, gl


@pytest.mark.parametrize("rows", [16, None])
def test_plain_k_split_fb_at_98304_matches_the_oracle(panel_98304, rows):
    """The plain K-split FB at the k_tile fb_plan takes for `rows` rows of a
    98,304-haplotype, 512-grid FB (8 blocks a row), and at 2 blocks a row
    (49,152 haplotypes a block, its chunk alphas in global planes)."""
    panel, trans, fb, gl = panel_98304
    splits = 2 if rows is None else fbk.fb_plan(rows, _fb_at(98304, 512))[2]
    dev = fb.device_tensors("cpu")
    d, ll, _, _ = (x.numpy() for x in fbk.fb_tiled_core(
        torch.from_numpy(gl), dev["words"], dev["trans2"], dev["thin_flag"], fb.K, 8, EPS,
        k_tile=fb.K_pad // splits))
    for row in range(2):
        orc = haploid_dosage_versus_refs(gl[row, :, :panel.nSNPs].astype(np.float64), panel,
                                         trans, ref_error=EPS)
        np.testing.assert_allclose(d[row, :panel.nSNPs], orc.dosage, atol=1e-4)
        assert abs(float(ll[row]) - orc.log_like) < 1e-2


# -- world builders and run functions on the CPU ----------------------------

def test_packed_truth_is_simulate_truth_mosaic():
    rhb = common.fast_packed_panel(np.random.default_rng(3), 50, 4)
    got = common.packed_truth_mosaic(np.random.default_rng(4), rhb, 120, n_latent=3)
    want = simulate_truth_mosaic(np.random.default_rng(4), unpack_bits_32(rhb, 120), 3)
    np.testing.assert_array_equal(got, want)


def test_fb_world_and_run():
    world = bfb.fb_world(np.random.default_rng(0), K=256, nSNPs=32 * 32, rows=3)
    assert world["fb"].K == 256 and world["gl"].shape == (3, 2, 32 * 32)
    out = bfb.run_fb(world, torch.from_numpy(world["gl"]))
    bfb.check_dosage(out[0][:, :world["nSNPs"]].numpy())
    assert _finite(out[0], out[1]) and bfb.plan_of(world, 3)["family"] in ("fused", "tiled")


@pytest.mark.parametrize("splits", [1, 4])
def test_tiled_world_and_run(splits):
    world = bfull.tiled_world(np.random.default_rng(1), 512, nGrids=16, rows=2)
    out = bfb.run_fb(world, torch.from_numpy(world["gl"]),
                     **({"family": "fused"} if splits == 1 else {"splits": splits}))
    bfb.check_dosage(out[0].numpy())
    assert _finite(out[0], out[1])


def test_sharded_fb_runs_on_a_mesh_of_cpus():
    world = bfb.fb_world(np.random.default_rng(2), K=256, nSNPs=32 * 32, rows=3)
    sharded = ShardedFB(world["fb"], make_mesh(1, 2, ["cpu"] * 2), K_top=bfb.K_TOP)
    out = sharded(torch.from_numpy(world["gl"]))
    ref = bfb.run_fb(world, torch.from_numpy(world["gl"]), family="fused")
    np.testing.assert_allclose(out[0].numpy(), ref[0][:, :world["nSNPs"]].numpy(), atol=1e-5)
    assert sharded.exchanges > 0


def test_gibbs_world_run_and_chain_independence():
    """Chains 0-2 of a 5-chain call given the same inputs as a 3-chain call
    give the same labels and per-iteration terms (the plain sweeps)."""
    rng = np.random.default_rng(4)
    world = bgibbs.gibbs_world(rng, "cpu", K=128, nSNPs=32 * 16, Ksub=40)
    state = bgibbs.gibbs_state(world, 5, 3, rng)
    wide = bgibbs.run_gibbs(world, state)
    narrow = bgibbs.run_gibbs(world, bgibbs.first_chains(world, state, 3))
    assert torch.equal(wide.H[:3], narrow.H)
    assert torch.equal(wide.per_it[:, :3], narrow.per_it)
    assert _finite(wide.per_it) and bgibbs.form_name(world["Kp"]).startswith("register")


@pytest.mark.parametrize("kind", ["diploid", "quilt2", "nipt", "ont"])
def test_e2e_worlds_and_run(e2e, kind):
    rng, world = e2e
    cfg = bfull.e2e_config(2, 24)
    if kind == "nipt":
        world = bfull.e2e_world(rng, 2, rhb=world["rhb"], prep=world["prep"], ff=0.2)
        cfg = dataclasses.replace(cfg, method="nipt")
    elif kind == "ont":
        world = bfull.e2e_world(rng, 2, rhb=world["rhb"], prep=world["prep"],
                                read_length_bp=bfull.ONT_READ_BP, phred=bfull.ONT_PHRED)
        assert np.mean([np.diff(r.offsets).mean() for r in world["samples"]]) > 50
    if kind == "quilt2":
        world["prep"].ms_indices = build_mspbwt_indices(world["prep"].panel.hapMatcher)
        cfg = dataclasses.replace(cfg, use_mspbwt=True)
    try:
        out = bfull.run_impute(world, cfg, "cpu")
    finally:
        world["prep"].ms_indices = None
    r2 = bfull.r2_report(world, out)
    assert all(np.isfinite(v) for v in r2.values()), r2
    assert all(_finite(r.dosage, r.gp) for r in out.results)


def test_k100k_world_builder_at_a_small_k():
    world = bfull.e2e_world(np.random.default_rng(5), 2, K=384, nSNPs=32 * 8)
    prep = world["prep"]
    assert prep.K == 384 and len(world["truths"]) == 2
    np.testing.assert_allclose(prep.af, unpack_bits_32(world["rhb"], prep.nSNPs).mean(0))
    plan = bfull.fb_plan_of(prep, bfull.e2e_config(2, 24), "cpu", 28)
    assert plan["family"] in ("fused", "tiled") and plan["rows_per_call"] >= 1


def test_hla_world_and_run():
    world = bfull.hla_world(np.random.default_rng(6), n_alleles=8, K=40, n_gene_reads=40)
    ctx = RegionContext.build(world["prep"], world["cfg"], "cpu")
    typed = bfull.run_hla(world, ctx, "cpu")
    assert {typed.bestallele1, typed.bestallele2} <= set(world["db"].allele_names)


# -- no CPU number under a device metric's name -----------------------------

def _refusals(e2e):
    rng, world = e2e
    fbw = bfb.fb_world(np.random.default_rng(0), K=256, nSNPs=32 * 32, rows=2)
    return {
        "require_cuda": lambda: common.require_cuda("cpu"),
        "device_report": lambda: common.device_report("cpu"),
        "timed": lambda: common.timed(lambda: None, "cpu"),
        "peak_device_bytes": lambda: common.peak_device_bytes(lambda: None, "cpu"),
        "fb.time_fb": lambda: bfb.time_fb(fbw, "cpu"),
        "fb.fb_report": lambda: bfb.fb_report(fbw, "cpu"),
        "fb.main": lambda: bfb.main("cpu"),
        "gibbs.time_call": lambda: bgibbs.time_call({}, 7, 21, rng, "cpu"),
        "gibbs.gibbs_report": lambda: bgibbs.gibbs_report({}, rng, "cpu"),
        "gibbs.main": lambda: bgibbs.main("cpu"),
        "full.full_report": lambda: bfull.full_report("cpu"),
        "full.timed_impute": lambda: bfull.timed_impute(world, bfull.e2e_config(2), "cpu"),
        "full.end_to_end": lambda: bfull.end_to_end(world, "cpu"),
        "full.hla_typing": lambda: bfull.hla_typing({}, "cpu"),
        "full.sharded_fb_body": lambda: bfull.sharded_fb_body(fbw, "cpu"),
        "full.gibbs_sweep": lambda: bfull.gibbs_sweep({}, "cpu", rng),
    }


REFUSING = ["require_cuda", "device_report", "timed", "peak_device_bytes", "fb.time_fb",
            "fb.fb_report", "fb.main", "gibbs.time_call", "gibbs.gibbs_report", "gibbs.main",
            "full.full_report", "full.timed_impute", "full.end_to_end", "full.hla_typing",
            "full.sharded_fb_body", "full.gibbs_sweep"]


@pytest.mark.parametrize("name", REFUSING)
def test_reports_refuse_a_cpu_device(e2e, name):
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        _refusals(e2e)[name]()


@pytest.mark.parametrize("program", ["fb", "gibbs", "full"])
def test_command_line_refuses_without_a_card(program, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([program, "--out", str(tmp_path)]) != 0
    assert not list(tmp_path.iterdir())
    captured = capsys.readouterr()
    assert "needs a CUDA device" in captured.err and not captured.out


# -- the report keys --------------------------------------------------------

def _bench_py_line_keys():
    """The keys of the dict bench.py's main prints with json.dumps."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps({...}) in bench.py")


def test_fb_line_keys_are_bench_py_s(on_cpu):
    world = bfb.fb_world(np.random.default_rng(0), K=256, nSNPs=32 * 32, rows=3)
    line = bfb.fb_report(world, on_cpu, reps=1)
    assert set(line) == _bench_py_line_keys() | {"device", "power_limit_w"}
    assert line["metric"] == "hmm_cell_updates_per_s_per_chip" and line["unit"] == "cells/s"


def test_gibbs_report_keys_are_bench_gibbs_json_s(on_cpu):
    ref = json.loads((ROOT / "BENCH_GIBBS.json").read_text())
    rng = np.random.default_rng(7)
    world = bgibbs.gibbs_world(rng, on_cpu, K=128, nSNPs=32 * 8, Ksub=24)
    got = bgibbs.gibbs_report(world, rng, on_cpu, chains=(7, 9), reps=1)
    assert set(got) == set(ref) | ADDED_TOP - {"n_samples", "section_seconds"}
    row_keys = set(next(iter(ref["batch_scaling_21_sweeps"].values())))
    assert all(set(r) == row_keys for r in got["batch_scaling_21_sweeps"].values())
    assert set(got["c7_split"]) == set(ref["c7_split"])


def test_full_report_keys_are_bench_full_json_s(on_cpu, monkeypatch):
    ref = json.loads((ROOT / "BENCH_FULL.json").read_text())
    monkeypatch.setattr(bfull, "SIZES", TINY)
    got = bfull.full_report(on_cpu, 2)
    assert set(got) == set(ref) | ADDED_TOP
    assert got["backend"] == "cuda" and got["sharded_fb_body"]["pergrid"] is None
    for name, section in ref.items():
        if not isinstance(section, dict):
            continue
        if name == "fb_kernel_tiled":
            assert set(got[name]) == {f"K{K}" for K in TINY.tiled_Ks}
            for r in got[name].values():
                assert set(r) == set(ref[name]["K98304"]) | {"plan"}
            continue
        keys = set(section) - ({"pergrid", "segmented"} if name == "sharded_fb_body" else set())
        assert set(got[name]) - {"pergrid", "segmented"} == keys | ADDED.get(name, set()), name
    assert set(got["sharded_fb_body"]["segmented"]) == set(ref["sharded_fb_body"]["segmented"])
    assert set(got["end_to_end"]["stage_breakdown_s"]) >= {"gibbs:sweep_kernel", "fb:kernel"}
    assert got["hla_typing"]["call_correct"] in (True, False)
