"""The engine's section timers as the program's tracer (utils/log.py:
SectionTimers), on the CPU: spans that nest and keep their self time, a
profiler range for each span when timing is on and none when it is off,
every span of the driver, the batched engine, the Gibbs call and the VCF
write reached on a tiny batch, and dosages that timing leaves unchanged."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import quilt_tpu_torch.engine.batch as batch_mod
from quilt_tpu_torch.config import ImputeConfig
from quilt_tpu_torch.engine.driver import quilt_impute
from quilt_tpu_torch.io.simulate import (
    simulate_panel, simulate_sample_reads, simulate_truth_mosaic,
)
from quilt_tpu_torch.panel.prepare import prepare_panel
from quilt_tpu_torch.utils.log import SectionTimers

torch.set_num_threads(2)

# the spans and entries the tracer adds to the sections the engine had
NEW = {
    "impute", "impute.self", "driver.plan", "driver.stats",
    "engine.group", "engine.prologue", "engine.phasing", "engine.results",
    "engine.sort_reads", "engine.draws", "engine.read_rows", "engine.read_cache",
    "inputs.gibbs_inputs", "inputs.padded_reads", "inputs.slot_layout",
    "sweep.lem_pad", "sweep.init", "sweep.slots", "sweep.fwd", "sweep.bwd", "sweep.block",
    "sweep.per_it", "sweep.out", "sweep.read_lem",
    "vcf.hwe", "vcf.format", "vcf.deflate", "vcf.tabix",
}
# the sections the engine had, which the benchmark's metrics sum by name
OLD = {
    "inputs_build", "emat:full_build", "gibbs:bits_gather", "gibbs:rng", "gibbs:lem_subset",
    "gibbs:sweep_kernel", "fb:gl_build", "fb:kernel", "fb:select", "accumulate",
    "final_fetch", "consensus", "vcf:columns", "vcf:write",
}
RESERVED = {"inputs_build", "vcf:columns", "vcf:write", "consensus", "final_fetch",
            "emat:full_build", "gibbs:lem_subset"}
# the spans each path of the batched engine reaches on the tiny batch
READ_LEM = {"sweep.read_lem"}
CACHE = {"emat:full_build", "gibbs:lem_subset"}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(11)
    K, nSNPs, N = 40, 192, 2
    haps, pos = simulate_panel(rng, K=K, nSNPs=nSNPs)
    prep = prepare_panel(chrom="chr20", pos=pos, ref_allele=np.array(["A"] * nSNPs),
                         alt_allele=np.array(["G"] * nSNPs), haps=haps, nMaxDH=64)
    samples = []
    for _ in range(N):
        truth = simulate_truth_mosaic(rng, haps, n_latent=2)
        reads, _ = simulate_sample_reads(rng, truth, pos, prep.grid, coverage=0.5,
                                         read_length_bp=400, phred=25)
        samples.append(reads)
    return prep, samples


def _impute(world, tmp_path, timing):
    prep, samples = world
    cfg = ImputeConfig(nGibbsSamples=2, n_seek_its=1, Ksubset=32, Knew=32,
                       small_ref_panel_gibbs_iterations=3,
                       small_ref_panel_block_gibbs_iterations=[2], seed=5, sample_batch=4,
                       print_extra_timing_information=timing, verbose=False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = quilt_impute(prep, samples, [f"S{i}" for i in range(len(samples))], cfg, "cpu",
                           output_filename=str(tmp_path / f"timing{int(timing)}.vcf.gz"))
    # the raw events' names: prof.events() builds an object an event, slowly
    return out, {e.name() for e in prof.profiler.kineto_results.events()}


@pytest.fixture(scope="module", params=["cache", "read_lem"])
def runs(request, world, tmp_path_factory):
    """{timing: (output, profiler range names)} of the tiny batch, on the
    whole-panel emission cache's path or (budget 0) on the path that builds
    each call's read emissions inside the Gibbs section."""
    tmp = tmp_path_factory.mktemp(request.param)
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "read_lem":
            mp.setattr(batch_mod, "_CPU_LEM_BUDGET", 0)
        got = {t: _impute(world, tmp, t) for t in (False, True)}
    return request.param, got


def test_disabled_timers_make_no_range_and_no_timing(runs):
    _, got = runs
    out, names = got[False]
    assert out.timing is None
    assert not names & (NEW | OLD)
    t = SectionTimers(False)
    assert t.section("a") is t.section("b", root=True)
    with t.section("a"):
        pass
    assert t.totals == {} and t._pending == [] and t.as_dict() == {}


def test_every_span_on_the_path_is_reported_and_is_a_profiler_range(runs):
    path, got = runs
    out, names = got[True]
    want = (NEW | OLD) - (CACHE if path == "read_lem" else READ_LEM)
    assert set(out.timing) == want
    assert want - {"impute.self"} <= names
    for v in out.timing.values():
        assert v["calls"] >= 1 and v["seconds"] >= v["self_seconds"] >= 0
        assert "device_seconds" not in v                    # no card


def test_new_spans_stay_out_of_the_benchmarks_section_families():
    for name in NEW:
        assert not name.startswith(("gibbs:", "fb:")) and name not in RESERVED, name


def test_timing_leaves_the_dosages_unchanged(runs):
    _, got = runs
    off, on = got[False][0], got[True][0]
    for a, b in zip(off.results, on.results):
        np.testing.assert_array_equal(a.dosage, b.dosage)
        np.testing.assert_array_equal(a.gp, b.gp)
        np.testing.assert_array_equal(a.phased_haps, b.phased_haps)


def test_impute_self_is_the_roots_self_time(runs):
    _, got = runs
    t = got[True][0].timing
    children = ("driver.plan", "engine.group", "driver.stats", "vcf:write")
    assert t["impute.self"]["seconds"] == t["impute"]["self_seconds"]
    assert t["impute"]["seconds"] == pytest.approx(
        t["impute.self"]["seconds"] + sum(t[c]["seconds"] for c in children), abs=1e-9)
    assert t["vcf:write"]["seconds"] == pytest.approx(
        t["vcf:write"]["self_seconds"]
        + sum(t[c]["seconds"] for c in ("vcf.hwe", "vcf.format", "vcf.tabix")), abs=1e-9)


def test_nested_sections_keep_their_self_time():
    t = SectionTimers(True)
    with t.section("root", root=True):
        with t.section("a"):
            with t.section("a1"):
                sum(range(20_000))
            with t.section("a2"):
                sum(range(20_000))
            sum(range(20_000))
        for _ in range(3):
            with t.section("b"):
                sum(range(10_000))
    d = t.as_dict()
    assert d["b"]["calls"] == 3 and d["root"]["calls"] == 1
    assert d["a"]["seconds"] == pytest.approx(
        d["a"]["self_seconds"] + d["a1"]["seconds"] + d["a2"]["seconds"], abs=1e-12)
    assert d["root"]["seconds"] == pytest.approx(
        d["root"]["self_seconds"] + d["a"]["seconds"] + d["b"]["seconds"], abs=1e-12)
    assert d["root.self"] == {"seconds": d["root"]["self_seconds"], "calls": 1,
                              "self_seconds": d["root"]["self_seconds"]}
    for leaf in ("a1", "a2", "b"):
        assert d[leaf]["self_seconds"] == d[leaf]["seconds"]
    assert t._open == []
    with t.section("c") as sec:          # no profiler runs: no range to open
        assert sec._range is None and sec._e0 is None


def test_a_section_closed_by_an_exception_leaves_the_stack_whole():
    t = SectionTimers(True)
    with pytest.raises(ValueError):
        with t.section("root", root=True):
            with t.section("a"):
                raise ValueError("stop")
    assert t._open == [] and set(t.as_dict()) == {"root", "a", "root.self"}
