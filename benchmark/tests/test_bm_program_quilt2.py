"""The program's set-up (program.py) under QUILT1 and QUILT2, on the CPU at
a tiny size: a QUILT1 configuration gets the region set-up and reads of
the plain packed-panel call; a configuration whose `impute` block asks for
QUILT2 gets the msPBWT indices, the rare/common split of the packed panel
equal to the port's own split of the unpacked panel, all-SNP reads, and a
batch that runs QUILT2."""
import dataclasses
import json

import numpy as np
import pytest

from benchmark import program
from benchmark.world import make_world
from quilt_tpu_torch.io.reads import SampleReads
from quilt_tpu_torch.panel.prepare import prepare_panel

from conftest import ROOT

THRESHOLD = 0.01            # 0-1 carriers of 200 haplotypes are rare, 2 are common
RARE_SNPS = (3, 40, 41, 97, 200, 333, 511)


def _config(name, **impute):
    cfg = json.loads((ROOT / "benchmark/configs" / f"{name}.json").read_text())
    cfg.update(K=200, nSNPs=512)
    cfg["impute"].update(Ksubset=64, Knew=64, nGibbsSamples=3,
                         small_ref_panel_gibbs_iterations=6,
                         small_ref_panel_block_gibbs_iterations=[3], **impute)
    return cfg


def _traffic():
    tr = json.loads((ROOT / "benchmark/traffic/cov1x.b8.json").read_text())
    tr.update(sample_batch=3, pool_batches=1)
    return tr


def _same(a, b):
    """Equal field by field: arrays by value and dtype, dataclasses,
    lists and dicts by their items."""
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and all(_same(getattr(a, f.name), getattr(b, f.name))
                                          for f in dataclasses.fields(a))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


def _same_reads(a: SampleReads, b: SampleReads):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("u", "bq", "offsets", "wif0"))


def _map_args(config):
    return dict(nGen=float(config["nGen"]), expRate=float(config["expRate"]),
                minRate=float(config["minRate"]), maxRate=float(config["maxRate"]),
                ref_error=float(config["ref_error"]))


def _rare_world(seed=5):
    """The tiny quilt2 world with SNPs RARE_SNPS made rare in a copy of its
    panel: the alternate allele on no haplotype, on one, or (SNP 511) on
    all but one."""
    config = _config("quilt1_1kg", use_mspbwt=True, impute_rare_common=True,
                     rare_af_threshold=THRESHOLD)
    world = make_world(seed, config, _traffic())
    bits = np.unpackbits(world.rhb.view(np.uint8), axis=1, bitorder="little")
    for j, s in enumerate(RARE_SNPS):
        bits[:, s] = 0
        bits[j * 17 % 200, s] = j % 2
    bits[:, 511] = 1
    bits[7, 511] = 0
    rhb = np.packbits(bits, axis=1, bitorder="little").view(np.uint32)
    return config, dataclasses.replace(world, rhb=np.ascontiguousarray(rhb))


@pytest.mark.parametrize("name", ["quilt1_1kg", "quilt1_topmed"])
def test_quilt1_set_up_is_the_plain_packed_call(name, monkeypatch):
    config = _config(name)
    world = make_world(2 ** 31 + 11, config, _traffic())
    cfg = program.impute_config(config, _traffic(), 2 ** 31 + 11, timing=False)
    calls = []

    def spy(*a, **kw):
        calls.append((a, kw))
        return prepare_panel(*a, **kw)

    monkeypatch.setattr(program, "prepare_panel", spy)
    prep = program.prepare(world, config, cfg, "cpu")
    (args, kw), = calls
    assert set(kw) == {"presplit", "nGen", "expRate", "minRate", "maxRate", "ref_error"}
    assert set(kw["presplit"]) == {"K", "af_all", "rhb_t"} and kw["presplit"]["rhb_t"] is world.rhb
    nSNPs = len(world.pos)
    parent = prepare_panel(config["chrom"], world.pos, np.array(["A"] * nSNPs),
                           np.array(["G"] * nSNPs),
                           presplit={"K": 200, "af_all": program.panel_af(world.rhb, nSNPs, "cpu"),
                                     "rhb_t": world.rhb},
                           **_map_args(config))
    assert _same(prep, parent)
    assert prep.ms_indices is None and prep.snp_is_common is None and prep.grid_all is None
    reads = program.sample_reads(world, prep)
    assert all(_same_reads(r, SampleReads.from_lists(*w.lists(), prep.grid))
               for r, w in zip(reads, world.reads))


def test_the_presplit_quilt2_reference_equals_the_ports_own_split():
    config, world = _rare_world()
    cfg = program.impute_config(config, _traffic(), 5, timing=False)
    prep = program.prepare(world, config, cfg, "cpu")
    nSNPs = len(world.pos)
    own = prepare_panel(config["chrom"], world.pos, np.array(["A"] * nSNPs),
                        np.array(["G"] * nSNPs), rhb_t=world.rhb, impute_rare_common=True,
                        rare_af_threshold=THRESHOLD, use_mspbwt=True, **_map_args(config))
    assert np.array_equal(np.flatnonzero(~prep.snp_is_common), RARE_SNPS)
    for f in ("snp_is_common", "rhb_t", "af_all", "rare_per_hap_info", "grid_all",
              "L_grid_all", "sigma_all"):
        assert _same(getattr(prep, f), getattr(own, f)), f
    assert len(prep.ms_indices) == len(own.ms_indices) == 4
    for a, b in zip(prep.ms_indices, own.ms_indices):
        assert all(_same(getattr(a, f), getattr(b, f)) for f in ("Y", "C", "A_cp"))


def test_the_split_is_made_in_chunks_of_snps():
    _, world = _rare_world()
    af = program.panel_af(world.rhb, len(world.pos), "cpu")
    whole = program.rare_common_split(world.rhb, af, THRESHOLD, "cpu")
    chunked = program.rare_common_split(world.rhb, af, THRESHOLD, "cpu", chunk_snps=64)
    assert _same(whole, chunked)
    assert whole["rare_flat"].dtype == np.int32 and whole["rare_offsets"].dtype == np.int64
    assert np.diff(whole["rare_offsets"]).tolist() == [0, 1, 0, 1, 0, 1, 199]


def test_a_quilt2_configuration_runs_quilt2_on_all_snp_reads(tmp_path):
    config, world = _rare_world()
    cfg = program.impute_config(config, _traffic(), 5, timing=True)
    prep = program.prepare(world, config, cfg, "cpu")
    reads = program.sample_reads(world, prep)
    assert len(prep.grid_all) == len(world.pos) > len(prep.grid)
    assert all(_same_reads(r, SampleReads.from_lists(*w.lists(), prep.grid_all))
               for r, w in zip(reads, world.reads))
    dos, timing = program.impute(prep, reads, ["s0", "s1", "s2"], cfg, "cpu",
                                 str(tmp_path / "q2.vcf.gz"))
    assert len(dos) == 3
    assert all(d.shape == (len(world.pos),) and np.all(np.isfinite(d)) for d in dos)
    assert "select:mspbwt" in timing and "rare:sweep_kernel" in timing
    assert not any(k.startswith("fb:") for k in timing)


@pytest.mark.parametrize("key,field", [("impute_rare_common", "snp_is_common"),
                                       ("use_mspbwt", "ms_indices")])
def test_a_reference_without_what_quilt2_asks_for_stops_set_up(key, field, monkeypatch):
    config, world = _rare_world()
    cfg = program.impute_config(config, _traffic(), 5, timing=False)
    monkeypatch.setattr(program, "prepare_panel",
                        lambda *a, **kw: dataclasses.replace(prepare_panel(*a, **kw),
                                                             **{field: None}))
    with pytest.raises(ValueError, match=key):
        program.prepare(world, config, cfg, "cpu")
