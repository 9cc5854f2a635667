"""BENCHMARK.json against the benchmark's contract: keys, names and units
in the allowed characters, every cell's files present, one chip a cell,
and each per-layer metric's module agreeing with its entry."""
import json
import re
from pathlib import Path

import pytest

from benchmark.manifest import Manifest, listed

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return Manifest(ROOT)


def test_top_level_keys_and_limits(man):
    d = man.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["command"] == ["python3", "benchmark/run.py"]
    assert d["paths"] == ["benchmark"] and all(PATH.match(p) for p in d["paths"])
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert 1 <= len(d["configs"]) <= 24 and 1 <= len(d["workloads"]) <= 24
    assert 1 <= len(d["end_to_end"]) <= 16 and 1 <= len(d["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys(man):
    d = man.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (ROOT / c["file"]).is_file()
        for k in ("why", "source"):
            assert 1 <= len(c[k]) <= 200 and "\n" not in c[k] and "\t" not in c[k]
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in d["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in d["end_to_end"]}
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert len(names) == len(set(names))


def test_every_cell_has_its_files_and_one_chip(man):
    have = listed(man.bench_dir)
    pairs = set()
    for w in man.data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in have["configs"] and w["traffic"] in have["traffic"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert man.per_layer(w["name"]) and len(man.end_to_end(w["name"])) >= 2
        assert man.config(w["config"])["limits"]


def test_each_metric_module_matches_its_entry(man):
    for m in man.data["per_layer"]:
        mod = man.metric_module(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert callable(mod.read)


def test_reduced_lists_no_width(man):
    for c in man.data["configs"]:
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|hidden|width|K$|Ksubset)", k), k
        cfg = man.config(c["name"])
        assert set(c["reduced"]) == set(cfg["reduced"])
