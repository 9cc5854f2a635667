"""A configuration, a traffic mix, a per-layer metric and a method are
added as new files, and a cell as a new entry, with no edit to any file the
benchmark has: the harness lists them and runs the cell, and the metric's
reader reports in its traced run."""
import json

from benchmark.harness import run_cell
from benchmark.manifest import Manifest, listed



def test_new_files_are_found_by_name(tiny_root):
    bench = tiny_root / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs/tiny.json").read_text())
    cfg["K"] = 150
    cfg["method"] = "dummy_method"
    (bench / "configs/dummy_cfg.json").write_text(json.dumps(cfg))
    (bench / "methods/dummy_method.py").write_text(
        "from benchmark.methods.quilt1 import *  # noqa: F401,F403\n"
        "from benchmark.methods import quilt1\n\n\n"
        "def summary(cmp, state):\n    return 'dummy method: ' + quilt1.summary(cmp, state)\n")
    tr = json.loads((bench / "traffic/tiny.json").read_text())
    tr["coverage"] = 0.5
    (bench / "traffic/dummy_mix.json").write_text(json.dumps(tr))
    (bench / "metrics/dummy_batches.py").write_text(
        'LAYER = "driver and batched engine, host side"\nUNIT = "batches"\n'
        'MOVES = "samples_per_s"\n\n\ndef read(records):\n    return records["batches"]\n')
    man = json.loads((tiny_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                             "traffic": "dummy_mix", "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "dummy_batches", "unit": "batches", "better": "higher",
                             "source": "host_clock",
                             "layer": "driver and batched engine, host side",
                             "moves": "samples_per_s"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, b in before.items():
        assert p.read_bytes() == b                      # nothing edited
    have = listed(bench)
    assert "dummy_cfg" in have["configs"] and "dummy_mix" in have["traffic"]
    assert "dummy_batches" in have["metrics"] and "dummy_method" in have["methods"]
    m = Manifest(tiny_root)
    assert m.config("dummy_cfg")["K"] == 150 and m.traffic("dummy_mix")["coverage"] == 0.5
    assert m.method(m.config("dummy_cfg")).summary.__module__.endswith("dummy_method")
    res = run_cell(tiny_root, "dummy_cfg.dummy_mix", 77, 0.0, True, device="cpu")
    assert res["metrics"]["dummy_batches"]["value"] >= 1
    assert res["correct"], res["checks"]
