"""Fixtures of the benchmark's tests: the repository on the path, few
threads, and a copy of the benchmark with a tiny cell that the CPU runs
in seconds (the port's plain kernel versions)."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)

TINY = "tiny.tiny"


def make_tiny_root(dst: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under dst, with the port
    beside it, and a cell TINY: the quilt1_1kg configuration at K = 200,
    512 SNPs, Ksubset 64, 3 chains, 7 sweeps; 3 samples a batch at ~1x."""
    root = dst / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "quilt_tpu_torch").symlink_to(ROOT / "quilt_tpu_torch")
    cfg = json.loads((root / "benchmark/configs/quilt1_1kg.json").read_text())
    cfg.update(name="tiny", K=200, nSNPs=512)
    cfg["impute"].update(Ksubset=64, Knew=64, nGibbsSamples=3,
                         small_ref_panel_gibbs_iterations=6,
                         small_ref_panel_block_gibbs_iterations=[3])
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((root / "benchmark/traffic/cov1x.b8.json").read_text())
    tr.update(name="tiny", sample_batch=3, pool_batches=2)
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(tr))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": TINY, "config": "tiny", "traffic": "tiny", "chips": 1,
                             "why": "test"})
    for m in man["per_layer"] + man["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
