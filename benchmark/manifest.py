"""BENCHMARK.json and the files it names, found by name: a configuration
is `configs/<name>.json`, whose `method` names its method module
`methods/<method>.py`, a traffic mix `traffic/<name>.json`, a per-layer
metric `metrics/<name>.py` (a module with LAYER, UNIT, MOVES and
read(records)). A later change adds a configuration, a mix, a metric or a
cell as new files and entries; nothing here names one."""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as fh:
            self.data = json.load(fh)

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        with open(self.bench_dir / "configs" / f"{name}.json") as fh:
            return json.load(fh)

    def traffic(self, name: str) -> Dict:
        with open(self.bench_dir / "traffic" / f"{name}.json") as fh:
            return json.load(fh)

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[Dict]:
        return [m for m in self.data["per_layer"] if cell in m.get("workloads", [cell])]

    def method(self, config: Dict) -> ModuleType:
        """The method module of a configuration (`methods/<method>.py`),
        loaded from its file as a module of the package benchmark.methods."""
        name = config["method"]
        path = self.bench_dir / "methods" / f"{name}.py"
        full = f"benchmark.methods.{name}"
        mod = sys.modules.get(full)
        if mod is None or Path(mod.__file__).resolve() != path.resolve():
            importlib.import_module("benchmark.methods")
            spec = importlib.util.spec_from_file_location(full, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[full] = mod
            spec.loader.exec_module(mod)
        return mod

    def metric_module(self, name: str) -> ModuleType:
        return load_metric(self.bench_dir / "metrics" / f"{name}.py")


def load_metric(path: Path) -> ModuleType:
    """A per-layer metric's module, loaded from its file (the name may hold
    dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def listed(bench_dir: Path) -> Dict[str, List[str]]:
    """The configurations, traffic mixes, per-layer metrics and methods the
    folder holds, by name."""
    bench_dir = Path(bench_dir)
    return {"configs": sorted(p.stem for p in (bench_dir / "configs").glob("*.json")),
            "traffic": sorted(p.stem for p in (bench_dir / "traffic").glob("*.json")),
            "metrics": sorted(p.stem for p in (bench_dir / "metrics").glob("*.py")
                              if not p.name.startswith("_")),
            "methods": sorted(p.stem for p in (bench_dir / "methods").glob("*.py")
                              if not p.name.startswith("_"))}
