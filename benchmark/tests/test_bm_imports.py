"""The import boundaries: nothing the benchmark runs loads jax, jaxlib,
flax or quilt_tpu (compared by whole top-level name: quilt_tpu_torch is
the port), and the reference imports nothing of the port."""
import ast
import subprocess
import sys
from pathlib import Path

from benchmark.harness import forbidden_modules

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "quilt_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for p in BENCH.rglob("*.py"):
        if "tests" in p.parts:
            continue
        assert not (set(_imports(p)) & FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_port():
    for p in (BENCH / "reference").rglob("*.py"):
        assert "quilt_tpu_torch" not in set(_imports(p)), p
    for p in ("world.py", "work.py", "rates.py", "check.py", "methods/quilt1.py"):
        assert "quilt_tpu_torch" not in set(_imports(BENCH / p)), p


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["quilt_tpu_torch", "quilt_tpu_torch.engine", "numpy"]) == []
    assert forbidden_modules(["quilt_tpu.engine", "jaxlib.xla_client", "jaxy"]) \
        == ["jaxlib", "quilt_tpu"]


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A tiny cell's whole run in a fresh process, with jax and quilt_tpu
    made unimportable: it must not try to load them, and none is loaded."""
    code = f"""
import sys, importlib.abc
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {sorted(FORBIDDEN)!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {str(BENCH / 'tests')!r}); sys.path.insert(0, {str(BENCH.parent)!r})
import torch; torch.set_num_threads(2)
from pathlib import Path
from conftest import make_tiny_root, TINY
from benchmark.harness import run_cell, forbidden_modules
root = make_tiny_root(Path({str(tmp_path)!r}))
res = run_cell(root, TINY, 5, 0.0, False, device="cpu")
assert res is not None and res["correct"], res
assert forbidden_modules() == [], forbidden_modules()
print("clean")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]
