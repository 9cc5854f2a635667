"""The import boundary of the port: quilt_tpu_torch imports torch, never jax
and nothing of the JAX package (quilt_tpu), not even its jax-free modules:
it keeps its own copies (the machine with the GPU needs neither)."""
import ast
import pathlib
import subprocess
import sys

import torch

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parent.parent / "quilt_tpu_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_every_module_imports_with_jax_blocked():
    """... and with the JAX package blocked as well."""
    mods = list(_modules())
    assert "quilt_tpu_torch.engine.batch" in mods
    assert {"quilt_tpu_torch.kernels.nipt", "quilt_tpu_torch.kernels.nipt_bank",
            "quilt_tpu_torch.engine.sample", "quilt_tpu_torch.hla.typing",
            "quilt_tpu_torch.out.plots", "quilt_tpu_torch.dist",
            "quilt_tpu_torch.dist.ligate", "quilt_tpu_torch.dist.mesh",
            "quilt_tpu_torch.dist.hosts", "quilt_tpu_torch.kernels.fb_sharded",
            "quilt_tpu_torch.bench", "quilt_tpu_torch.bench.common", "quilt_tpu_torch.bench.fb",
            "quilt_tpu_torch.bench.gibbs", "quilt_tpu_torch.bench.full",
            "quilt_tpu_torch.bench.__main__"} <= set(mods)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quilt_tpu'] = None\n"
        "sys.modules['bench'] = None\n"
        "sys.modules['bench_full'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_statements():
    offenders = [f"{p.name}: {n}" for p in sorted(PKG.rglob("*.py"))
                 for n in _imports(p) if n == "jax" or n.startswith("jax.")]
    assert not offenders, offenders


def test_mspbwt_reuse_stops_at_the_host_search():
    """No reuse at all any more: no port module has an `import quilt_tpu` /
    `from quilt_tpu` statement (the msPBWT host index and match scan are
    the port's own copy), and chip_smoke.py's imports load with both jax
    and the JAX package blocked."""
    offenders = [f"{p.relative_to(PKG.parent)}: {n}" for p in sorted(PKG.rglob("*.py"))
                 for n in _imports(p) if n.split(".")[0] == "quilt_tpu"]
    assert not offenders, offenders
    assert (PKG / "panel" / "mspbwt.py").exists() and (PKG / "panel" / "prepare.py").exists()
    smoke = sorted({m for m in _imports(PKG.parent / "chip_smoke.py")})
    assert any(m.startswith("quilt_tpu_torch") for m in smoke)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['quilt_tpu'] = None\n"
        f"for m in {smoke!r}:\n"
        "    importlib.import_module(m)\n"
        "from quilt_tpu_torch.panel.mspbwt import select_new_haps_mspbwt_batch, symbols_device\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_smoke_script_imports_only_the_port():
    """chip_smoke.py imports nothing of jax nor of the JAX package."""
    mods = set(_imports(PKG.parent / "chip_smoke.py"))
    assert not {m for m in mods if m.split(".")[0] in ("jax", "quilt_tpu")}, mods
    assert any(m.startswith("quilt_tpu_torch") for m in mods)


def test_no_import_of_the_jax_side_benchmark_scripts():
    """The port's benchmark programs keep their own copies of what they need
    from the root bench.py / bench_full.py / tools (which drive the JAX
    package): no port module imports them."""
    offenders = [f"{p.relative_to(PKG.parent)}: {n}" for p in sorted(PKG.rglob("*.py"))
                 for n in _imports(p) if n.split(".")[0] in ("bench", "bench_full", "tools")]
    assert not offenders, offenders
