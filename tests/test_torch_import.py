"""The import boundary of the port: quilt_tpu_torch never imports jax,
directly or through a quilt_tpu module whose imports reach jax (the
machine with the GPU has no jax)."""
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
    mods = list(_modules())
    assert "quilt_tpu_torch.engine.batch" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
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
    """quilt_tpu.panel.mspbwt imports without jax and the port reuses its
    host index and match scan; its symbols_device imports jax inside the
    function, so the port calls its own."""
    names = set()
    for p in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.ImportFrom) and node.module == "quilt_tpu.panel.mspbwt":
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module == "quilt_tpu.panel":
                assert "mspbwt" not in {a.name for a in node.names}, p
            elif isinstance(node, ast.Import):
                assert "quilt_tpu.panel.mspbwt" not in {a.name for a in node.names}, p
    # only named imports, and never its symbols_device
    assert names and "symbols_device" not in names, names
    code = "import sys; sys.modules['jax'] = None; import quilt_tpu.panel.mspbwt"
    res = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_smoke_script_imports_only_the_port():
    """chip_smoke.py imports nothing of jax nor of the JAX package."""
    mods = set(_imports(PKG.parent / "chip_smoke.py"))
    assert not {m for m in mods if m.split(".")[0] in ("jax", "quilt_tpu")}, mods
    assert any(m.startswith("quilt_tpu_torch") for m in mods)
