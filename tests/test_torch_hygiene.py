"""The port stands alone: no file of it imports JAX or the JAX package.

Walks the AST of every Python file under src/repro_torch/, of
chip_smoke.py, of the port's sweep script and of the timing scripts that
chip_smoke.py imports (tools/time_*.py), so an import hidden inside a
function is found too.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tools" / "sweep_threshold_solves.py",
] + sorted((ROOT / "tools").glob("time_*.py"))


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) in (
            "import_module",
            "__import__",
        ):
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or top.startswith("jax")


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_neither_jax_nor_repro(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_what_it_looks_for(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import repro_torch\n"
        "def f():\n"
        "    from repro.cachesim import api\n"
        "    import jax.numpy as jnp\n"
        "    return importlib.import_module('repro.core')\n"
    )
    assert [m for m in _imported_modules(src) if _forbidden(m)] == [
        "repro.cachesim", "jax.numpy", "repro.core"
    ]
