"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``vae2_tpu_torch`` is not ``vae2_tpu``."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vae2_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert "vae2_tpu_torch" not in top_level_imports(path)
    relative = [n for n in ast.walk(ast.parse(path.read_text()))
                if isinstance(n, ast.ImportFrom) and n.level > 1]
    assert not relative, "the reference reaches out of its folder"


def test_whole_names_are_compared():
    from benchmark import run

    assert "vae2_tpu" in run.FORBIDDEN and "vae2_tpu_torch" not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_runtime_guard_sees_whole_names(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "vae2_tpu_torch_probe", types.ModuleType("x"))
    assert "vae2_tpu" not in run.forbidden_modules() or "vae2_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "flax.core", types.ModuleType("flax.core"))
    assert "flax" in run.forbidden_modules()
