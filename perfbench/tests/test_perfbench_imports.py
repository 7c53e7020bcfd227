"""Nothing the benchmark runs imports JAX or the JAX package ``repro``, and
the reference imports nothing of the port either.  Module names are
compared by their top-level name, whole: ``repro_torch`` is not
``repro``."""
import ast
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_imports(path))


def test_loaded_check_compares_whole_names(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_fake", types.ModuleType(
        "repro_torch_fake"))
    assert "repro" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.fake", types.ModuleType("x"))
    assert "repro" in harness.loaded_forbidden()
