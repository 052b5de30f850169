"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port; the run refuses a process that has
loaded either."""

import ast
import sys

import pytest

from portbench import spec

BANNED = {"jax", "jaxlib", "flax", "distlearn_tpu"}
MODULES = sorted(p for p in spec.PKG.rglob("*.py")
                 if "__pycache__" not in p.parts)


def _top_level_imports(path):
    """The top-level name (before the first dot) of every import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(spec.PKG)) for p in MODULES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((spec.PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert "distlearn_tpu_torch" not in _top_level_imports(path)


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's, and is allowed
    assert "distlearn_tpu_torch".split(".")[0] not in BANNED
    assert "distlearn_tpu.ops".split(".")[0] in BANNED


def test_the_run_names_a_banned_module_it_finds(monkeypatch):
    import importlib.util
    loc = importlib.util.spec_from_file_location("portbench_run",
                                                 spec.PKG / "run.py")
    run = importlib.util.module_from_spec(loc)
    loc.loader.exec_module(run)
    for name in [m for m in sys.modules if m.split(".")[0] in BANNED]:
        monkeypatch.delitem(sys.modules, name)
    assert run.loaded_banned() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    monkeypatch.setitem(sys.modules, "distlearn_tpu_torch.fake", object())
    assert run.loaded_banned() == ["jaxlib"]
