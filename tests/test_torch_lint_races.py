"""The port's lockset race lint (``distlearn_tpu_torch/lint/races.py``,
DL111/DL112) against the JAX package's: the same raw findings on every
JAX target and on synthetic classes, the port's own threaded modules
clean with every allowlist entry load-bearing, and the JAX package's
seeded lock strippings firing on the port's sources (among them the
``AsyncEAServer._frame`` insert, whose race the port's lock repaired)."""

import ast
import contextlib
import inspect

import pytest

pytest.importorskip("torch")

from distlearn_tpu.lint import races as jr  # noqa: E402
from distlearn_tpu_torch.lint import races as tr  # noqa: E402


def _found(findings):
    return [(f.rule, f.message, f.where, f.severity) for f in findings]


@contextlib.contextmanager
def _raw():
    """Both packages' allowlists emptied: the analyses' raw findings."""
    saved = dict(jr.BENIGN_FIELDS), dict(tr.BENIGN_FIELDS)
    jr.BENIGN_FIELDS.clear()
    tr.BENIGN_FIELDS.clear()
    try:
        yield
    finally:
        jr.BENIGN_FIELDS.update(saved[0])
        tr.BENIGN_FIELDS.update(saved[1])


def _src(target):
    if isinstance(target, tuple):
        return target
    return inspect.getsource(target), target.__name__


JAX_TARGETS = jr.core_targets() + jr.fleet_targets()


@pytest.mark.parametrize("target", JAX_TARGETS,
                         ids=[_src(t)[1] for t in JAX_TARGETS])
def test_jax_targets_give_jax_findings(target):
    src, name = _src(target)
    with _raw():
        raw = tr.analyze_source(src, name)
        assert _found(raw) == _found(jr.analyze_source(src, name))


def test_port_targets_clean_and_allowlist_load_bearing():
    assert tr.lint_races(tr.core_targets()) == []
    assert tr.lint_races(tr.fleet_targets()) == []
    names = {_src(t)[1] for t in tr.core_targets() + tr.fleet_targets()}
    assert all(n.startswith("distlearn_tpu_torch.") for n in names)
    assert len(names) == 11
    with _raw():
        raw = {tuple(f.where.rsplit(".", 2)[-2:]) for f in tr.lint_races()}
    assert raw == set(tr.BENIGN_FIELDS)


def _strip_with(src: str, func: str, lock: str | None = None) -> str:
    """``src`` with the ``with`` blocks of ``func`` unwrapped (only those
    over ``lock`` when given)."""
    class Strip(ast.NodeTransformer):
        def visit_FunctionDef(self, node):
            self.generic_visit(node)
            if node.name == func:
                body = []
                for st in node.body:
                    if isinstance(st, ast.With) and (
                            lock is None or lock in ast.unparse(st.items[0])):
                        body.extend(st.body)
                    else:
                        body.append(st)
                node.body = body
            return node
    return ast.unparse(Strip().visit(ast.parse(src)))


@pytest.mark.parametrize("module,func,lock,field", [
    ("parallel.async_ea", "stop", "self._lock", "_errors"),
    ("parallel.async_ea", "drop", "self._reg_lock", "conns"),
    ("obs.agg", "add_endpoint", None, "Collector.endpoints"),
    ("parallel.async_ea", "_frame", "_frames_lock",
     "AsyncEAServer._frames"),
])
def test_seeded_lock_strippings_fire_on_port_sources(module, func, lock,
                                                     field):
    from importlib import import_module
    src = inspect.getsource(import_module(f"distlearn_tpu_torch.{module}"))
    mutated = _strip_with(src, func, lock)
    assert mutated != ast.unparse(ast.parse(src))
    hit = [f for f in tr.analyze_source(mutated, "mutated")
           if f.rule == "DL111" and field in f.where]
    assert hit, field
    assert "holds no lock" in hit[0].message
    # the unmutated source is clean
    assert tr.analyze_source(src, "clean") == []


_RACY = """
import threading
class W:
    def __init__(self):
        self._n = 0
        self._t = threading.Thread(target=self._loop)
    def _loop(self):
        self._n += 1
    def read(self):
        return self._n
"""
_TORN = _RACY.replace("        self._n += 1",
                      "        with self._lock:\n            self._n += 1")
_CLEAN = _TORN.replace("        return self._n",
                       "        with self._lock:\n            return self._n")
_CLOSURE = """
class W:
    def spawn(self):
        with self._lock:
            def leg():
                self._n += 1
            return leg
    def read(self):
        with self._lock:
            return self._n
"""
_TRY = """
import threading
class W:
    def __init__(self):
        self._t = threading.Thread(target=self._loop)
    def _loop(self):
        if not self._lock.acquire(blocking=False):
            return
        try:
            self._n += 1
        finally:
            self._lock.release()
    def read(self):
        with self._lock:
            return self._n
"""
_MUTATOR = """
import threading
class W:
    def __init__(self):
        self._t = threading.Thread(target=self._loop)
    def _loop(self):
        self._items.append(1)
    def read(self):
        with self._lock:
            return len(self._items)
"""


@pytest.mark.parametrize("src,api", [
    (_RACY, {"read"}), (_TORN, {"read"}), (_CLEAN, {"read"}),
    (_CLOSURE, {"read", "spawn"}), (_TRY, {"read"}), (_MUTATOR, {"read"}),
    (_RACY, set())], ids=["racy", "torn", "clean", "closure", "try",
                          "mutator", "single"])
def test_synthetic_classes_give_jax_findings(src, api):
    jr.THREAD_API["W"], tr.THREAD_API["W"] = api, api
    try:
        got = tr.analyze_source(src, "synthetic")
        assert _found(got) == _found(jr.analyze_source(src, "synthetic"))
    finally:
        del jr.THREAD_API["W"], tr.THREAD_API["W"]
