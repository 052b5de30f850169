"""The port's distlint CLI (``python -m distlearn_tpu_torch.tools.distlint``)
against the JAX package's: the same 14 families and rule IDs, the JSON
keys the JAX CLI writes, ``--all --device cpu`` clean (every step family
on 8 gloo ranks here), the recorded bytes of the units that move the JAX
registry's tensors within its lockfiles' byte tolerance, re-baselined
lockfiles that a second run passes, and the exit codes (a family that
runs on the card finds none here: exit 2, never a CPU run)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from distlearn_tpu.lint import core as jax_core  # noqa: E402
from distlearn_tpu.lint import registry as jax_registry  # noqa: E402
from distlearn_tpu_torch.lint import budget, registry  # noqa: E402
from distlearn_tpu_torch.lint.core import RULES  # noqa: E402
from distlearn_tpu_torch.tools import distlint  # noqa: E402

from tests import torch_mesh_worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_BUDGETS = ROOT / "distlearn_tpu" / "lint" / "budgets"


def _cli(*args, timeout=600):
    """The CLI as a process, niced (with its 8 rank processes) so that the
    burst leaves the other workers' timing-bound tests their cores."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run(
        [sys.executable, "-m", "distlearn_tpu_torch.tools.distlint", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
        preexec_fn=lambda: os.nice(10))


@pytest.fixture(scope="module")
def all_json(tmp_path_factory):
    """One ``--all --device cpu --format json`` run a session."""
    def compute():
        p = _cli("--all", "--device", "cpu", "--format", "json")
        return p.returncode, p.stdout, p.stderr
    return torch_mesh_worker.once_per_session("torch_distlint_all",
                                              tmp_path_factory, compute)


def test_list_names_jax_families_and_rules(capsys):
    assert distlint.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert list(registry.families()) == list(jax_registry.families())
    assert list(RULES) == list(jax_core.RULES)
    for name in jax_registry.families():
        assert f"  {name} " in out
    for rid in jax_core.RULES:
        assert f"  {rid}  [" in out


def _jax_json_keys() -> set:
    """The keys of the document JAX's ``tools/distlint.py`` prints."""
    tree = ast.parse((ROOT / "tools" / "distlint.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "doc"
                for t in node.targets) and isinstance(node.value, ast.Dict):
            return {k.value for k in node.value.keys}
    raise AssertionError("no doc dict in tools/distlint.py")


def test_all_on_the_cpu_is_clean_with_jax_json_keys(all_json):
    rc, out, err = all_json
    assert rc == 0, err[-3000:]
    doc = json.loads(out)
    assert set(doc) == _jax_json_keys()
    assert doc["findings"] == [] and doc["errors"] == 0
    assert doc["rules"] == sorted(jax_core.RULES)
    assert sorted(doc["costs"]) == sorted(jax_registry.families())
    assert doc["info"]["model:sharded"] == {"states": 929,
                                            "transitions": 1907}
    calls = doc["info"]["decode:tp_follow"]["calls_by_rank"]
    assert len(calls) == 2 and len(set(calls.values())) == 1
    for fam, reports in doc["costs"].items():
        committed = budget.load_budget(fam)["units"]
        assert sorted(reports) == sorted(committed)
        for unit, rep in reports.items():
            assert rep["peak_bytes"] is None       # none read on the CPU
            for key in ("collective_bytes", "collective_ops",
                        "bytes_by_axis"):
                assert rep[key] == committed[unit][key], (fam, unit, key)


@pytest.mark.parametrize("fam,unit", [("sgd", "sgd_step"),
                                      ("sgd", "sync_step"),
                                      ("ea", "ea_round"),
                                      ("sync", "sync_mesh_allreduce")])
def test_bytes_agree_with_jax_lockfiles(all_json, fam, unit):
    """Units that move the JAX registry's tensors (the MNIST CNN's 10,842
    parameters; the sync family's 8 x (64 + 128 x 64) rows) move its bytes,
    kind by kind and axis by axis, within its lockfile's byte tolerance."""
    mine = json.loads(all_json[1])["costs"][fam][unit]
    ref_doc = json.loads((JAX_BUDGETS / f"{fam}.json").read_text())
    ref = ref_doc["units"][unit]
    tol = ref_doc["tolerance"]["bytes"]
    assert sorted(mine["bytes_by_axis"]) == sorted(ref["bytes_by_axis"])
    for key, want in ref["bytes_by_axis"].items():
        got = mine["bytes_by_axis"][key]
        assert abs(got - want) <= tol * want, (key, got, want)


def test_update_budgets_then_a_second_run_passes(tmp_path, capsys):
    fams = ["--family", "sync", "--family", "wirek", "--family", "protocol"]
    assert distlint.main(["--update-budgets", "--device", "cpu",
                          "--budget-dir", str(tmp_path), *fams]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["protocol.json", "sync.json", "wirek.json"]
    doc = json.loads((tmp_path / "sync.json").read_text())
    assert doc["tolerance"] == {"bytes": 0.25, "memory": 0.35}
    assert doc["units"]["sync_mesh_allreduce"]["collective_bytes"] == \
        {"all-reduce": 33024}
    assert distlint.main(["--device", "cpu", "--budget-dir", str(tmp_path),
                          *fams, "-q"]) == 0
    empty = tmp_path / "empty"
    empty.mkdir()
    assert distlint.main(["--device", "cpu", "--budget-dir", str(empty),
                          "--family", "sync"]) == 1
    assert "DL203" in capsys.readouterr().out


def test_exit_codes():
    assert distlint.main([]) == 2
    assert distlint.main(["--family", "nope"]) == 2
    assert distlint.main(["--races", "--disable", "DL999"]) == 2
    assert distlint.main(["--model", "--races", "-q"]) == 0
    # the default device is the card: with none here a device family
    # fails instead of running on the CPU
    p = _cli("--family", "wirek")
    assert p.returncode == 2 and "run on the card" in p.stderr
