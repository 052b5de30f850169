"""A short run of every cell on the card: the contract's last line, with
``correct`` true (``python -m pytest portbench/tests -m card`` there)."""

import json
import subprocess
import sys

import pytest

from portbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_a_short_run_is_correct_and_well_formed(card, workload):
    cmd = [sys.executable, str(spec.PKG / "run.py"), "--workload", workload,
           "--seed", str(2**31 + 7), "--seconds", "3", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {m["name"]
                                    for m in spec.cell(workload).end_to_end}


def test_the_run_refuses_without_a_card(tmp_path):
    """Without a card, or with only BENCHMARK.json and portbench/ in the
    directory, the run exits with another code than 0 and prints no
    result."""
    import shutil
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "portbench/run.py", "--workload", CELLS[0],
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
