"""Finds a cell's parts by name.

``BENCHMARK.json`` names the cells, configurations and metrics; each part
lives in a file of its own under ``portbench/``:

* a configuration: the ``file`` its ``configs`` entry names (a JSON object);
* a traffic mix: ``traffic/<traffic>.json``;
* a cell's limits for ``correct``: ``limits/<cell>.json``;
* a per-layer metric: ``metrics/<metric>.py``, a module with ``LAYER``,
  ``UNIT``, ``BETTER``, ``SOURCE``, ``MOVES`` and ``read(run)``.

A later cell, mix or metric is new files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
#: the keys every metric module declares
METRIC_KEYS = ("LAYER", "UNIT", "BETTER", "SOURCE", "MOVES")


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its parts resolved."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    pkg: Path = PKG


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def _read_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is reported in cell ``workload``."""
    return "workloads" not in metric or workload in metric["workloads"]


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(bench["configs"], name, "configuration")
    return {**_read_json(root / entry["file"]), "name": name}


def traffic(name: str, pkg: Path = PKG) -> dict:
    return {**_read_json(pkg / "traffic" / f"{name}.json"), "name": name}


def limits(workload: str, pkg: Path = PKG) -> dict:
    return _read_json(pkg / "limits" / f"{workload}.json")


def metric_module(name: str, pkg: Path = PKG) -> ModuleType:
    """``metrics/<name>.py``, loaded from its path (a name may hold dots)."""
    path = pkg / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    missing = [k for k in METRIC_KEYS if not hasattr(mod, k)] + \
        ([] if hasattr(mod, "read") else ["read"])
    if missing:
        raise AttributeError(f"{path} lacks {missing}")
    return mod


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json``, its parts
    read from ``root/portbench``."""
    bench = load_benchmark(root)
    pkg = root / PKG.name
    w = _by_name(bench["workloads"], workload, "workload")
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=config(bench, w["config"], root),
        traffic=traffic(w["traffic"], pkg), limits=limits(workload, pkg),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if applies(m, workload)],
        pkg=pkg)
