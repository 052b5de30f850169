"""Finding a cell's parts by name, BENCHMARK.json's shape, and a new cell,
configuration, traffic mix and metric added as files and entries alone."""

import json
import re
import shutil

import pytest

from portbench import check, spec
from portbench.harness import Run, read_metrics

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_cell_resolves_its_parts():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        assert cell.limits and set(cell.limits) <= set(check.NUMBERS)
        assert all(v >= 0 for v in cell.limits.values())
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_benchmark_json_keeps_its_contract():
    bench = spec.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][1].startswith("portbench/")
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in SOURCES


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_each_metric_module_declares_what_benchmark_json_says(kind):
    for m in spec.load_benchmark()[kind]:
        mod = spec.metric_module(m["name"])
        assert (mod.UNIT, mod.BETTER, mod.SOURCE) == \
            (m["unit"], m["better"], m["source"]), m["name"]
        if kind == "per_layer":
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.cell("no.such.cell")
    with pytest.raises(FileNotFoundError):
        spec.traffic("no_such_mix")


def test_a_new_cell_is_files_and_entries_alone(tmp_path):
    """A copy of the benchmark plus a new configuration, traffic mix,
    limits file, per-layer metric and cell: found by name, nothing edited."""
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.load_benchmark()
    pkg = tmp_path / "portbench"
    cfg = json.loads((spec.ROOT / bench["configs"][0]["file"]).read_text())
    (pkg / "configs" / "resnet101_v1.5.json").write_text(
        json.dumps({**cfg, "blocks_per_stage": [3, 4, 23, 3]}))
    (pkg / "traffic" / "imagenet_host_b128.json").write_text(json.dumps(
        {**spec.traffic("imagenet_device_b256"), "batch": 128,
         "feed": "host", "prefetch": 2, "sampler": "label_uniform",
         "epoch_sync": True}))
    (pkg / "limits" / "resnet101.sgd.bf16.b128.json").write_text(
        json.dumps({"loss_gap": 1.0}))
    (pkg / "metrics" / "steps_in_window.py").write_text(
        'LAYER = "step builder"\nUNIT = "steps"\nBETTER = "higher"\n'
        'SOURCE = "host_clock"\nMOVES = "train_samples_per_s"\n\n\n'
        'def read(run):\n    return run.steps or None\n')
    bench["configs"].append({
        "name": "resnet101_v1.5", "source": "https://example.org",
        "file": "portbench/configs/resnet101_v1.5.json",
        "reduced": [], "why": "a test"})
    bench["workloads"].append({
        "name": "resnet101.sgd.bf16.b128", "config": "resnet101_v1.5",
        "traffic": "imagenet_host_b128", "chips": 1, "why": "a test"})
    bench["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "step builder",
        "moves": "train_samples_per_s",
        "workloads": ["resnet101.sgd.bf16.b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("resnet101.sgd.bf16.b128", root=tmp_path)
    assert cell.config["blocks_per_stage"] == [3, 4, 23, 3]
    assert cell.traffic["batch"] == 128 and cell.traffic["feed"] == "host"
    assert cell.limits == {"loss_gap": 1.0}
    assert [m["name"] for m in cell.per_layer][-1] == "steps_in_window"
    run = Run(cell.config, cell.traffic, 1, 1.0, steps=7)
    assert read_metrics(cell.per_layer[-1:], run, cell.pkg) == \
        {"steps_in_window": {"value": 7.0, "unit": "steps"}}
    # the cells already there read as before
    assert spec.cell("resnet50.sgd.bf16.b256", root=tmp_path).config == \
        spec.cell("resnet50.sgd.bf16.b256").config
