"""``correct`` on the CPU at a size a test holds: a whole run of each cell
past the look for a card, with the timed path broken underneath (a step
that returns its state unchanged; half of each batch left out, the mean
over the rest; one gradient bucket left out of the update), or with the
control in the program's place, comes out not correct; a sound run comes
out correct, also when its batches come from the host through the prefetch
queue with an epoch-end sync.  The limits are the cells' own."""

import time
from functools import partial

import pytest
import torch

from portbench import calibrate, harness, spec, system

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SEED = 2**31 + 101
#: the generator's other feed: the set on the host, label-uniform draws,
#: the prefetch queue and an epoch-end sync every 4 steps
HOST_FED = {"feed": "host", "prefetch": 2, "sampler": "label_uniform",
            "epoch_sync": True}


def small(workload):
    """The cell at a size the CPU runs in seconds."""
    cell = spec.cell(workload)
    cell.config.update(image_size=64, num_classes=10)
    # at 64 px and 16 images bfloat16 moves a step's loss by tenths of a
    # nat and lr 0.1 overshoots: the step computes in float32 here.  One
    # step is compared: at this size rounding alone moves the later steps'
    # losses by tenths of a nat (the reference against itself, its rows
    # reversed)
    cell.config["compute_dtype"] = "float32"
    cell.config["optimizer"] = {**cell.config["optimizer"], "lr": 0.01}
    cell.traffic.update(examples=64, batch=16, check_steps=1,
                        warmup_steps=1, profile_steps=2)
    return cell


def run(cell, **kw):
    torch.manual_seed(0)
    return harness.run_cell(cell, SEED, 0.2, False, torch.device("cpu"),
                            time.perf_counter(), **kw)


@pytest.fixture(scope="module", autouse=True)
def _group():
    yield
    system.close()


@pytest.mark.parametrize("feed", ["own", "host"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload, feed):
    cell = small(workload)
    if feed == "host":
        cell.traffic.update(HOST_FED)
    out = run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "halfbatch", "bucket"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_step_is_not_correct(workload, fault):
    out = run(small(workload), wrap=partial(calibrate.plant, fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    cell = small(workload)
    out = run(cell, system_cls=partial(calibrate.ControlSystem,
                                       precision=cell.config["control"]))
    assert not out["correct"], out["checks"]
