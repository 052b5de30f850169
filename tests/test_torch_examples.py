"""The port's convnet examples (``python -m distlearn_tpu_torch.examples.
{mnist,mnist_ea,cifar10}``) on the CPU (``--device cpu``):

* mnist on two gloo ranks: the parity line of
  tests/test_examples_parity.py::test_mnist_parity_line, with its
  arguments and its bar (train_acc > 0.5 after 3 epochs of the separable
  synthetic set);
* cifar10 with ``--hardData --bf16 --save``, on one node in this process:
  ``--resume`` (with ``--deviceData``) starts epoch 2 from the state a
  straight run starts it from, bit for bit;
* mnist_ea with ``--scanCycle`` (build_ea_cycle): on two ranks, a resume
  from the straight run's epoch-1 checkpoint gives its epoch 2 and its
  epoch-2 checkpoint bit for bit (every node's row); on one node in this
  process, the cycle against the per-step loop and a resume, each epoch's
  accuracy and checkpoint the same;
* mnist's ``--optimizer``/``--lrSchedule`` train one epoch, bad values
  exit; the resnet50 example at 32^2 with a checkpoint and a resume;
* no card and no ``--device cpu`` raises, and ``--numNodes`` is clamped to
  the cards.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu_torch.examples import (cifar10, common, mnist,  # noqa: E402
                                          mnist_ea, resnet50)
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_map  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600
# one thread a rank: the test run shares the cores between its workers
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _run(example: str, *args: str) -> str:
    out = subprocess.run(
        [sys.executable, "-m", f"distlearn_tpu_torch.examples.{example}",
         "--device", "cpu", "--numNodes", "2", *args],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT, env=ENV)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _parity(stdout: str) -> dict:
    return json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("{")][-1])


def _epoch_lines(stdout: str) -> list[str]:
    """Each epoch's accuracy, without its (timing) steps/s."""
    return [re.sub(r" \(.*steps/s\)", "", ln) for ln in stdout.splitlines()
            if ln.startswith("epoch ")]


def _same_checkpoint(a, b) -> None:
    """Two checkpoint files hold the same leaves, bit for bit."""
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            if k != "__meta__":
                assert za[k].dtype == zb[k].dtype, k
                assert za[k].tobytes() == zb[k].tobytes(), k


def test_mnist_parity_line():
    rec = _parity(_run("mnist", "--numEpochs", "3", "--batchSize", "64",
                       "--numExamples", "512", "--learningRate", "0.05",
                       "--reportEvery", "1000", "--parity"))
    assert rec["example"] == "mnist" and rec["data"] == "synthetic"
    assert rec["nodes"] == 2 and rec["epochs"] == 3
    assert rec["train_acc"] > 0.5, rec


def test_cifar10_bf16_hard_data_saves_and_resumes(tmp_path, monkeypatch,
                                                 capsys):
    """A resumed run starts epoch 2 from the params and batchnorm stats a
    straight run starts it from, bit for bit.  Its epoch-2 accuracies are
    not the straight run's: the dropout generator restarts from the seed,
    as in the JAX example, which checkpoints only these two."""
    seen = []                  # (params, batchnorm stats) each step is given
    build = cifar10.build_sgd_step

    def spy_build(*args, **kw):
        step = build(*args, **kw)

        def spy(ts, x, y):
            seen.append(tree_map(torch.clone, (ts.params, ts.model_state)))
            return step(ts, x, y)
        return spy
    monkeypatch.setattr(cifar10, "build_sgd_step", spy_build)
    straight, split = tmp_path / "straight", tmp_path / "split"
    args = ["--device", "cpu", "--numNodes", "1", "--batchSize", "32",
            "--numExamples", "64", "--testExamples", "32", "--hardData",
            "--bf16", "--numEpochs", "2", "--parity"]
    capsys.readouterr()
    cifar10.main([*args, "--save", str(straight)])
    first = capsys.readouterr().out
    straight_seen, seen[:] = seen[:], []
    assert [ln.split(":")[0] for ln in _epoch_lines(first)] == \
        ["epoch 1", "epoch 2"]
    split.mkdir()
    shutil.copy(straight / "ckpt_1.npz", split)
    cifar10.main([*args, "--save", str(split), "--resume", "--deviceData"])
    second = capsys.readouterr().out
    assert "resumed from epoch 1" in second
    assert [ln.split(":")[0] for ln in _epoch_lines(second)] == ["epoch 2"]
    assert os.path.exists(split / "ckpt_2.npz")
    steps_per_epoch = len(seen)
    assert 2 * steps_per_epoch == len(straight_seen)
    for name, got, want in zip(("params", "batchnorm stats"), seen[0],
                               straight_seen[steps_per_epoch]):
        got, want = tree_flatten(got)[0], tree_flatten(want)[0]
        assert len(got) == len(want) > 0, name
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    for rec in (_parity(first), _parity(second)):
        assert rec["example"] == "cifar10" and rec["epochs"] == 2
        assert rec["nodes"] == 1 and rec["global_batch"] == 32
        for key in ("train_acc", "test_acc"):
            assert math.isfinite(rec[key]), rec


def test_mnist_ea_scan_cycle_two_ranks(tmp_path):
    straight, split = tmp_path / "straight", tmp_path / "split"
    args = ["--scanCycle", "--numEpochs", "2", "--batchSize", "32",
            "--numExamples", "512", "--learningRate", "0.05",
            "--communicationTime", "4"]
    lines = _epoch_lines(_run("mnist_ea", *args, "--save", str(straight)))
    assert [ln.split(":")[0] for ln in lines] == ["epoch 1", "epoch 2"]
    assert float(lines[-1].split()[-1]) > 0.5, lines
    # resumed from the epoch-1 checkpoint, each node takes its own row back
    # (the nodes differ between rounds) and the step counter (16 steps an
    # epoch): epoch 2 and its checkpoint are the straight run's
    split.mkdir()
    shutil.copy(straight / "ckpt_1.npz", split)
    resumed = _run("mnist_ea", *args, "--save", str(split), "--resume")
    assert "resumed from epoch 1 (step 16)" in resumed
    assert _epoch_lines(resumed) == lines[1:]
    _same_checkpoint(straight / "ckpt_2.npz", split / "ckpt_2.npz")


def _mnist_ea(capsys, *args: str) -> str:
    """One node of mnist_ea in this process; its stdout."""
    capsys.readouterr()
    mnist_ea.main(["--device", "cpu", "--numNodes", "1", "--batchSize",
                   "32", "--numExamples", "256", "--learningRate", "0.05",
                   "--communicationTime", "4", *args])
    return capsys.readouterr().out


def test_mnist_ea_scan_cycle_matches_the_step_loop(tmp_path, capsys):
    """The cycle against the per-step loop, and a resume at epoch 3
    against the straight 3-epoch loop: the same epoch accuracies and the
    same checkpoints, bit for bit."""
    straight, split = tmp_path / "straight", tmp_path / "split"
    loop = _mnist_ea(capsys, "--numEpochs", "3", "--save", str(straight))
    scan = _mnist_ea(capsys, "--numEpochs", "2", "--scanCycle",
                     "--save", str(split))
    assert len(_epoch_lines(loop)) == 3
    assert _epoch_lines(scan) == _epoch_lines(loop)[:2]
    _same_checkpoint(straight / "ckpt_2.npz", split / "ckpt_2.npz")
    # the resumed run continues the step counter (8 steps an epoch)
    resumed = _mnist_ea(capsys, "--numEpochs", "3", "--scanCycle",
                        "--save", str(split), "--resume")
    assert "resumed from epoch 2 (step 16)" in resumed
    assert _epoch_lines(resumed) == _epoch_lines(loop)[2:]
    _same_checkpoint(straight / "ckpt_3.npz", split / "ckpt_3.npz")


@pytest.mark.parametrize("flags", [
    ("--optimizer", "momentum"), ("--optimizer", "adam"),
    ("--optimizer", "adam-zero1"),
    ("--optimizer", "momentum", "--lrSchedule", "cosine"),
    ("--optimizer", "adam", "--lrSchedule", "warmup-cosine"),
    ("--optimizer", "adam-zero1", "--lrSchedule", "cosine"),
], ids=lambda f: "-".join(a.lstrip("-") for a in f))
def test_mnist_optimizer_flags_train_one_epoch(flags, capsys):
    """The optax optimizers and schedules through the example, one node in
    this process: one epoch trains above chance (10 classes)."""
    mnist.main(["--device", "cpu", "--numEpochs", "1", "--numExamples",
                "512", "--batchSize", "32", "--learningRate", "0.01",
                "--reportEvery", "1000", "--parity", *flags])
    rec = _parity(capsys.readouterr().out)
    assert rec["epochs"] == 1 and rec["train_acc"] > 0.15, rec


@pytest.mark.parametrize("flags,match", [
    (("--optimizer", "rmsprop"), "unknown --optimizer"),
    (("--lrSchedule", "step"), "unknown --lrSchedule"),
    (("--lrSchedule", "cosine"), "needs an optax optimizer"),
])
def test_mnist_bad_optimizer_flags_exit(flags, match):
    with pytest.raises(SystemExit, match=match):
        mnist.main(["--device", "cpu", *flags])


def test_resnet50_example_smoke(tmp_path):
    """``examples/resnet50.py`` at 32^2, batch 8, 2 steps an epoch, with an
    async checkpoint and a resume: every loss finite, 161 leaves."""
    args = ["--imageSize", "32", "--batchSize", "8", "--stepsPerEpoch",
            "2", "--numExamples", "64", "--numClasses", "10",
            "--save", str(tmp_path)]
    out = subprocess.run(
        [sys.executable, "-m", "distlearn_tpu_torch.examples.resnet50",
         "--device", "cpu", "--numEpochs", "1", *args],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "4"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "resnet50: 23,528,522 params, 161 leaves, bucket 16 MiB" \
        in out.stdout
    assert (tmp_path / "ckpt_1.npz").exists()
    resumed = subprocess.run(
        [sys.executable, "-m", "distlearn_tpu_torch.examples.resnet50",
         "--device", "cpu", "--numEpochs", "2", "--resume", *args],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "4"})
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    assert "resumed from epoch 1" in resumed.stdout
    losses = [float(m) for m in re.findall(r"epoch \d+: loss (\S+)",
                                           out.stdout + resumed.stdout)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)


@pytest.mark.parametrize("module", [mnist, mnist_ea, cifar10, resnet50])
def test_examples_raise_without_gpu(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--numEpochs", "1"])


def test_num_nodes_clamped_to_the_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert common.resolve_num_nodes(4, torch.device("cuda", 0)) == 1
    assert "--numNodes 4 exceeds the 1 attached GPU(s)" in \
        capsys.readouterr().err
    assert common.resolve_num_nodes(1, torch.device("cuda", 0)) == 1
    assert common.resolve_num_nodes(4, torch.device("cpu")) == 4
    with pytest.raises(SystemExit, match="multiple of"):
        common.node_rows(30, 0, 4)
