"""Distributed MNIST training with AllReduceSGD — the JAX package's
``examples/mnist.py`` on the port (the reference's examples/mnist.lua via
mnist.sh), with the same flags; ``--tpu`` becomes ``--device``.

Reference cadence (SURVEY.md §3.1): identical init on every node,
per-step gradient allreduce and normalise (mnist.lua:109) and SGD update
(mnist.lua:112-116), the confusion matrix allreduced and printed every
``--reportEvery`` steps (mnist.lua:120-125), the end-of-epoch parameter
sync (mnist.lua:129).

    python -m distlearn_tpu_torch.examples.mnist --numNodes 4 \\
        [--device cpu] [--data mnist.npz] [--deviceData] [--parity] \\
        [--optimizer momentum|adam|adam-zero1] \\
        [--lrSchedule cosine|warmup-cosine]

``--optimizer`` other than sgd trains with the port's optax-shaped
optimizers (:mod:`~distlearn_tpu_torch.train.optim`); ``adam-zero1``
shards Adam's state over the nodes (ZeRO-1).

On the card each node is a rank with a GPU of its own (``--numNodes`` is
clamped to the cards present); ``--device cpu`` runs gloo ranks.
"""

from __future__ import annotations

import json
import sys

import torch

from distlearn_tpu_torch.data import (DeviceDataset, PermutationSampler,
                                      load_npz, make_dataset,
                                      synthetic_mnist)
from distlearn_tpu_torch.examples import common
from distlearn_tpu_torch.models import mnist_cnn
from distlearn_tpu_torch.train import (build_optax_step, build_sgd_step,
                                       build_sync_step,
                                       build_zero_optax_step,
                                       init_optax_state, init_train_state,
                                       init_zero_state)
from distlearn_tpu_torch.train import optim
from distlearn_tpu_torch.utils import metrics
from distlearn_tpu_torch.utils.flags import (NODE_FLAGS, TRAIN_FLAGS,
                                             parse_flags)
from distlearn_tpu_torch.utils.logging import root_print
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.profiling import StepTimer

FLAGS = {
    **NODE_FLAGS,
    **TRAIN_FLAGS,
    "learningRate": (0.01, "learning rate (mnist.lua:112)"),
    "data": ("", "path to .npz with x [N,32,32,1]/y (default: synthetic)"),
    "numExamples": (4096, "synthetic dataset size"),
    "reportEvery": (100, "steps between confusion-matrix reports"),
    "parity": (False, "print a final JSON accuracy line"),
    "optimizer": ("sgd", "sgd (the reference's update, fused B1 on the "
                         "card) | momentum | adam | adam-zero1 (optimizer "
                         "state sharded over the nodes)"),
    "lrSchedule": ("constant", "constant | cosine | warmup-cosine — the "
                               "schedule of the optax optimizers "
                               "(--optimizer != sgd; the sgd path keeps the "
                               "reference's fixed lr)"),
    "deviceData": (False, "dataset resident in device memory, batches "
                          "gathered on the device (see cifar10.py)"),
}


def train(opt, tree) -> None:
    """One node's run of the example over its ``tree``."""
    log = root_print(tree.node_index)
    log(f"mesh: {tree.num_nodes} nodes on {tree.device}")
    if opt.data:
        x, y, nc = load_npz(opt.data)
    else:
        x, y, nc = synthetic_mnist(opt.numExamples, seed=opt.seed)
    ds = make_dataset(x, y, nc)
    dds = DeviceDataset(ds.x, ds.y, nc, device=tree.device) \
        if opt.deviceData else None

    def train_stream(sampler):
        if dds is not None:
            return dds.batches(common.node_sampler(
                sampler, opt.batchSize, tree.node_index, tree.num_nodes),
                opt.batchSize)
        return common.device_stream(ds, sampler, opt.batchSize, tree.device,
                                    tree.node_index, tree.num_nodes)

    model = mnist_cnn()
    if opt.optimizer == "sgd":      # reference cadence (mnist.lua:112-116)
        ts = init_train_state(model, tree, opt.seed, nc)
        step = build_sgd_step(model, tree, lr=opt.learningRate)
    else:
        total_steps = max(1, opt.numEpochs * (ds.size // opt.batchSize))
        tx = _optimizer(opt, total_steps)
        if opt.optimizer == "adam-zero1":
            ts = init_zero_state(model, tree, tx, opt.seed, nc)
            step = build_zero_optax_step(model, tree, tx)
        else:
            ts = init_optax_state(model, tree, tx, opt.seed, nc)
            step = build_optax_step(model, tree, tx)
    # the winner-takes-all sync repairs uneven participation; these
    # full-participation optax runs keep params replicated, so it is an
    # identity for them (and their state is not a TrainState)
    sync = build_sync_step(tree) if opt.optimizer == "sgd" else (lambda s: s)
    timer = StepTimer()
    global_step, final_acc = 0, 0.0
    for epoch in range(1, opt.numEpochs + 1):
        sampler = PermutationSampler(ds.size, seed=opt.seed + epoch)
        timer.reset_window()   # epoch-boundary sync/report time is not a step
        for bx, by in train_stream(sampler):
            timer.tick()
            ts, loss = step(ts, bx, by)
            global_step += 1
            if global_step % opt.reportEvery == 0:
                cm = metrics.all_reduce_confusion(ts.cm, tree)
                log(f"step {global_step} loss {float(loss):.4f} accuracy "
                    f"{metrics.total_valid(cm):.4f}")
        ts = sync(ts)          # end-of-epoch sync (mnist.lua:129)
        cm = metrics.all_reduce_confusion(ts.cm, tree)
        final_acc = metrics.total_valid(cm)
        log(f"epoch {epoch}: accuracy {final_acc:.4f} "
            f"({timer.steps_per_sec():.1f} steps/s)")
        ts = ts._replace(cm=torch.zeros_like(ts.cm))
    if tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)
    if opt.parity:
        log(json.dumps({
            "example": "mnist", "epochs": opt.numEpochs,
            "data": "npz" if opt.data else "synthetic",
            "global_batch": opt.batchSize, "nodes": tree.num_nodes,
            "train_acc": round(final_acc, 4)}), flush=True)
    log("done")


_SCHEDULES = ("constant", "cosine", "warmup-cosine")
_OPTIMIZERS = ("sgd", "momentum", "adam", "adam-zero1")


def _optimizer(opt, total_steps: int) -> optim.GradientTransformation:
    """The ``--optimizer`` with its ``--lrSchedule`` over ``total_steps``."""
    lr = opt.learningRate
    if opt.lrSchedule == "cosine":
        lr = optim.cosine_decay_schedule(opt.learningRate, total_steps)
    elif opt.lrSchedule == "warmup-cosine":
        lr = optim.warmup_cosine_decay_schedule(
            0.0, opt.learningRate, warmup_steps=max(1, total_steps // 10),
            decay_steps=total_steps)
    if opt.optimizer == "momentum":
        return optim.sgd(lr, momentum=0.9)
    return optim.adam(lr)


def _check_flags(opt) -> None:
    if opt.lrSchedule not in _SCHEDULES:
        raise SystemExit(f"unknown --lrSchedule {opt.lrSchedule!r} "
                         f"(choose {', '.join(_SCHEDULES)})")
    if opt.optimizer not in _OPTIMIZERS:
        raise SystemExit(f"unknown --optimizer {opt.optimizer!r} "
                         f"(choose {', '.join(_OPTIMIZERS)})")
    if opt.optimizer == "sgd" and opt.lrSchedule != "constant":
        raise SystemExit("--lrSchedule needs an optax optimizer "
                         "(--optimizer momentum|adam|adam-zero1); the sgd "
                         "path keeps the reference's fixed lr")


def main(argv=None) -> int:
    opt = parse_flags("Train an MNIST handwritten digit classifier.", FLAGS,
                      argv)
    _check_flags(opt)
    device = resolve_device(opt.device)   # no card, no --device cpu: raise
    common.launch(train, opt, common.resolve_num_nodes(opt.numNodes, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
