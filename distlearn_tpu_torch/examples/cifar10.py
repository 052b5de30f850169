"""Distributed CIFAR-10 convnet training with AllReduceSGD — the JAX
package's ``examples/cifar10.py`` on the port (the reference's
examples/cifar10.lua), with the same flags; ``--tpu`` becomes
``--device``.

Reference parity: the 5-block convnet (cifar10.lua:100-163), a node batch
of ceil(B/N) (cifar10.lua:36), label-uniform sampling (cifar10.lua:53-72),
lr 0.1, a per-epoch test pass with an allreduced confusion matrix
(cifar10.lua:210-236); checkpoint and resume each epoch.  ``--bf16``
computes in bfloat16 over float32 params; ``--hardData`` draws the
non-separable synthetic set; ``--deviceData`` keeps the dataset on the
device and gathers batches there (torch-dataset's cuda batcher,
examples/Data.lua:27), so a step moves only its index vector.

    python -m distlearn_tpu_torch.examples.cifar10 --numNodes 4 \\
        --batchSize 128 [--device cpu] [--bf16] [--deviceData] \\
        [--save DIR [--resume]] [--parity]
"""

from __future__ import annotations

import json
import sys

import torch

from distlearn_tpu_torch.data import (DeviceDataset, LabelUniformSampler,
                                      PermutationSampler, load_npz,
                                      make_dataset, synthetic_cifar10,
                                      synthetic_hard_cifar10)
from distlearn_tpu_torch.examples import common
from distlearn_tpu_torch.models import cifar_convnet
from distlearn_tpu_torch.train import (build_eval_step, build_sgd_step,
                                       build_sync_step, init_train_state)
from distlearn_tpu_torch.utils import checkpoint as ckpt
from distlearn_tpu_torch.utils import metrics
from distlearn_tpu_torch.utils.flags import (NODE_FLAGS, TRAIN_FLAGS,
                                             parse_flags)
from distlearn_tpu_torch.utils.logging import root_print
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.profiling import StepTimer
from distlearn_tpu_torch.utils.tree import tree_map

FLAGS = {
    **NODE_FLAGS,
    **TRAIN_FLAGS,
    "batchSize": (128, "global batch size"),
    "data": ("", "path to .npz with x [N,32,32,3]/y (default: synthetic)"),
    "numExamples": (8192, "synthetic dataset size"),
    "hardData": (False, "use the non-separable synthetic set (two-factor "
                        "composition + label noise): accuracy has a real "
                        "ceiling below 1.0"),
    "testExamples": (1024, "synthetic test-set size"),
    **common.CKPT_FLAGS,
    "bf16": (False, "bfloat16 compute over float32 params"),
    "testData": ("", "path to a test-split .npz (default: last 10% of "
                     "--data)"),
    "parity": (False, "print a final JSON accuracy line"),
    "deviceData": (False, "keep the whole dataset in device memory and "
                          "gather batches there; a step's host traffic is "
                          "its index vector"),
}


def _data(opt):
    if opt.data:
        x, y, nc = load_npz(opt.data)
        if opt.testData:
            xte, yte, _ = load_npz(opt.testData)
        else:
            n_test = max(1, len(y) // 10)
            xte, yte = x[-n_test:], y[-n_test:]
            x, y = x[:-n_test], y[:-n_test]
    else:
        synth = synthetic_hard_cifar10 if opt.hardData else synthetic_cifar10
        x, y, nc = synth(opt.numExamples, seed=opt.seed)
        xte, yte, _ = synth(opt.testExamples, seed=opt.seed + 1)
    return make_dataset(x, y, nc), make_dataset(xte, yte, nc), nc


def train(opt, tree) -> None:
    """One node's run of the example over its ``tree``."""
    log = root_print(tree.node_index)
    log(f"mesh: {tree.num_nodes} nodes on {tree.device}")
    ds, ds_test, nc = _data(opt)
    node = (tree.node_index, tree.num_nodes)
    if opt.deviceData:
        dds = DeviceDataset(ds.x, ds.y, nc, device=tree.device)
        dds_test = DeviceDataset(ds_test.x, ds_test.y, nc,
                                 device=tree.device)

    def stream(dset, device_set, sampler):
        if opt.deviceData:
            return device_set.batches(
                common.node_sampler(sampler, opt.batchSize, *node),
                opt.batchSize)
        return common.device_stream(dset, sampler, opt.batchSize,
                                    tree.device, *node)

    model = cifar_convnet(compute_dtype=torch.bfloat16 if opt.bf16 else None)
    ts = init_train_state(model, tree, opt.seed, nc)
    step = build_sgd_step(model, tree, lr=opt.learningRate)
    sync = build_sync_step(tree)
    ev = build_eval_step(model, tree)

    start_epoch = 1
    if opt.resume and opt.save and ckpt.latest_step(opt.save) is not None:
        restored, meta = ckpt.restore_checkpoint(
            opt.save, {"params": ts.params, "model_state": ts.model_state})
        put = lambda t: tree_map(lambda a: a.to(tree.device), t)
        ts = ts._replace(params=put(restored["params"]),
                         model_state=put(restored["model_state"]))
        start_epoch = meta["step"] + 1
        log(f"resumed from epoch {meta['step']}")

    timer = StepTimer()
    # --parity prints a line even for a run with no epoch left to train
    train_cm = test_cm = torch.zeros_like(ts.cm)
    for epoch in range(start_epoch, opt.numEpochs + 1):
        sampler = LabelUniformSampler(ds.y, seed=opt.seed + epoch)
        timer.reset_window()   # epoch-boundary eval/ckpt time is not a step
        for bx, by in stream(ds, dds if opt.deviceData else None, sampler):
            timer.tick()
            ts, _ = step(ts, bx, by)
        ts = sync(ts)
        train_cm = metrics.all_reduce_confusion(ts.cm, tree)
        ts = ts._replace(cm=torch.zeros_like(ts.cm))
        # per-epoch test pass with allreduced confusion (cifar10.lua:210-236)
        cm = torch.zeros_like(ts.cm)
        for bx, by in stream(ds_test, dds_test if opt.deviceData else None,
                             PermutationSampler(ds_test.size, seed=0)):
            cm, _ = ev(ts.params, ts.model_state, cm, bx, by)
        test_cm = metrics.all_reduce_confusion(cm, tree)
        log(f"epoch {epoch}: train accuracy "
            f"{metrics.total_valid(train_cm):.4f} | test accuracy "
            f"{metrics.total_valid(test_cm):.4f} "
            f"({timer.steps_per_sec():.2f} steps/s)")
        if opt.save and tree.node_index == 0:
            ckpt.save_checkpoint(
                opt.save, epoch,
                {"params": ts.params, "model_state": ts.model_state},
                metadata={"epoch": epoch})
    if tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)
    if opt.parity:
        log(json.dumps({
            "example": "cifar10", "epochs": opt.numEpochs,
            "data": "npz" if opt.data else "synthetic",
            "global_batch": opt.batchSize, "nodes": tree.num_nodes,
            "train_acc": round(metrics.total_valid(train_cm), 4),
            "test_acc": round(metrics.total_valid(test_cm), 4)}), flush=True)
    log("done")


def main(argv=None) -> int:
    opt = parse_flags("Train a CIFAR-10 classifier.", FLAGS, argv)
    device = resolve_device(opt.device)   # no card, no --device cpu: raise
    common.launch(train, opt, common.resolve_num_nodes(opt.numNodes, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
