"""Distributed ResNet-50 v1.5 training with AllReduceSGD — the JAX
package's ``examples/resnet50.py`` on the port, with the same flags and
defaults; ``--tpu`` becomes ``--device``.

The 25.6M-parameter, 161-leaf tree is where gradient bucketing matters:
``--bucketMB`` packs the gradients into flat buckets (8 at 16 MiB), so a
step makes one allreduce and one launch of the fused SGD kernel (B1) per
bucket instead of one per tensor; ``build_sync_step`` runs at the end of an
epoch.  Checkpoints go through the asynchronous writer (``--save``,
``--resume``), one epoch's write overlapping the next epoch.

    python -m distlearn_tpu_torch.examples.resnet50 --batchSize 256 \\
        [--bf16] [--deviceData] [--stepsPerEpoch 5] [--device cpu] \\
        [--save DIR [--resume]]
"""

from __future__ import annotations

import sys

import torch

from distlearn_tpu_torch.data import (DeviceDataset, PermutationSampler,
                                      load_npz, make_dataset,
                                      synthetic_imagenet)
from distlearn_tpu_torch.examples import common
from distlearn_tpu_torch.models import param_count, resnet50
from distlearn_tpu_torch.train import (build_sgd_step, build_sync_step,
                                       init_train_state)
from distlearn_tpu_torch.utils import checkpoint as ckpt
from distlearn_tpu_torch.utils import metrics
from distlearn_tpu_torch.utils.flags import (NODE_FLAGS, TRAIN_FLAGS,
                                             parse_flags)
from distlearn_tpu_torch.utils.logging import root_print
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.profiling import StepTimer
from distlearn_tpu_torch.utils.tree import tree_leaves, tree_map

FLAGS = {
    **NODE_FLAGS,
    **TRAIN_FLAGS,
    "batchSize": (256, "global batch size"),
    "imageSize": (224, "square image edge"),
    "numClasses": (1000, "label count"),
    "numExamples": (2048, "synthetic dataset size"),
    "data": ("", "path to .npz with x [N,S,S,3]/y (default: synthetic)"),
    **common.CKPT_FLAGS,
    "bf16": (False, "bfloat16 compute over float32 params"),
    "bucketMB": (16, "gradient bucket size in MiB (0 = one bucket)"),
    "stepsPerEpoch": (0, "cap steps per epoch (0 = full epoch)"),
    "deviceData": (False, "dataset resident in device memory, batches "
                          "gathered on the device (needs numExamples * "
                          "imageSize^2 * 12 B of device memory)"),
}


def train(opt, tree) -> None:
    """One node's run of the example over its ``tree``."""
    log = root_print(tree.node_index)
    log(f"mesh: {tree.num_nodes} nodes on {tree.device}")
    if opt.data:
        x, y, nc = load_npz(opt.data)
    else:
        x, y, nc = synthetic_imagenet(opt.numExamples, opt.imageSize,
                                      opt.numClasses, seed=opt.seed)
    ds = make_dataset(x, y, nc)
    node = (tree.node_index, tree.num_nodes)
    dds = DeviceDataset(ds.x, ds.y, nc, device=tree.device) \
        if opt.deviceData else None

    def train_stream(sampler):
        if dds is not None:
            return dds.batches(common.node_sampler(sampler, opt.batchSize,
                                                   *node), opt.batchSize)
        return common.device_stream(ds, sampler, opt.batchSize, tree.device,
                                    *node)

    model = resnet50(num_classes=nc, image_size=opt.imageSize,
                     compute_dtype=torch.bfloat16 if opt.bf16 else None)
    ts = init_train_state(model, tree, opt.seed, nc)
    log(f"resnet50: {param_count(ts.params):,} params, "
        f"{len(tree_leaves(ts.params))} leaves, bucket {opt.bucketMB} MiB")
    step = build_sgd_step(
        model, tree, lr=opt.learningRate,
        max_bucket_bytes=opt.bucketMB * 1024 * 1024 if opt.bucketMB else None)
    sync = build_sync_step(tree)

    start_epoch = 1
    if opt.resume and opt.save and ckpt.latest_step(opt.save) is not None:
        restored, meta = ckpt.restore_checkpoint(
            opt.save, {"params": ts.params, "model_state": ts.model_state})
        put = lambda t: tree_map(lambda a: a.to(tree.device), t)  # noqa: E731
        ts = ts._replace(params=put(restored["params"]),
                         model_state=put(restored["model_state"]))
        start_epoch = meta["step"] + 1
        log(f"resumed from epoch {meta['step']}")

    timer = StepTimer()
    with ckpt.AsyncCheckpointer(opt.save or ".", keep=3) as saver:
        for epoch in range(start_epoch, opt.numEpochs + 1):
            sampler = PermutationSampler(ds.size, seed=opt.seed + epoch)
            timer.reset_window()   # epoch-boundary sync/ckpt is not a step
            for i, (bx, by) in enumerate(train_stream(sampler)):
                timer.tick()
                ts, loss = step(ts, bx, by)
                if opt.stepsPerEpoch and i + 1 >= opt.stepsPerEpoch:
                    break
            ts = sync(ts)
            cm = metrics.all_reduce_confusion(ts.cm, tree)
            ts = ts._replace(cm=torch.zeros_like(ts.cm))
            log(f"epoch {epoch}: loss {float(loss):.4f} train accuracy "
                f"{metrics.total_valid(cm):.4f} "
                f"({timer.steps_per_sec():.2f} steps/s)")
            if opt.save and tree.node_index == 0:
                saver.save(epoch, {"params": ts.params,
                                   "model_state": ts.model_state},
                           metadata={"epoch": epoch})
    if tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)
    log("done")


def main(argv=None) -> int:
    opt = parse_flags("Train ResNet-50 v1.5.", FLAGS, argv)
    device = resolve_device(opt.device)   # no card, no --device cpu: raise
    common.launch(train, opt, common.resolve_num_nodes(opt.numNodes, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
