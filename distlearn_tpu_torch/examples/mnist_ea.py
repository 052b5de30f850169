"""Distributed MNIST training with elastic averaging (AllReduceEA) — the
JAX package's ``examples/mnist_ea.py`` on the port (the reference's
examples/mnist-ea.lua), with the same flags; ``--tpu`` becomes
``--device``.

Reference cadence (SURVEY.md §3.2): identical init on every node, local
SGD with no collective, every ``tau``-th step the elastic round
(mnist-ea.lua:110, lua/AllReduceEA.lua:31-45), the end-of-epoch
``synchronizeCenter`` (mnist-ea.lua:121).  tau 10 and alpha 0.2 by
default, as mnist-ea.lua:18.  ``--scanCycle`` runs each cycle of tau local
steps and the round through ``build_ea_cycle`` (one CUDA graph replay a
cycle on the card); ``--momentum`` makes the local optimizer EAMSGD;
``--save``/``--resume`` checkpoint each epoch and resume the step counter,
so the rounds stay in phase.

    python -m distlearn_tpu_torch.examples.mnist_ea --numNodes 4 \\
        [--device cpu] [--scanCycle] [--save DIR [--resume]]
"""

from __future__ import annotations

import sys

import torch

from distlearn_tpu_torch.data import (PermutationSampler, load_npz,
                                      make_dataset, synthetic_mnist)
from distlearn_tpu_torch.examples import common
from distlearn_tpu_torch.models import mnist_cnn
from distlearn_tpu_torch.train import (build_ea_cycle, build_ea_steps,
                                       init_ea_state)
from distlearn_tpu_torch.utils import checkpoint as ckpt
from distlearn_tpu_torch.utils import metrics
from distlearn_tpu_torch.utils.flags import (EA_FLAGS, NODE_FLAGS,
                                             TRAIN_FLAGS, parse_flags)
from distlearn_tpu_torch.utils.logging import root_print
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.profiling import StepTimer
from distlearn_tpu_torch.utils.tree import tree_map

FLAGS = {
    **NODE_FLAGS,
    **TRAIN_FLAGS,
    **EA_FLAGS,
    "learningRate": (0.01, "learning rate"),
    "data": ("", "path to .npz (default: synthetic)"),
    "numExamples": (4096, "synthetic dataset size"),
    "reportEvery": (100, "steps between reports"),
    "scanCycle": (False, "run each tau-step EASGD cycle as one program "
                         "(build_ea_cycle: one CUDA graph replay on the "
                         "card)"),
    "momentum": (0.0, "local heavy-ball momentum — EAMSGD "
                      "(arXiv:1412.6651 §3); 0 = plain EASGD (the "
                      "reference)"),
    **common.CKPT_FLAGS,
}


def _ckpt_tree(ets) -> dict:
    return {"params": ets.params, "model_state": ets.model_state,
            "center": ets.center, "vel": ets.vel}


def _stack_nodes(tree, t):
    """Every node's copy of each leaf of ``t``, stacked on a leading
    ``[num_nodes]`` axis (the JAX package's per-node EA state)."""
    def one(x):
        buf = torch.zeros((tree.num_nodes,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        buf[tree.node_index] = x
        return tree.all_reduce(buf)[0]
    return tree_map(one, t)


def _save(opt, tree, ets, epoch: int, global_step: int) -> None:
    """Node 0 writes every node's state (the nodes diverge between
    rounds), as the JAX example saves its stacked state."""
    stacked = _stack_nodes(tree, _ckpt_tree(ets))
    if tree.node_index == 0:
        ckpt.save_checkpoint(
            opt.save, epoch, stacked,
            metadata={"epoch": epoch, "global_step": global_step,
                      "tau": opt.communicationTime, "alpha": opt.alpha,
                      "momentum": opt.momentum})


def _restore(opt, tree, ets, log):
    """This node's row of the newest checkpoint, its epoch and the step
    counter (a checkpoint without a velocity keeps the zero momentum)."""
    like = tree_map(lambda x: torch.zeros((tree.num_nodes,) + tuple(x.shape),
                                          dtype=x.dtype), _ckpt_tree(ets))
    try:
        restored, meta = ckpt.restore_checkpoint(opt.save, like)
    except KeyError:
        like.pop("vel")
        restored, meta = ckpt.restore_checkpoint(opt.save, like)
    mine = tree_map(lambda a: a[tree.node_index].to(tree.device), restored)
    ets = ets._replace(params=mine["params"],
                       model_state=mine["model_state"],
                       center=mine["center"], vel=mine.get("vel", ets.vel))
    global_step = int(meta.get("global_step", 0))
    log(f"resumed from epoch {meta['step']} (step {global_step})")
    return ets, meta["step"] + 1, global_step


def train(opt, tree) -> None:
    """One node's run of the example over its ``tree``."""
    log = root_print(tree.node_index)
    log(f"mesh: {tree.num_nodes} nodes on {tree.device}")
    if opt.data:
        x, y, nc = load_npz(opt.data)
    else:
        x, y, nc = synthetic_mnist(opt.numExamples, seed=opt.seed)
    ds = make_dataset(x, y, nc)
    model = mnist_cnn()
    ets = init_ea_state(model, tree, opt.seed, nc)
    local_step, ea_round = build_ea_steps(model, tree, lr=opt.learningRate,
                                          alpha=opt.alpha,
                                          momentum=opt.momentum)
    tau = opt.communicationTime
    start_epoch, global_step = 1, 0
    if opt.resume and opt.save and ckpt.latest_step(opt.save) is not None:
        ets, start_epoch, global_step = _restore(opt, tree, ets, log)
    cycle = build_ea_cycle(model, tree, lr=opt.learningRate, alpha=opt.alpha,
                           momentum=opt.momentum) if opt.scanCycle else None
    node = (tree.node_index, tree.num_nodes)
    timer = StepTimer()
    last_report = global_step
    for epoch in range(start_epoch, opt.numEpochs + 1):
        sampler = PermutationSampler(ds.size, seed=opt.seed + epoch)
        timer.reset_window()
        if cycle is not None:
            # tau local steps and the round a call; a shorter last group
            # ends the epoch with an early round, as in the JAX example
            timer.tick()
            for sxs, sys_ in common.device_stream_stacked(
                    ds, sampler, opt.batchSize, tau, tree.device, *node):
                k = sxs.shape[0]
                ets, losses = cycle(ets, sxs, sys_)
                timer.tick(steps=k)
                global_step += k
                if global_step - last_report >= opt.reportEvery:
                    last_report = global_step
                    cm = metrics.all_reduce_confusion(ets.cm, tree)
                    log(f"step {global_step} loss "
                        f"{float(losses.mean()):.4f} accuracy "
                        f"{metrics.total_valid(cm):.4f}")
        else:
            for bx, by in common.device_stream(ds, sampler, opt.batchSize,
                                               tree.device, *node):
                timer.tick()
                ets, loss = local_step(ets, bx, by)
                global_step += 1
                if global_step % tau == 0:       # mnist-ea.lua:110 cadence
                    ets = ea_round(ets)
                if global_step % opt.reportEvery == 0:
                    cm = metrics.all_reduce_confusion(ets.cm, tree)
                    log(f"step {global_step} loss {float(loss):.4f} "
                        f"accuracy {metrics.total_valid(cm):.4f}")
        # end-of-epoch synchronizeCenter (mnist-ea.lua:121): node 0's center
        # to all (lua/AllReduceEA.lua:74-84)
        cm = metrics.all_reduce_confusion(ets.cm, tree)
        ets = ets._replace(center=tree.broadcast_from(ets.center, 0),
                           cm=torch.zeros_like(ets.cm))
        log(f"epoch {epoch}: accuracy {metrics.total_valid(cm):.4f} "
            f"({timer.steps_per_sec():.1f} steps/s)")
        if opt.save:
            _save(opt, tree, ets, epoch, global_step)
    if tree.device.type == "cuda":
        torch.cuda.synchronize(tree.device)
    log("done")


def main(argv=None) -> int:
    opt = parse_flags("Train MNIST with elastic averaging.", FLAGS, argv)
    device = resolve_device(opt.device)   # no card, no --device cpu: raise
    common.launch(train, opt, common.resolve_num_nodes(opt.numNodes, device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
