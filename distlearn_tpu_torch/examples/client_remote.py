"""Multi-host training over the TCP tree or ring — the JAX package's
``examples/client_remote.py`` on the port (the reference's
examples/client_remote.lua), with the same flags; ``--tpu`` becomes
``--device``.

Each PROCESS is one node: it trains ``mnist_cnn`` on its own device (the
card by default), with the EA family's local SGD step, and synchronizes
elastically through ``comm/tree.py`` or ``comm/ring.py`` over TCP with the
reference's AllReduceEA semantics (``parallel/host_algorithms.py``).  The
parameters stay on the device: every elastic round is one launch of kernel
B2 a bucket, and only the deltas cross to the host, through the handle's
pinned frame.  Several processes may share one card.

Single machine (two "hosts" as processes):

    python -m distlearn_tpu_torch.examples.client_remote --nodeIndex 1 --numNodes 2 &
    python -m distlearn_tpu_torch.examples.client_remote --nodeIndex 2 --numNodes 2 &

(``--device cpu`` runs them on the CPU.)  Across real machines: run node 1
on the coordinator host, point the others at it, and tell each rank how it
can be reached::

    host-a$ python -m distlearn_tpu_torch.examples.client_remote --nodeIndex 1 \\
                --numNodes 2 --host 0.0.0.0 --advertiseHost host-a --port 9090
    host-b$ python -m distlearn_tpu_torch.examples.client_remote --nodeIndex 2 \\
                --numNodes 2 --host host-a --listenHost 0.0.0.0 --advertiseHost host-b

Every node prints ``[node i] final params digest <sha256[:16]>``, the same
on every node (the reference's sync oracle), and ``[node i] elastic rounds
R, fused_elastic launches L``.
"""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from distlearn_tpu_torch.comm.ring import Ring
from distlearn_tpu_torch.comm.tree import Tree
from distlearn_tpu_torch.data import (PermutationSampler, load_npz,
                                      make_dataset, per_node_batch_size,
                                      synthetic_mnist)
from distlearn_tpu_torch.models import mnist_cnn
from distlearn_tpu_torch.ops import fused_update
from distlearn_tpu_torch.parallel.host_algorithms import TreeAllReduceEA
from distlearn_tpu_torch.train.trainer import local_update, value_and_grad
from distlearn_tpu_torch.utils.flags import (EA_FLAGS, NODE_FLAGS,
                                             TRAIN_FLAGS, parse_flags)
from distlearn_tpu_torch.utils.logging import root_print
from distlearn_tpu_torch.utils.platform import resolve_device
from distlearn_tpu_torch.utils.tree import tree_leaves

FLAGS = {
    **NODE_FLAGS,
    **TRAIN_FLAGS,
    **EA_FLAGS,
    "host": ("127.0.0.1", "rank-0 coordinator address every node dials "
                          "(client_remote.lua:8,34-39)"),
    "port": (9090, "coordinator port (client_remote.lua:9)"),
    "base": (2, "tree fan-out (client_remote.lua:12)"),
    "backend": ("tree", "host collective: tree (reference topology, "
                        "latency-optimal) | ring (bandwidth-optimal — "
                        "comm/ring.py)"),
    "listenHost": ("", "local bind address for this rank's child "
                       "listener (multi-host: 0.0.0.0)"),
    "advertiseHost": ("", "address other ranks dial to reach this rank"),
    "learningRate": (0.01, "local SGD learning rate"),
    "numExamples": (2048, "synthetic dataset size (global)"),
    "data": ("", "path to .npz with x [N,32,32,1]/y (default: synthetic)"),
}


def _handle(opt, rank: int):
    kw = dict(listen_host=opt.listenHost or None,
              advertise_host=opt.advertiseHost or None)
    if opt.backend == "ring":
        return Ring(rank, opt.numNodes, opt.host, opt.port, **kw)
    if opt.backend == "tree":
        return Tree(rank, opt.numNodes, opt.host, opt.port, base=opt.base,
                    **kw)
    raise SystemExit(f"unknown --backend {opt.backend!r} (tree | ring)")


def main(argv=None) -> int:
    opt = parse_flags("Multi-host elastic-averaging training (TCP tree).",
                      FLAGS, argv)
    device = resolve_device(opt.device)   # no card, no --device cpu: raise
    rank = opt.nodeIndex - 1            # reference nodeIndex is 1-based
    log = root_print(rank)
    tree = _handle(opt, rank)
    log(f"{opt.backend} up: {opt.numNodes} nodes, device {device}")

    if opt.data:
        x, y, nc = load_npz(opt.data)
    else:
        x, y, nc = synthetic_mnist(opt.numExamples, seed=opt.seed)
    ds = make_dataset(x, y, nc, partition=rank, partitions=opt.numNodes)
    per_node = per_node_batch_size(opt.batchSize, opt.numNodes)

    model = mnist_cnn()
    params, mstate = model.init(opt.seed, device)   # same seed: same init
    ea = TreeAllReduceEA(tree, tau=opt.communicationTime, alpha=opt.alpha)
    params = ea.synchronize_parameters(params)      # initial scatter
    launches0 = fused_update.fused_elastic.launches

    for epoch in range(1, opt.numEpochs + 1):
        sampler = PermutationSampler(ds.size, seed=opt.seed + epoch + rank)
        losses = []
        for idx in sampler.epoch(per_node):
            bx = torch.as_tensor(ds.x[idx], device=device)
            by = torch.as_tensor(ds.y[idx], device=device)
            loss, _, mstate, grads = value_and_grad(model, params, mstate,
                                                    bx, by, None, None)
            params, _ = local_update(params, grads, None, opt.learningRate,
                                     0.0)
            losses.append(loss)
            # elastic round every tau-th step, zero comm otherwise
            params = ea.average_parameters(params)
        params = ea.synchronize_center(params)
        log(f"epoch {epoch}: mean loss "
            f"{float(torch.stack(losses).mean()):.4f}")

    params = ea.synchronize_parameters(params)
    flat = np.concatenate([l.detach().cpu().numpy().ravel()
                           for l in tree_leaves(params)])
    digest = hashlib.sha256(flat.tobytes()).hexdigest()[:16]
    # identical on every node — the reference's own sync oracle
    # (test_AllReduceSGD.lua:38)
    print(f"[node {opt.nodeIndex}] final params digest {digest}")
    print(f"[node {opt.nodeIndex}] elastic rounds {ea.rounds}, "
          f"fused_elastic launches "
          f"{fused_update.fused_elastic.launches - launches0}", flush=True)
    tree.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
