"""The AsyncEA (EASGD) trio on the port — counterpart of the JAX package's
``examples/easgd_{server,client,tester}.py`` and ``easgd_common.py`` (the
reference's examples/EASGD_{server,client,tester}.lua).

Run each role as its own process, on the card unless ``--device cpu``:

    python -m distlearn_tpu_torch.examples.easgd server --numNodes 2 \\
        --port 9500 --model cifar --wireCodec int8 --tester
    python -m distlearn_tpu_torch.examples.easgd client --nodeIndex 1 \\
        --numNodes 2 --port 9500 --model cifar --wireCodec int8
    python -m distlearn_tpu_torch.examples.easgd tester --numNodes 2 \\
        --port 9500 --model cifar --numTests 5

Every role builds the SAME model from the SAME seed (ref Model.lua:17) and
the server's initial broadcast makes the clients' start exact (ref
AsyncEA.lua:150-160).  Each role is also a function of its parsed flags
(:func:`run_server`, :func:`run_client`, :func:`run_tester`), so a caller
can run the trio as threads of one process.
"""

from __future__ import annotations

import math
import sys
import time

import torch

from distlearn_tpu_torch.data import (PermutationSampler, make_dataset,
                                      synthetic_cifar10, synthetic_mnist)
from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn
from distlearn_tpu_torch.models.core import loss_fn
from distlearn_tpu_torch.parallel.async_ea import (AsyncEAClient,
                                                   AsyncEAServer,
                                                   AsyncEATester)
from distlearn_tpu_torch.train import trainer
from distlearn_tpu_torch.utils import metrics
from distlearn_tpu_torch.utils.flags import (ASYNC_FLAGS, EA_FLAGS,
                                             NODE_FLAGS, TRAIN_FLAGS,
                                             parse_flags)
from distlearn_tpu_torch.utils.logging import (print_client, print_server,
                                               print_tester, set_verbose)
from distlearn_tpu_torch.utils.platform import resolve_device

DATA_FLAGS = {
    "numExamples": (2048, "synthetic dataset size"),
    "model": ("cifar", "model family: cifar (reference convnet) | mnist"),
}

ROLE_FLAGS = {
    "server": {
        "numSyncs": (0, "total syncs to serve (0 = numEpochs*steps/tau "
                        "per node)"),
        "tester": (False, "open the test channel and expect a tester"),
        "syncTimeout": (0.0, "max seconds to wait for any sync request "
                             "before stopping the serve loop (0 = wait "
                             "forever, the reference's behavior)"),
    },
    "client": {},
    "tester": {
        "numTests": (5, "number of test rounds to serve before exiting"),
    },
}


def parse_role(role: str, argv=None):
    """The flags of ``role`` (``server``, ``client`` or ``tester``)."""
    return parse_flags(f"EASGD {role}.", {
        **NODE_FLAGS, **TRAIN_FLAGS, **EA_FLAGS, **ASYNC_FLAGS, **DATA_FLAGS,
        **ROLE_FLAGS[role]}, argv)


def build_model_and_data(opt, partition: int = 0, partitions: int = 1):
    """Model, params on the role's device, and partitioned synthetic data
    (ref Model.lua / Data.lua).  ``--model cifar`` is the reference's
    convnet; ``--model mnist`` the cheap CNN."""
    synth = synthetic_cifar10 if opt.model == "cifar" else synthetic_mnist
    x, y, nc = synth(opt.numExamples, seed=opt.seed)
    ds = make_dataset(x, y, nc, partition=partition, partitions=partitions)
    model = cifar_convnet() if opt.model == "cifar" else mnist_cnn()
    params, mstate = model.init(opt.seed, resolve_device(opt.device))
    return model, params, mstate, ds, nc


def _codec(opt):
    return None if opt.wireCodec == "legacy" else opt.wireCodec


def run_server(opt) -> dict:
    """Serve the expected number of syncs, pushing the center to the tester
    every ``testTime`` syncs and once at the end (EASGD_server.lua:118-128).
    Returns ``{"served", "tests"}``."""
    set_verbose(opt.verbose)
    _, params, _, ds, _ = build_model_and_data(opt)
    # Each client trains on its own partition (the last takes the
    # remainder) and syncs every tau of its continuously counted steps, so
    # the server expects sum_i (numEpochs * steps_i) // tau handshakes.
    per = ds.size // opt.numNodes
    sizes = [per] * (opt.numNodes - 1) + [ds.size - per * (opt.numNodes - 1)]
    num_syncs = opt.numSyncs or sum(
        (opt.numEpochs * (sz // max(1, opt.batchSize)))
        // opt.communicationTime for sz in sizes)
    print_server(f"serving {opt.numNodes} clients, {num_syncs} syncs, "
                 f"tester={opt.tester}")
    srv = AsyncEAServer(opt.host, opt.port, opt.numNodes,
                        with_tester=opt.tester, device=opt.device)
    served = tests = 0
    try:
        srv.init_server(params)
        for i in range(1, num_syncs + 1):
            try:
                params = srv.sync_server(params,
                                         timeout=opt.syncTimeout or None)
            except (TimeoutError, RuntimeError) as e:
                # evicted/finished clients can leave fewer syncs than
                # expected: stop instead of wedging (RuntimeError = every
                # client gone)
                print_server(f"stopping serve loop after {served} syncs: "
                             f"{e!r}")
                break
            served = i
            if opt.tester and i % opt.testTime == 0:
                tests += srv.test_net()
        if opt.tester:
            tests += srv.test_net()     # final eval push
    finally:
        srv.close()
    print_server("done")
    return {"served": served, "tests": tests}


def run_client(opt) -> dict:
    """Local SGD on this node's partition with the sync between the
    gradient and the update (EASGD_client.lua:106-117).  Returns
    ``{"losses", "syncs", "step_ms", "sync_ms"}``: every step's loss, the
    host time of each step without a sync (each step ends reading its loss,
    so the time covers the device work), the host time of each sync, and
    the number of syncs."""
    set_verbose(opt.verbose)
    model, params, mstate, ds, _ = build_model_and_data(
        opt, partition=opt.nodeIndex - 1, partitions=opt.numNodes)
    dev = resolve_device(opt.device)
    client = AsyncEAClient(opt.host, opt.port, node=opt.nodeIndex,
                           tau=opt.communicationTime, alpha=opt.alpha,
                           codec=_codec(opt), device=dev)
    losses, step_ms, sync_ms = [], [], []
    try:
        params = client.init_client(params)
        rng = torch.Generator(device=dev).manual_seed(
            opt.seed + opt.nodeIndex)
        for epoch in range(1, opt.numEpochs + 1):
            sampler = PermutationSampler(ds.size, seed=opt.seed + epoch)
            for idx in sampler.epoch(opt.batchSize):
                x = torch.from_numpy(ds.x[idx]).to(dev)
                y = torch.from_numpy(ds.y[idx]).to(dev)
                t0 = time.perf_counter()
                loss, _, mstate, grads = trainer.value_and_grad(
                    model, params, mstate, x, y, rng, None)
                # sync BETWEEN grads and update (EASGD_client.lua:109, :113)
                t1 = time.perf_counter()
                params, synced = client.sync_client(params)
                t_sync = time.perf_counter() - t1
                params, _ = trainer.local_update(
                    params, grads, None, opt.learningRate, 0.0)
                losses.append(float(loss))
                if synced:
                    sync_ms.append(t_sync * 1e3)
                    print_client(opt.nodeIndex, f"step {len(losses)} loss "
                                 f"{losses[-1]:.4f} (synced)")
                else:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        client.close()
    print_client(opt.nodeIndex, "done")
    return {"losses": losses, "syncs": len(sync_ms), "step_ms": step_ms,
            "sync_ms": sync_ms}


def run_tester(opt) -> dict:
    """Evaluate every center the server pushes on the train and test sets
    (EASGD_tester.lua:40-47,161-165).  Returns ``{"rounds": [...]}``, one
    ``{"round", "train_error", "test_error"}`` per push."""
    set_verbose(True)
    model, params, mstate, ds, nc = build_model_and_data(opt)
    synth = synthetic_cifar10 if opt.model == "cifar" else synthetic_mnist
    xte, yte, _ = synth(max(256, opt.numExamples // 4), seed=opt.seed + 1)
    ds_test = make_dataset(xte, yte, nc)
    dev = resolve_device(opt.device)

    @torch.no_grad()
    def error_rate(p, dset):
        cm = metrics.init_confusion(nc, dev)
        for idx in PermutationSampler(dset.size, seed=0).epoch(
                opt.batchSize):
            x = torch.from_numpy(dset.x[idx]).to(dev)
            y = torch.from_numpy(dset.y[idx]).to(dev)
            _, (log_probs, _) = loss_fn(model, p, mstate, x, y, train=False)
            cm = metrics.update_confusion(cm, log_probs, y)
        return 1.0 - metrics.total_valid(cm)

    # the tester's advertisement only works against a same-version server:
    # "legacy" (or raw against old fleets) keeps the pre-packed wire
    codec = None if opt.wireCodec in ("legacy", "raw") else opt.wireCodec
    tester = AsyncEATester(opt.host, opt.port, opt.numNodes, codec=codec,
                           device=dev)
    rounds = []
    try:
        for round_i in range(1, opt.numTests + 1):
            params = tester.start_test(params)   # blocks for the push
            train_err = error_rate(params, ds)
            test_err = error_rate(params, ds_test)
            rounds.append({"round": round_i, "train_error": train_err,
                           "test_error": test_err})
            print_tester(f"round {round_i}: train_err={train_err:.4f} "
                         f"test_err={test_err:.4f}")
            tester.finish_test()
    finally:
        tester.close()
    print_tester("done")
    return {"rounds": rounds}


ROLES = {"server": run_server, "client": run_client, "tester": run_tester}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ROLES:
        print(f"usage: python -m distlearn_tpu_torch.examples.easgd "
              f"{{{','.join(ROLES)}}} [flags]", file=sys.stderr)
        return 2
    out = ROLES[argv[0]](parse_role(argv[0], argv[1:]))
    if argv[0] == "client":
        bad = [v for v in out["losses"] if not math.isfinite(v)]
        if bad:
            print(f"non-finite losses: {bad[:5]}", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
