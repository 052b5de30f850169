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

The JAX scripts' fleet options carry the same names and checks: the server
takes ``--concurrent`` (overlapped per-client workers), ``--shards S``
(striped center), ``--elastic`` (Join?/Leave?; requires ``--concurrent``),
``--centerCkpt DIR --ckptEvery N`` (HA checkpoints, flushed on SIGTERM),
``--standby`` (requires ``--concurrent`` and ``--centerCkpt``, excludes
``--tester``; promotes from the newest checkpoint, or when the primary
named by ``--watchPrimary`` stops answering) and ``--save DIR``; the client
takes ``--overlapSync``, ``--shards 0`` (opt out of stripes),
``--autoRejoin``, ``--centers``, ``--joinFleet``, ``--leaveAfter``,
``--capacity`` and ``--adaptiveTau``.  Two fault drills drive the fleet
paths from the command line: ``--cutAfter N`` (the client drops every
channel mid-handshake after its Nth sync, as a crashed client does, and
recovers through ``--autoRejoin``) and ``--leaveAfterSyncs N`` (a
sync-count ``--leaveAfter``).

Every role builds the SAME model from the SAME seed (ref Model.lua:17) and
the server's initial broadcast makes the clients' start exact (ref
AsyncEA.lua:150-160).  Both models are convnets, which travel in the JAX
package's layout (``CONVNET_WIRE``), so any role can be the JAX package's
example instead.  Each role is also a function of its parsed flags
(:func:`run_server`, :func:`run_client`, :func:`run_tester`), so a caller
can run the trio as threads of one process.
"""

from __future__ import annotations

import math
import sys
import threading
import time

import torch

from distlearn_tpu_torch.data import (PermutationSampler, make_dataset,
                                      synthetic_cifar10, synthetic_mnist)
from distlearn_tpu_torch.models import cifar_convnet, mnist_cnn
from distlearn_tpu_torch.models.convert import CONVNET_WIRE
from distlearn_tpu_torch.models.core import loss_fn
from distlearn_tpu_torch.comm import ProtocolError
from distlearn_tpu_torch.parallel import ha
from distlearn_tpu_torch.parallel.async_ea import (ENTER, ENTER_Q,
                                                   AsyncEAClient,
                                                   AsyncEAServer,
                                                   AsyncEAServerConcurrent,
                                                   AsyncEATester)
from distlearn_tpu_torch.utils import checkpoint as ckpt
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
        "concurrent": (False, "serve clients on overlapped per-client "
                              "worker threads (AsyncEAServerConcurrent) "
                              "instead of the reference's one-at-a-time "
                              "critical section"),
        "centerCkpt": ("", "HA checkpoint directory: checkpoint the center "
                           "and the failover ledger there and flush once "
                           "more on SIGTERM; a --standby tails it"),
        "ckptEvery": (8, "checkpoint the center every N applied syncs "
                         "(with --centerCkpt)"),
        "standby": (False, "start as a warm standby (requires --concurrent "
                           "and --centerCkpt): bind listeners, admit "
                           "nobody, promote into the next center epoch "
                           "from the newest checkpoint, then serve "
                           "rejoining clients"),
        "watchPrimary": ("", "standby only: probe this primary (host:port "
                             "or port) and promote when it stops "
                             "answering, instead of on the first "
                             "checkpoint seen"),
        "elastic": (False, "admit Join?/Leave? membership changes mid-run "
                           "(requires --concurrent)"),
    },
    "client": {
        "autoRejoin": (1, "on a failed sync, re-dial and Rejoin? (local "
                          "params reset to the CURRENT center) instead of "
                          "crashing; 0 = fail fast"),
        "centers": ("", "comma-separated standby centers (host:port or "
                        "port) to fail over to when the primary dies for "
                        "good"),
        "joinFleet": (False, "enter a RUNNING --elastic server through "
                             "Join? (the server assigns the cid) instead of "
                             "the founding admission"),
        "leaveAfter": (0.0, "seconds of training after which this client "
                            "departs through Leave? (0 = train to the "
                            "end)"),
        "leaveAfterSyncs": (0, "depart through Leave? after this many "
                               "syncs (0 = train to the end)"),
        "capacity": (1.0, "advertised capacity weight: an elastic server "
                          "scales this client's deltas by "
                          "cap*N/sum(live caps)"),
        "adaptiveTau": (False, "stretch the effective tau (bounded by "
                               "alpha*tau <= 0.9) when syncs run slower "
                               "than this client's best pace"),
        "cutAfter": (0, "fault drill: after this many syncs, announce "
                        "Enter? and drop every channel (the server evicts "
                        "this client), then recover through --autoRejoin "
                        "(0 = off)"),
    },
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


def _check_server_flags(opt) -> None:
    if opt.elastic and not opt.concurrent:
        raise SystemExit("--elastic requires --concurrent")
    if opt.standby and not (opt.concurrent and opt.centerCkpt):
        raise SystemExit("--standby requires --concurrent and --centerCkpt")
    if opt.standby and opt.tester:
        raise SystemExit("--standby is incompatible with --tester "
                         "(no test channel is accepted pre-promotion)")


def _enable_ha(srv, opt) -> None:
    """``--centerCkpt``: periodic checkpoints, and the SIGTERM flush where
    the role runs on the main thread (the signal module's rule)."""
    srv.enable_checkpoint(opt.centerCkpt, every=max(1, opt.ckptEvery))
    if threading.current_thread() is threading.main_thread():
        ha.install_signal_flush(srv)


def run_server(opt, on_serving=None) -> dict:
    """Serve the expected number of syncs, pushing the center to the tester
    every ``testTime`` syncs and once at the end (EASGD_server.lua:118-128).
    ``on_serving(srv)`` is called once the server serves (for callers
    running the roles as threads).  Returns ``{"served", "tests"}``, and
    for ``--concurrent`` the fleet's state at the end: ``members``,
    ``evicted``, the exactly-once ``ledger`` (per member, the newest
    applied sync seq of each stripe) and the capacity ``weights``."""
    set_verbose(opt.verbose)
    _check_server_flags(opt)
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
    if opt.concurrent:
        return _serve_concurrent(opt, params, num_syncs, on_serving)
    srv = AsyncEAServer(opt.host, opt.port, opt.numNodes,
                        with_tester=opt.tester, shards=max(1, opt.shards),
                        device=opt.device, layout=CONVNET_WIRE)
    served = tests = 0
    try:
        srv.init_server(params)
        if opt.centerCkpt:
            _enable_ha(srv, opt)
        if on_serving is not None:
            on_serving(srv)
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
            if opt.save and i % (opt.testTime * 2) == 0:
                ckpt.save_checkpoint(opt.save, i, {"center": params})
        if opt.tester:
            tests += srv.test_net()     # final eval push
        if opt.save:
            ckpt.save_checkpoint(opt.save, served, {"center": params})
    finally:
        srv.close()
    print_server("done")
    return {"served": served, "tests": tests}


def _serve_concurrent(opt, params, num_syncs: int, on_serving) -> dict:
    """The concurrent server's loop (the JAX script's): workers serve; this
    thread watches the count, pushes tester rounds and checkpoints, and
    stops when the fleet drains, goes idle for ``--syncTimeout`` or has
    been served ``num_syncs`` syncs."""
    srv = AsyncEAServerConcurrent(opt.host, opt.port, opt.numNodes,
                                  with_tester=opt.tester,
                                  shards=max(1, opt.shards),
                                  standby=opt.standby, elastic=opt.elastic,
                                  device=opt.device, layout=CONVNET_WIRE)
    tests = 0
    try:
        if opt.standby:
            sb = ha.StandbyCenter(srv, opt.centerCkpt, params)
            if opt.watchPrimary:
                h, _, pp = opt.watchPrimary.rpartition(":")
                h = h or opt.host
                print_server(f"standby: watching primary {h}:{pp}, "
                             f"tailing {opt.centerCkpt}")
                params = sb.watch(lambda: ha.tcp_probe(h, int(pp)))
            else:
                print_server("standby: waiting for a checkpoint in "
                             f"{opt.centerCkpt}")
                sb.wait_for_checkpoint()
                params = sb.promote()
        else:
            srv.init_server(params)
        if opt.centerCkpt:
            _enable_ha(srv, opt)
        srv.start()
        if on_serving is not None:
            on_serving(srv)
        if opt.standby:
            # rejoining clients arrive through the dispatcher's grace poll
            deadline = time.monotonic() + (opt.syncTimeout or 60.0)
            while srv.live_clients == 0 and time.monotonic() < deadline:
                time.sleep(0.05)
        tests_pushed = last_save = last_done = 0
        last_progress = time.monotonic()
        while srv.syncs_completed < num_syncs and srv.live_clients > 0:
            if srv.drained:
                print_server(f"stopping after {srv.syncs_completed} syncs "
                             "(all clients done)")
                break
            done = srv.syncs_completed
            if done > last_done:            # idle timeout: progress resets
                last_done = done
                last_progress = time.monotonic()
            if opt.syncTimeout and \
                    time.monotonic() - last_progress > opt.syncTimeout:
                print_server(f"stopping after {done} syncs (no sync for "
                             f"{opt.syncTimeout:g}s)")
                break
            if opt.tester and done // opt.testTime > tests_pushed:
                tests_pushed += 1
                tests += srv.test_net()
            if opt.save and done - last_save >= opt.testTime * 2:
                last_save = done
                ckpt.save_checkpoint(opt.save, done,
                                     {"center": srv.current_center(params)})
            time.sleep(0.01)
        params = srv.current_center(params)
        served = srv.syncs_completed
        if opt.tester:
            # the serial loop's push count: one per testTime syncs plus
            # the final eval push
            while tests_pushed < served // opt.testTime:
                tests_pushed += 1
                tests += srv.test_net()
            tests += srv.test_net()
        if opt.save:
            ckpt.save_checkpoint(opt.save, served, {"center": params})
        live = sorted(srv.members - srv.evicted)
        with srv._lock:
            ledger = {c: list(v) for c, v in srv._applied_seq.items()}
        out = {"served": served, "tests": tests,
               "members": sorted(srv.members), "evicted": sorted(srv.evicted),
               "ledger": ledger,
               "weights": {c: srv._delta_weight(c) for c in live}}
    finally:
        try:
            srv.stop()      # re-raises a server thread's failure
        finally:
            srv.close()
    print_server("done")
    return out


def _parse_centers(opt) -> list[tuple[str, int]]:
    centers = []
    for tok in opt.centers.split(","):
        tok = tok.strip()
        if tok:
            h, _, pp = tok.rpartition(":")
            centers.append((h or opt.host, int(pp)))
    return centers


def _drop_channels(client: AsyncEAClient) -> None:
    """The ``--cutAfter`` drill: announce ``Enter?``, then drop every
    channel mid-handshake (a crashed client); the server evicts the cid,
    and the next sync fails into the recovery path."""
    if client._sender is not None:
        client._sender.flush()
    try:
        client._announce(ENTER_Q, ENTER)
    except (OSError, ProtocolError):
        pass
    for c in (client.broadcast, client.conn, *client._shard_conns):
        c.close()
    time.sleep(0.5)         # let the eviction land before the rejoin


def run_client(opt, before_dial=None) -> dict:
    """Local SGD on this node's partition with the sync between the
    gradient and the update (EASGD_client.lua:106-117).  Returns
    ``{"losses", "syncs", "step_ms", "sync_ms", "node", "left",
    "recoveries", "failures", "seq", "train_s"}``: every step's loss, the
    host time of each step without a sync (each step ends reading its
    loss, so the time covers the device work), the host time of each sync,
    the number of syncs, the client's final cid, whether it left through
    ``Leave?``, how many failed syncs it recovered from and their errors,
    the sequence number of its last
    sync (what the server's ledger records) and the seconds of its training
    loop.  ``before_dial()`` is called once the model and data are built,
    before the first dial (for callers running the roles as threads: a
    joiner waits for the server there)."""
    set_verbose(opt.verbose)
    # a joiner's nodeIndex may run past the founding fleet: wrap it onto a
    # partition
    model, params, mstate, ds, _ = build_model_and_data(
        opt, partition=(opt.nodeIndex - 1) % opt.numNodes,
        partitions=opt.numNodes)
    dev = resolve_device(opt.device)
    codec = _codec(opt)
    centers = _parse_centers(opt)
    if before_dial is not None:
        before_dial()
    if opt.joinFleet:
        client, params = AsyncEAClient.join(
            opt.host, opt.port, params, opt.communicationTime, opt.alpha,
            capacity=opt.capacity, codec=codec, overlap=opt.overlapSync,
            sharded=opt.shards != 0, adaptive_tau=opt.adaptiveTau,
            centers=centers or None, device=dev, layout=CONVNET_WIRE)
    else:
        client = AsyncEAClient(opt.host, opt.port, node=opt.nodeIndex,
                               tau=opt.communicationTime, alpha=opt.alpha,
                               codec=codec, overlap=opt.overlapSync,
                               sharded=opt.shards != 0,
                               capacity=opt.capacity,
                               adaptive_tau=opt.adaptiveTau,
                               centers=centers or None, device=dev,
                               layout=CONVNET_WIRE)
        params = client.init_client(params)
    losses, step_ms, sync_ms = [], [], []
    left, synced_seq, failures = False, 0, []
    try:
        rng = torch.Generator(device=dev).manual_seed(
            opt.seed + opt.nodeIndex)
        t_start = time.monotonic()
        for epoch in range(1, opt.numEpochs + 1):
            if left:
                break
            sampler = PermutationSampler(ds.size, seed=opt.seed + epoch)
            for idx in sampler.epoch(opt.batchSize):
                if ((opt.leaveAfter
                     and time.monotonic() - t_start >= opt.leaveAfter)
                        or (opt.leaveAfterSyncs
                            and len(sync_ms) >= opt.leaveAfterSyncs)):
                    print_client(client.node, f"leave drill: departing "
                                 f"after {len(losses)} steps")
                    client.leave()
                    left = True
                    break
                x = torch.from_numpy(ds.x[idx]).to(dev)
                y = torch.from_numpy(ds.y[idx]).to(dev)
                t0 = time.perf_counter()
                loss, _, mstate, grads = trainer.value_and_grad(
                    model, params, mstate, x, y, rng, None)
                losses.append(float(loss))
                # sync BETWEEN grads and update (EASGD_client.lua:109, :113)
                t1 = time.perf_counter()
                try:
                    params, synced = client.sync_client(params)
                except (OSError, ProtocolError) as e:
                    # an evicted/cut client is not dead: re-admit at the
                    # CURRENT center, and skip this step's update (its
                    # gradient was taken at the params the reset dropped)
                    if not opt.autoRejoin:
                        raise
                    failures.append(repr(e))
                    print_client(client.node,
                                 f"sync failed ({e!r}); rejoining")
                    try:
                        params = client.rejoin(params,
                                               retries=6 if centers else 60)
                    except (OSError, ProtocolError):
                        # the center itself is gone: walk the dial list
                        # (local params and residuals survive this path)
                        params = client.failover(params)
                    continue
                t_sync = time.perf_counter() - t1
                params, _ = trainer.local_update(
                    params, grads, None, opt.learningRate, 0.0)
                if synced:
                    sync_ms.append(t_sync * 1e3)
                    synced_seq = client._seq
                    print_client(client.node, f"step {len(losses)} loss "
                                 f"{losses[-1]:.4f} (synced)")
                    if opt.cutAfter and len(sync_ms) == opt.cutAfter:
                        _drop_channels(client)
                else:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        if not left:                # leave() closed every channel
            client.close()
    print_client(client.node, "done")
    return {"losses": losses, "syncs": len(sync_ms), "step_ms": step_ms,
            "sync_ms": sync_ms, "node": client.node, "left": left,
            "recoveries": len(failures), "failures": failures,
            "seq": synced_seq,
            "train_s": time.monotonic() - t_start}


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
                           device=dev, layout=CONVNET_WIRE)
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
