"""The port's multi-process shapes, as real spawned OS processes (the
counterpart of ``tests/test_multihost.py``):

* TCP-tree process-per-node training: the port's ``_tcp_worker`` in
  float64 gives the same sha256 digest as the JAX package's on the same
  seeds, and ``examples/client_remote.py --device cpu`` over the tree and
  the ring ends with the same params digest on every node;
* ``parallel/init.py``: two processes join one gloo group and run
  ``build_sgd_step``; every process ends with the same params.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import test_multihost as jax_multihost  # noqa: E402
from tests.net_util import reserve_port_window  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


def _digest(leaves) -> str:
    flat = np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in leaves])
    return hashlib.sha256(flat.tobytes()).hexdigest()


def _tcp_worker(rank: int, n: int, port: int, q) -> None:
    """``tests/test_multihost.py::_tcp_worker`` on the port, with torch
    float64 leaves."""
    sys.path.insert(0, _REPO)
    torch.set_num_threads(1)
    from distlearn_tpu_torch.comm.tree import LocalhostTree
    from distlearn_tpu_torch.parallel.host_algorithms import TreeAllReduceSGD

    try:
        t = LocalhostTree(rank, n, port)
        sgd = TreeAllReduceSGD(t)
        params = {"w": torch.zeros((8, 4), dtype=torch.float64),
                  "b": torch.zeros((4,), dtype=torch.float64)}
        params = sgd.synchronize_parameters(params)
        rng = np.random.RandomState(100 + rank)
        for _ in range(3 + rank):        # UNEVEN step counts across ranks
            grads = {"w": torch.from_numpy(rng.randn(8, 4)),
                     "b": torch.from_numpy(rng.randn(4))}
            g, m = sgd.sum_and_normalize_gradients(grads)
            params = {k: params[k] - 0.1 * g[k] for k in params}
        params = sgd.synchronize_parameters(params)
        t.close()
        q.put(("ok", rank, _digest(p.numpy() for p in params.values())))
    except Exception as e:  # noqa: BLE001 — surface in parent
        q.put(("err", rank, repr(e)))


def toy_model():
    """The toy linear classifier of the JAX ``_spmd_worker``."""
    from distlearn_tpu_torch.models.core import Model

    def init(seed=0, device=None):
        g = torch.Generator().manual_seed(seed)
        params = {"w": torch.randn(16, 10, generator=g) * 0.1,
                  "b": torch.zeros(10)}
        return {k: v.to(device) for k, v in params.items()}, {}

    def apply(params, state, x, train=True, rng=None, tree=None,
              bn_weight=None):
        logits = x.reshape(x.shape[0], -1) @ params["w"] + params["b"]
        return torch.log_softmax(logits, dim=-1), state

    return Model(init=init, apply=apply, name="toy", input_shape=(4, 4, 1),
                 num_classes=10)


def _init_worker(pid: int, nprocs: int, port: int, q) -> None:
    sys.path.insert(0, _REPO)
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        from distlearn_tpu_torch.parallel.init import (global_mesh_tree,
                                                       host_local_batch,
                                                       initialize)
        from distlearn_tpu_torch.train import build_sgd_step, init_train_state
        info = initialize(f"127.0.0.1:{port}", nprocs, pid, device="cpu")
        tree = global_mesh_tree()
        assert tree.num_nodes == info.global_devices == nprocs
        assert info.is_root == (pid == 0) and tree.device.type == "cpu"
        model = toy_model()
        ts = init_train_state(model, tree, 0, 10)
        step = build_sgd_step(model, tree, lr=0.1)
        rs = np.random.RandomState(7)
        gx = rs.randn(8, 4, 4, 1).astype(np.float32)
        gy = rs.randint(0, 10, (8,)).astype(np.int64)
        per = 8 // info.num_processes            # this process's shard
        bx = host_local_batch(tree, gx[pid * per:(pid + 1) * per])
        by = host_local_batch(tree, gy[pid * per:(pid + 1) * per])
        for _ in range(3):
            ts, loss = step(ts, bx, by)
        q.put(("ok", pid, _digest([ts.params[k].numpy()
                                   for k in sorted(ts.params)]),
               float(loss)))
        dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001
        q.put(("err", pid, repr(e)))


def test_tcp_tree_training_digest_matches_jax():
    """The same seeds through the JAX worker and the port's worker: every
    rank of both runs ends with one and the same float64 digest."""
    jax_res = jax_multihost._run_spawned(jax_multihost._tcp_worker, 2,
                                         reserve_port_window(1), timeout=120)
    port_res = jax_multihost._run_spawned(_tcp_worker, 2,
                                          reserve_port_window(1), timeout=120)
    digests = {r[2] for r in jax_res} | {r[2] for r in port_res}
    assert len(digests) == 1, (jax_res, port_res)


def test_initialize_two_gloo_processes():
    res = jax_multihost._run_spawned(_init_worker, 2, reserve_port_window(1),
                                     timeout=120)
    assert len({r[2] for r in res}) == 1, res
    assert len({r[3] for r in res}) == 1
    assert all(np.isfinite(r[3]) for r in res)


@pytest.mark.parametrize("backend", ["tree", "ring"])
def test_client_remote_cpu_digests_agree(backend):
    port = reserve_port_window(1)
    cmd = [sys.executable, "-m", "distlearn_tpu_torch.examples.client_remote",
           "--device", "cpu", "--numNodes", "2", "--port", str(port),
           "--backend", backend, "--numExamples", "256", "--batchSize", "32",
           "--numEpochs", "2", "--communicationTime", "2"]
    procs = [subprocess.Popen(cmd + ["--nodeIndex", str(i)], cwd=_REPO,
                              env=ENV, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in (1, 2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    digests = [re.search(r"final params digest (\w+)", o).group(1)
               for o in outs]
    assert digests[0] == digests[1]
    for i, o in enumerate(outs, 1):
        m = re.search(rf"\[node {i}\] elastic rounds (\d+), fused_elastic "
                      r"launches (\d+)", o)
        assert int(m.group(1)) >= 8              # 4 a epoch, then drains
        assert int(m.group(2)) == 0              # no card here
    losses = [float(v) for v in re.findall(r"mean loss ([\d.]+)", outs[0])]
    assert len(losses) == 2 and all(np.isfinite(losses))
