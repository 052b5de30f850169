"""The port's collective backends against the JAX package's
(``tests/test_backend.py`` replayed on the port, on the CPU):

* chunk planning and the staging frame;
* the protocol surface and value conventions of ``HostBackend``,
  ``MeshBackend`` and ``HybridBackend`` (plain vs stacked rows,
  ``node_offset``, rider and ``contrib``);
* the row sum bit for bit the JAX package's ``MeshBackend`` psum (seeded,
  non-dyadic float32 rows), the hybrid with one host bit for bit the mesh,
  two hosts over the tree and the ring, and in int8 bit for bit the JAX
  package's hybrid;
* THE invariant: one EASGD trajectory bit for bit across the port's three
  backends and the JAX package's mesh (dyadic-exact float64);
* ``AllReduceSGD``'s winner scatter across hosts, and a FaultPlan partition
  surfacing the raw tree's typed error through the hybrid's host leg;
* the AsyncEA slice client: one push for L rows, and mixed port/JAX slice
  fleets bit for bit the all-JAX center;
* ``examples/sync_backends.py``: every port backend prints the JAX
  example's digest.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu.comm import backend as jb  # noqa: E402
from distlearn_tpu.comm.tree import tree_map_spawn as jspawn  # noqa: E402
from distlearn_tpu.parallel import allreduce_ea as jea_ar  # noqa: E402
from distlearn_tpu_torch.comm import backend as pb  # noqa: E402
from distlearn_tpu_torch.comm.faults import FaultPlan  # noqa: E402
from distlearn_tpu_torch.comm.tree import (LocalhostTree,  # noqa: E402
                                           tree_map_spawn)
from distlearn_tpu_torch.examples import sync_backends  # noqa: E402
from distlearn_tpu_torch.parallel.allreduce_ea import AllReduceEA  # noqa: E402
from distlearn_tpu_torch.parallel.allreduce_sgd import (  # noqa: E402
    AllReduceSGD)

from tests import torch_async_util as U  # noqa: E402
from tests.net_util import reserve_port_window  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port() -> int:
    return reserve_port_window(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _jax_devices(local: int, hosts: int = 2):
    import jax
    devs = jax.devices()
    return [devs[h * local:(h + 1) * local] for h in range(hosts)]


# ------------------------------------------------------------ chunk planning

@pytest.mark.parametrize("total,parts", [(16, 4), (10, 4), (3, 8), (5, 1),
                                         (0, 3)])
def test_plan_chunks_matches_jax(total, parts):
    assert pb.plan_chunks(total, parts) == jb.plan_chunks(total, parts)
    padded, spans = pb.plan_chunks(total, parts)
    assert padded % parts == 0 and spans[-1][1] == padded
    assert all(hi - lo == padded // parts for lo, hi in spans)


def test_plan_chunks_rejects_bad_sizes():
    with pytest.raises(ValueError):
        pb.plan_chunks(4, 0)
    with pytest.raises(ValueError):
        pb.plan_chunks(-1, 2)


def test_stage_into_roundtrip_mixed_dtypes():
    from distlearn_tpu_torch.comm.wire import FrameBuffer
    from distlearn_tpu_torch.ops.staging import stage_into

    fb = FrameBuffer()
    a = torch.arange(7, dtype=torch.float32)
    b = np.arange(5, dtype=np.int64) * -3
    views = stage_into(fb, [a, b], [np.float32, np.int64])
    np.testing.assert_array_equal(views[0], a.numpy())
    np.testing.assert_array_equal(views[1], b)
    # windows are 16-byte aligned: a is 28 bytes, so b's starts at 32
    assert views[1].ctypes.data - views[0].ctypes.data == 32


# ------------------------------------------------------------ protocol

def test_all_backends_satisfy_protocol():
    mesh = pb.MeshBackend(4, device="cpu")
    hybrid = pb.HybridBackend(0, 1, num_devices=4, device="cpu")
    for b in (mesh, hybrid):
        assert isinstance(b, pb.CollectiveBackend)
        assert b.stacked_nodes == 4 and b.node_offset == 0
    port = _port()

    def node(rank):
        b = pb.HostBackend(LocalhostTree(rank, 2, port))
        ok = isinstance(b, pb.CollectiveBackend)
        off = b.node_offset
        b.close()
        return ok, off, b.stacked_nodes
    for rank, (ok, off, stacked) in enumerate(tree_map_spawn(node, 2)):
        assert ok and off == rank and stacked is None


def test_backends_without_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.MeshBackend(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.HybridBackend(0, 1, num_devices=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sync_backends.main(["--backend", "mesh"])


# ------------------------------------------------------------ host adapter

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("transport", ["tree", "ring"])
def test_host_backend_matches_raw_handle_and_scatter_src(kind, transport):
    """Sum, rider and contrib as the raw handle's; scatter(src != 0)
    selects the source's values bit for bit on every rank."""
    n, port = 4, _port()
    vals = [np.arange(6, dtype=np.float64).reshape(2, 3) * (r + 1)
            for r in range(n)]
    conv = _t if kind == "tensor" else np.array

    def node(rank):
        b = pb.HostBackend.create(rank, n, "127.0.0.1", port,
                                  transport=transport)
        red, m, rid = b.all_reduce_ex({"v": conv(vals[rank])}, rider=rank)
        masked, m2 = b.all_reduce({"v": conv(vals[rank])},
                                  contrib=(rank != 1))
        sc = b.scatter({"v": conv(vals[rank])}, src=2)
        b.barrier()
        b.close()
        return red["v"], m, rid, masked["v"], m2, sc["v"]

    expect = np.sum(vals, axis=0)
    for red, m, rid, masked, m2, sc in tree_map_spawn(node, n):
        np.testing.assert_array_equal(U.as_np(red), expect)
        assert (m, rid) == (n, sum(range(n)))
        np.testing.assert_array_equal(U.as_np(masked), expect - vals[1])
        assert m2 == n - 1
        np.testing.assert_array_equal(U.as_np(sc), vals[2])


def test_host_backend_rejects_unknown_transport():
    with pytest.raises(ValueError, match="unknown host transport"):
        pb.HostBackend.create(0, 1, "127.0.0.1", 0, transport="mesh")


# ------------------------------------------------------------ mesh backend

@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_backend_row_sum_bitwise_the_jax_psum(n):
    """Seeded float32 rows (not dyadic): the port's row sum, with and
    without a contrib mask, is bit for bit the JAX package's psum."""
    rng = np.random.default_rng(n)
    rows = {"w": rng.standard_normal((n, 33)).astype(np.float32) * 3.7,
            "b": rng.standard_normal((n, 5)).astype(np.float32)}
    jm, pm = jb.MeshBackend(num_nodes=n), pb.MeshBackend(n, device="cpu")
    cvec = np.ones(n, bool)
    cvec[n // 2] = False
    for contrib in (True, cvec):
        jred, jn = jm.all_reduce(rows, contrib=contrib)
        pred, pn = pm.all_reduce({k: _t(v) for k, v in rows.items()},
                                 contrib=contrib)
        assert jn == pn
        for k in rows:
            want = np.asarray(jm.node_slice(jred, 0)[k])
            for i in range(n):        # every row holds the sum
                U.assert_bitwise([pm.node_slice(pred, i)[k]], [want])


def test_mesh_backend_stacked_allreduce_rider_and_contrib():
    n = 8
    b = pb.MeshBackend(n, device="cpu")
    rows = torch.arange(n * 5, dtype=torch.float64).reshape(n, 5)
    red, m, rid = b.all_reduce_ex({"w": rows}, rider=3)
    assert m == n and rid == 3 * n      # the rider counts per logical node
    assert torch.equal(b.node_slice(red, 0)["w"], rows.sum(0))
    cvec = np.ones(n, bool)
    cvec[2] = False
    red, m = b.all_reduce({"w": rows}, contrib=cvec)
    assert m == n - 1
    assert torch.equal(b.node_slice(red, 5)["w"], rows.sum(0) - rows[2])
    sc = b.scatter({"w": rows}, src=6)
    assert all(torch.equal(r, rows[6]) for r in sc["w"])
    with pytest.raises(NotImplementedError):
        b.all_reduce({"w": rows}, op="max")
    with pytest.raises(ValueError, match="rows"):
        b.all_reduce({"w": rows[:3]})
    with pytest.raises(ValueError, match="contrib mask"):
        b.all_reduce({"w": rows}, contrib=np.ones(3))


def test_mesh_backend_passthroughs():
    b = pb.MeshBackend(3, device="cpu")
    rep = b.replicate({"w": torch.arange(4.0)})
    assert rep["w"].shape == (3, 4) and rep["w"].is_contiguous()
    assert torch.equal(b.node_slice(rep, 2)["w"], torch.arange(4.0))
    put = b.put_per_node({"w": np.zeros((3, 2), np.float32)})
    assert isinstance(put["w"], torch.Tensor)
    with pytest.raises(ValueError, match="leading axis"):
        b.put_per_node({"w": np.zeros((2, 2))})


# ------------------------------------------------------------ hybrid: 1 host

def test_hybrid_single_host_matches_mesh_bitwise():
    """No host leg: the hybrid's padded row sum is bit for bit the mesh's
    (dyadic-exact values, as in the JAX test, and mixed dtypes)."""
    n = 8
    mesh = pb.MeshBackend(n, device="cpu")
    hyb = pb.HybridBackend(0, 1, num_devices=n, device="cpu")
    assert hyb.num_nodes == n and hyb.host_leg is None
    val = {"w": torch.arange(n * 16, dtype=torch.float64).reshape(n, 16)
           * 0.5,
           "b": (torch.arange(n * 3) % 5).to(torch.float64).reshape(n, 3),
           "i": (torch.arange(n * 5) % 9).reshape(n, 5)}
    m_red, m_n = mesh.all_reduce(val)
    h_red, h_n = hyb.all_reduce(val)
    assert m_n == h_n == n
    for k in val:
        U.assert_bitwise([h_red[k]], [m_red[k]])
    _, m, rid = hyb.all_reduce_ex(val, rider=2)
    assert (m, rid) == (n, 2 * n)
    cvec = np.ones(n, bool)
    cvec[3] = False
    red, m = hyb.all_reduce(val, contrib=cvec)
    assert m == n - 1
    assert torch.equal(hyb.node_slice(red, 0)["w"],
                       val["w"].sum(0) - val["w"][3])


def test_hybrid_single_device_degenerate():
    hyb = pb.HybridBackend(0, 1, num_devices=1, device="cpu")
    assert hyb.num_nodes == 1 and hyb.stacked_nodes == 1
    val = {"w": torch.arange(4, dtype=torch.float64)[None]}
    red, m = hyb.all_reduce(val)
    assert m == 1
    assert torch.equal(hyb.node_slice(red, 0)["w"], val["w"][0])


def test_hybrid_rejects_bad_configs():
    with pytest.raises(ValueError, match="out of range"):
        pb.HybridBackend(2, 2, device="cpu")
    with pytest.raises(ValueError, match="codec"):
        pb.HybridBackend(0, 1, device="cpu", codec="bf8")
    with pytest.raises(ValueError, match="coordinator"):
        pb.HybridBackend(0, 2, device="cpu")


# ------------------------------------------------------------ hybrid: 2 hosts

@pytest.mark.parametrize("transport", ["tree", "ring"])
def test_hybrid_two_hosts_allreduce_rider_scatter(transport):
    """The whole pipeline across a real TCP leg: mixed-dtype leaves reduce
    exactly; count and rider cover all H*L logical nodes; scatter from a
    row of the OTHER host replicates bit for bit."""
    hosts, local = 2, 2
    n = hosts * local
    port = _port()
    rows_w = np.arange(n * 8, dtype=np.float64).reshape(n, 8) * 0.25
    rows_i = (np.arange(n * 4) % 9).astype(np.int64).reshape(n, 4)

    def node(rank):
        b = pb.HybridBackend(rank, hosts, "127.0.0.1", port,
                             num_devices=local, device="cpu",
                             transport=transport)
        lo = b.node_offset
        val = {"w": _t(rows_w[lo:lo + local]), "i": _t(rows_i[lo:lo + local])}
        red, m, rid = b.all_reduce_ex(val, rider=lo + 1)
        sc = b.scatter(val, src=3)          # host 1's second row
        bytes_leg = b.host_leg.nic_bytes()
        b.barrier()
        b.close()
        return red, m, rid, sc, bytes_leg

    for red, m, rid, sc, bytes_leg in tree_map_spawn(node, hosts,
                                                     timeout=120):
        for i in range(local):
            np.testing.assert_array_equal(red["w"][i].numpy(),
                                          rows_w.sum(0))
            np.testing.assert_array_equal(red["i"][i].numpy(),
                                          rows_i.sum(0))
            np.testing.assert_array_equal(sc["w"][i].numpy(), rows_w[3])
        assert m == n
        assert rid == (0 + 1) * local + (local + 1) * local
        assert bytes_leg > 0


def _hybrid_rounds(pkg, codec, rows, hosts=2, local=2, rounds=3):
    """``rounds`` hybrid allreduces of seeded float32 rows (each round's
    input the last result plus the rows) on ``pkg``; host 0's row 0."""
    port = _port()
    devs = _jax_devices(local, hosts) if pkg == "jax" else None

    def node(rank):
        if pkg == "jax":
            b = jb.HybridBackend(rank, hosts, "127.0.0.1", port,
                                 devices=devs[rank], codec=codec)
        else:
            b = pb.HybridBackend(rank, hosts, "127.0.0.1", port,
                                 num_devices=local, device="cpu",
                                 codec=codec)
        lo = b.node_offset
        mine = rows[lo:lo + local]
        val = {"a": mine * 1, "b": mine[:, :7] * 2}
        out = []
        for _ in range(rounds):
            if pkg == "port":
                val = {k: _t(np.asarray(v)) for k, v in val.items()}
            red, _ = b.all_reduce(val)
            got = {k: np.asarray(b.node_slice(red, 0)[k]) for k in red}
            out.append([got["a"], got["b"]])
            val = {k: np.asarray(got[k])[None] + val_k for k, val_k in
                   (("a", mine), ("b", mine[:, :7]))}
        b.close()
        return out

    spawn = jspawn if pkg == "jax" else tree_map_spawn
    return spawn(node, hosts, timeout=120)[0]


@pytest.mark.parametrize("codec", ["raw", "int8", "fp16"])
def test_hybrid_codec_rounds_bitwise_the_jax_hybrid(codec):
    """Two hosts of two rows, seeded float32 (not dyadic): every round's
    reduced rows bit for bit the JAX package's hybrid, through the lossy
    host codecs too (one scale a dtype group, as the JAX host leg)."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((4, 301)).astype(np.float32)
    got = _hybrid_rounds("port", codec, rows)
    want = _hybrid_rounds("jax", codec, rows)
    for g, w in zip(got, want):
        U.assert_bitwise(g, w)


# ------------------------------------------------------------ EASGD parity

_N, _ROUNDS, _ALPHA, _DIM = 4, 24, 0.5, 24


def _grad(rank: int, r: int) -> torch.Tensor:
    """Integer-valued deterministic per-node 'gradient' (dyadic-exact)."""
    return (torch.arange(_DIM, dtype=torch.float64) % 5 + 3 * rank + r) * 1.0


def _easgd_trajectory(backend, local: int) -> np.ndarray:
    ea = AllReduceEA(backend, tau=1, alpha=_ALPHA)
    lo = backend.node_offset
    traj = []
    if backend.stacked_nodes is None:
        params = torch.zeros(_DIM, dtype=torch.float64)
        for r in range(_ROUNDS):
            params = ea.average_parameters(params - _grad(lo, r))
            traj.append(params.numpy().copy())
    else:
        params = torch.zeros((local, _DIM), dtype=torch.float64)
        for r in range(_ROUNDS):
            params = torch.stack([params[i] - _grad(lo + i, r)
                                  for i in range(local)])
            params = ea.average_parameters(params)
            traj.append(params[0].numpy().copy())
    return np.stack(traj)


def _jax_mesh_trajectory() -> np.ndarray:
    ea = jea_ar.AllReduceEA(jb.MeshBackend(num_nodes=_N), tau=1,
                            alpha=_ALPHA)
    params = np.zeros((_N, _DIM), np.float64)
    traj = []
    for r in range(_ROUNDS):
        params = np.stack([params[i] - _grad(i, r).numpy()
                           for i in range(_N)])
        params = ea.average_parameters(params)
        traj.append(np.asarray(params, np.float64)[0].copy())
    return np.stack(traj)


def test_easgd_trajectory_bitwise_identical_across_backends():
    """THE invariant: the same EASGD run over MeshBackend, HostBackend (4
    TCP tree ranks) and HybridBackend (2 hosts x 2 rows) gives bit for bit
    the same trajectory, and the JAX package's mesh trajectory."""
    mesh_traj = _easgd_trajectory(pb.MeshBackend(_N, device="cpu"), _N)
    port = _port()

    def host_node(rank):
        b = pb.HostBackend(LocalhostTree(rank, _N, port))
        traj = _easgd_trajectory(b, 1)
        b.close()
        return traj
    host_trajs = tree_map_spawn(host_node, _N, timeout=120)
    port2 = _port()

    def hybrid_node(rank):
        b = pb.HybridBackend(rank, 2, "127.0.0.1", port2, num_devices=2,
                             device="cpu")
        traj = _easgd_trajectory(b, 2)
        b.close()
        return traj
    hybrid_trajs = tree_map_spawn(hybrid_node, 2, timeout=120)
    np.testing.assert_array_equal(mesh_traj, host_trajs[0])
    np.testing.assert_array_equal(mesh_traj, hybrid_trajs[0])
    np.testing.assert_array_equal(mesh_traj, _jax_mesh_trajectory())
    assert not np.array_equal(mesh_traj[0], np.zeros(_DIM))


def test_allreduce_ea_stacked_sync_center_and_params():
    """On a stacked handle the center and the params sync from node 0's
    row, and a per-row contrib mask gates the due check."""
    b = pb.MeshBackend(3, device="cpu")
    ea = AllReduceEA(b, tau=2, alpha=0.5)
    p = torch.arange(6, dtype=torch.float64).reshape(3, 2)
    assert ea.average_parameters(p, contrib=[1, 0, 1]) is p   # steps 1, 0, 1
    moved = ea.average_parameters(p + 1.0)                    # row 0 due
    assert not torch.equal(moved, p + 1.0)
    ea.synchronize_center(moved)
    assert all(torch.equal(c, ea._center[0]) for c in ea._center)
    synced = ea.synchronize_parameters(moved)
    assert all(torch.equal(r, moved[0]) for r in synced)
    assert (ea._steps == 0).all()


def test_allreduce_sgd_winner_scatter_across_hosts():
    """synchronize_parameters picks the GLOBAL most-stepped node when the
    step counts live on different hosts of a hybrid slice (the stacked
    step allreduce and the cross-host scatter)."""
    hosts, local = 2, 2
    port = _port()

    def node(rank):
        b = pb.HybridBackend(rank, hosts, "127.0.0.1", port,
                             num_devices=local, device="cpu")
        sgd = AllReduceSGD(b)
        params = {"w": torch.full((local, 4), float(b.node_offset),
                                  dtype=torch.float64)}
        sgd._bump(True)                     # every node steps once
        if rank == 1:
            sgd._bump(np.array([0, 1]))     # logical node 3 pulls ahead
        out = sgd.synchronize_parameters(params)
        b.close()
        return out["w"]

    for w in tree_map_spawn(node, hosts, timeout=120):
        assert torch.equal(w, torch.full((local, 4), 2.0,
                                         dtype=torch.float64))


def _sgd_run(pkg, backend, grads, steps):
    """Summed and normalised gradients, then the winner sync, of
    ``AllReduceSGD`` on ``pkg``'s ``backend`` (node 0's view)."""
    from distlearn_tpu.comm.tree import LocalhostTree as JTree
    from distlearn_tpu.parallel.allreduce_sgd import AllReduceSGD as JSGD
    n = len(steps)
    conv = _t if pkg == "port" else np.array
    cls = AllReduceSGD if pkg == "port" else JSGD
    if backend == "mesh":
        b = pb.MeshBackend(n, device="cpu") if pkg == "port" \
            else jb.MeshBackend(num_nodes=n)
        sgd = cls(b)
        out, m = sgd.sum_and_normalize_gradients({"g": conv(grads)})
        for k in range(max(steps) - 1):
            sgd._bump(np.array([int(s > k + 1) for s in steps]))
        synced = sgd.synchronize_parameters({"g": conv(grads)})
        return (U.as_np(b.node_slice(out, 0)["g"]), m,
                U.as_np(b.node_slice(synced, 1)["g"]))
    port = _port()

    def node(rank):
        b = pb.HostBackend(LocalhostTree(rank, n, port)) if pkg == "port" \
            else jb.HostBackend(JTree(rank, n, port))
        sgd = cls(b)
        out, m = sgd.sum_and_normalize_gradients({"g": conv(grads[rank])})
        for _ in range(steps[rank] - 1):
            sgd._bump(True)
        synced = sgd.synchronize_parameters({"g": conv(grads[rank])})
        b.close()
        return U.as_np(out["g"]), m, U.as_np(synced["g"])
    res = (tree_map_spawn if pkg == "port" else jspawn)(node, n,
                                                       timeout=120)
    for r in res:                       # every node holds the same bits
        U.assert_bitwise([r[0], r[2]], [res[0][0], res[0][2]])
    return res[0]


@pytest.mark.parametrize("backend", ["mesh", "host"])
def test_allreduce_sgd_on_backends_matches_jax(backend):
    """Summed and normalised gradients and the winner sync over a port
    backend: bit for bit the JAX package's class on its own backend of the
    same topology (seeded float32, not dyadic)."""
    rng = np.random.default_rng(3)
    grads = rng.standard_normal((4, 9)).astype(np.float32)
    steps = [1, 3, 3, 2]                    # last max wins: node 2
    got, m, got_sync = _sgd_run("port", backend, grads, steps)
    want, jm, want_sync = _sgd_run("jax", backend, grads, steps)
    assert m == jm == 4
    U.assert_bitwise([got, got_sync], [want, want_sync])
    U.assert_bitwise([got_sync], [grads[2]])


# ------------------------------------------------------------ faults parity

def _partition_error(run):
    errs = [None, None]

    def node(rank):
        try:
            run(rank)
        except Exception as e:  # noqa: BLE001 — the type IS the assertion
            errs[rank] = type(e)
    tree_map_spawn(node, 2, timeout=120)
    return errs


def test_fault_partition_surfaces_same_error_raw_tree_vs_hybrid():
    """A FaultPlan partition during the hybrid's host leg surfaces the same
    typed error (TimeoutError, via op_timeout) as on a raw Tree."""
    plan_tree = FaultPlan(seed=0)
    plan_tree.partition("tree")
    port = _port()

    def raw_tree(rank):
        t = LocalhostTree(rank, 2, port, op_timeout=1.0,
                          fault_plan=plan_tree)
        try:
            t.all_reduce(np.ones(4, np.float64))
        finally:
            t.close()
    tree_errs = _partition_error(raw_tree)

    plan_hyb = FaultPlan(seed=0)
    plan_hyb.partition("hybrid")
    port2 = _port()

    def hybrid(rank):
        b = pb.HybridBackend(rank, 2, "127.0.0.1", port2, num_devices=1,
                             device="cpu", op_timeout=1.0,
                             fault_plan=plan_hyb)
        try:
            b.all_reduce({"w": torch.ones((1, 4), dtype=torch.float64)})
        finally:
            b.close()
    hyb_errs = _partition_error(hybrid)
    assert TimeoutError in tree_errs
    assert TimeoutError in hyb_errs
    assert {e for e in hyb_errs if e} <= {e for e in tree_errs if e}


# ------------------------------------------------------------ AsyncEA slice

def _slice_backend(pkg, L):
    if pkg == "jax":
        return jb.MeshBackend(num_nodes=L)
    return pb.MeshBackend(L, device="cpu")


def test_async_ea_slice_client_one_leg_for_l_rows():
    """A slice client (``slice_backend=MeshBackend``) pushes ONE delta for
    its L rows; the center moves by the SUM of the row deltas and every
    row keeps its own elastic pull."""
    L, alpha = 4, 0.5
    port = U.ports(8)
    out = {}

    def client_fn():
        c = U.client("port", port, node=1, alpha=alpha,
                     slice_backend=_slice_backend("port", L))
        p = c.init_client({"w": torch.zeros(3)})
        assert p["w"].shape == (L, 3)
        drift = torch.arange(1, L + 1, dtype=torch.float32)[:, None] \
            * torch.ones(3)
        p, out["synced"] = c.sync_client({"w": p["w"] + drift})
        out["p"] = p
        c.close()

    def server_fn():
        srv = U.server("port", port, 1)
        srv.init_server({"w": torch.zeros(3)})
        out["center"] = srv.sync_server({"w": torch.zeros(3)})
        srv.close()

    U.run_threads(server_fn, client_fn)
    assert out["synced"]
    want = (torch.arange(1, L + 1, dtype=torch.float32) * alpha)[:, None] \
        * torch.ones(3)
    assert torch.equal(out["p"]["w"], want)
    assert torch.equal(out["center"]["w"], torch.full((3,), 5.0))


def test_async_ea_slice_client_refuses_a_plain_backend():
    port = _port()

    class Plain:
        stacked_nodes = None
    with pytest.raises(ValueError, match="stacked-value backend"):
        U.client("port", port, slice_backend=Plain())


def _slice_fleet(server_pkg, client_pkg, codec, L=4, syncs=4):
    """One slice client of ``L`` rows (seeded float32 drifts) against a
    serial server: the center after every sync and the client's rows."""
    port = U.ports(8)
    base = U.params_np(None)
    rng = np.random.default_rng(11)
    drifts = [{k: rng.standard_normal((L,) + v.shape).astype(np.float32)
               for k, v in base.items()} for _ in range(syncs)]
    out = {"centers": []}

    def client_fn():
        c = U.client(client_pkg, port, node=1, codec=codec,
                     slice_backend=_slice_backend(client_pkg, L))
        p = c.init_client(U.tree(client_pkg, base))
        for d in drifts:
            p = {k: p[k] + (_t(d[k]) if client_pkg == "port" else d[k])
                 for k in p}
            p, synced = c.sync_client(p)
            assert synced
        out["p"] = [np.asarray(U.as_np(p[k])).copy() for k in sorted(p)]
        c.close()

    def server_fn():
        srv = U.server(server_pkg, port, 1)
        srv.init_server(U.tree(server_pkg, base))
        for _ in drifts:
            got = srv.sync_server(U.tree(server_pkg, base))
            out["centers"].append([np.asarray(U.as_np(got[k])).copy()
                                   for k in sorted(got)])
        srv.close()

    U.run_threads(server_fn, client_fn)
    return out


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "port"), ("jax", "port"),
                          ("port", "jax")])
def test_mixed_slice_fleets_bitwise_the_all_jax_center(server_pkg,
                                                       client_pkg):
    """A port slice client against a JAX server, a JAX slice client against
    a port server, and the all-port fleet: every center and the client's
    rows bit for bit the all-JAX run's."""
    got = _slice_fleet(server_pkg, client_pkg, "raw")
    want = _slice_fleet("jax", "jax", "raw")
    for g, w in zip(got["centers"], want["centers"]):
        U.assert_bitwise(g, w)
    U.assert_bitwise(got["p"], want["p"])


def test_int8_slice_client_bitwise_against_either_server():
    """int8: the port slice client's encoded row-sum delta lands bit for
    bit alike on the JAX server and the port server.  (The JAX package's
    own slice client encodes a lossy codec into read-only arrays and
    raises, so no all-JAX int8 run exists to compare with.)"""
    got = _slice_fleet("jax", "port", "int8")
    want = _slice_fleet("port", "port", "int8")
    for g, w in zip(got["centers"], want["centers"]):
        U.assert_bitwise(g, w)
    U.assert_bitwise(got["p"], want["p"])
    assert not np.array_equal(got["centers"][-1][0],
                              _slice_fleet("jax", "jax", "raw")
                              ["centers"][-1][0])


# ------------------------------------------------------------ sync_backends

_SYNC_FLAGS = ["--numNodes", "4", "--numHosts", "2", "--rounds", "12"]


@pytest.fixture(scope="module")
def jax_digest():
    out = subprocess.run(
        [sys.executable, "sync_backends.py", "--backend", "mesh",
         *_SYNC_FLAGS], cwd=os.path.join(ROOT, "examples"),
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    line = out.stdout.strip().splitlines()[-1]
    return line.split("digest=")[1]


@pytest.mark.parametrize("backend", ["mesh", "host", "hybrid"])
def test_sync_backends_digest_equals_the_jax_example(backend, jax_digest):
    opt = sync_backends.parse_flags(
        "", sync_backends.FLAGS,
        ["--backend", backend, "--device", "cpu", *_SYNC_FLAGS])
    line = sync_backends.run(opt)
    assert line.startswith(f"backend={backend} nodes=4 rounds=12")
    assert line.split("digest=")[1] == jax_digest
