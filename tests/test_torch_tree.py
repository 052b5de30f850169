"""The port's TCP tree (``distlearn_tpu_torch/comm/tree.py``) against the JAX
package's: the counterparts of ``tests/test_tree.py`` on port ranks, torch
tensor leaves against numpy leaves, and trees that mix JAX and port ranks,
which must give every rank the all-JAX bits.  Threads over real localhost
TCP stand in for processes, as in the reference's ``ipc.map`` fixture."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.comm import tree as jax_tree  # noqa: E402
from distlearn_tpu_torch.comm.tree import (LocalhostTree,  # noqa: E402
                                           tree_map_spawn)
from distlearn_tpu_torch.parallel.host_algorithms import (  # noqa: E402
    TreeAllReduceEA, TreeAllReduceSGD)

from tests.net_util import reserve_port_window  # noqa: E402


def _port() -> int:
    return reserve_port_window(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n,base", [(2, 2), (4, 2), (8, 2), (5, 3), (8, 4)])
def test_allreduce_sum_and_scatter(n, base):
    port = _port()
    rng = np.random.RandomState(0)
    values = [rng.randn(3, 4).astype(np.float32) for _ in range(n)]

    def node(rank):
        t = LocalhostTree(rank, n, port, base=base)
        red, m = t.all_reduce({"v": values[rank]})
        sc = t.scatter({"v": np.full((2, 2), float(rank), np.float32)})
        t.close()
        return red["v"], m, sc["v"]

    results = tree_map_spawn(node, n)
    expected = np.sum(values, axis=0)
    for red, m, sc in results:
        np.testing.assert_allclose(red, expected, rtol=1e-5)
        assert m == n
        np.testing.assert_array_equal(sc, 0.0)  # root's value everywhere


def test_allreduce_max_with_flush_identity():
    n, port = 3, _port()

    def node(rank):
        t = LocalhostTree(rank, n, port)
        red, m = t.all_reduce(np.array([-5.0 - rank]), op="max",
                              contrib=(rank != 1))
        t.close()
        return red, m

    for red, m in tree_map_spawn(node, n):
        np.testing.assert_array_equal(red, -5.0)
        assert m == 2


def test_allreduce_zero_contribution_flush():
    n, port = 4, _port()

    def node(rank):
        t = LocalhostTree(rank, n, port)
        red, m = t.all_reduce(np.ones(5, np.float64), contrib=rank < 2)
        t.close()
        return red, m

    for red, m in tree_map_spawn(node, n):
        np.testing.assert_array_equal(red, 2.0)
        assert m == 2


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_tree_sgd_reference_invariant(kind):
    """test/test_AllReduceSGD.lua on the port: own random 4-13 steps per
    epoch, then every node's params bitwise equal after the sync."""
    rng = np.random.RandomState(7)
    wrap = torch.from_numpy if kind == "torch" else (lambda a: a)
    for trial in range(2):
        n = int(rng.choice([2, 4, 8]))
        port = _port()

        def node(rank):
            t = LocalhostTree(rank, n, port)
            sgd = TreeAllReduceSGD(t)
            r = np.random.RandomState(100 * trial + rank)
            params = {"w": wrap(np.zeros((4, 3), np.float64))}
            for ep in range(3):
                for _ in range(int(r.randint(4, 14))):
                    g, m = sgd.sum_and_normalize_gradients(
                        {"w": wrap(r.randn(4, 3))})
                    params = {"w": params["w"] - 0.01 * g["w"]}
                params = sgd.synchronize_parameters(params)
            t.close()
            return _np(params["w"])

        results = tree_map_spawn(node, n)
        for w in results[1:]:
            np.testing.assert_array_equal(results[0], w)


def test_tree_ea_reference_invariant():
    """test/test_AllReduceEA.lua on the port with torch leaves (B2's plain
    twin): final inter-node gap < 1e-6, the reference oracle."""
    rng = np.random.RandomState(3)
    n = int(rng.choice([2, 4, 8]))
    port = _port()

    def node(rank):
        t = LocalhostTree(rank, n, port)
        ea = TreeAllReduceEA(t, 3, 0.4)
        r = np.random.RandomState(200 + rank)
        params = {"w": torch.from_numpy(r.randn(7))}
        params = ea.synchronize_parameters(params)
        slowit = 1.0
        for ep in range(3):
            for _ in range(int(r.randint(45, 54))):
                params = {"w": params["w"] + torch.from_numpy(r.randn(7))
                          / slowit}
                slowit *= 2.0
                params = ea.average_parameters(params)
            params = ea.synchronize_center(params)
        t.close()
        return _np(params["w"])

    params = np.stack(tree_map_spawn(node, n))
    assert np.abs(params - params[0]).max() < 1e-6


def test_allreduce_rejects_dtype_skew():
    n, port = 2, _port()

    def node(rank):
        t = LocalhostTree(rank, n, port)
        dt = torch.float64 if rank == 1 else torch.float32
        try:
            t.all_reduce({"v": torch.ones((3,), dtype=dt)})
            return "no-error"
        except (ValueError, ConnectionError, TimeoutError) as e:
            return type(e).__name__
        finally:
            t.close()

    assert "ValueError" in tree_map_spawn(node, n, timeout=30)


def test_barrier_and_ranks():
    n, port = 4, _port()

    def node(rank):
        t = LocalhostTree(rank, n, port)
        t.barrier()
        idx = t.node_index
        t.close()
        return idx

    assert tree_map_spawn(node, n) == [0, 1, 2, 3]


def test_op_timeout_detects_dead_rank():
    port = _port()

    def node(rank):
        t = LocalhostTree(rank, 2, port, base=2)
        if rank == 1:
            t.close()
            return None
        t.set_op_timeout(0.5)
        t0 = time.monotonic()
        try:
            t.all_reduce({"v": torch.ones((4,))})
            return ("no-error", time.monotonic() - t0)
        except (TimeoutError, ConnectionError) as e:
            return (type(e).__name__, time.monotonic() - t0)
        finally:
            t.close()

    kind, dt = tree_map_spawn(node, 2, timeout=30)[0]
    assert kind in ("TimeoutError", "ConnectionError", "PeerClosed"), kind
    assert dt < 10.0


# ---------------------------------------------------------------------------
# Tensor leaves against numpy leaves, and trees mixing JAX and port ranks
# ---------------------------------------------------------------------------

def _values(n, seed=5):
    """Per-rank float32/float64/int64 leaves whose float sums depend on the
    order of the additions."""
    rng = np.random.RandomState(seed)
    return [{"a": (rng.randn(33, 7) * 10.0 ** rng.randint(-3, 4, (33, 7))
                   ).astype(np.float32),
             "b": rng.randn(5).astype(np.float64),
             "c": rng.randint(-1000, 1000, (4, 2)).astype(np.int64),
             "s": np.float32(rng.randn())} for _ in range(n)]


def _round(t, value, case, rank):
    """One collective of ``case`` on handle ``t``; host arrays out."""
    if case == "scatter":
        out = t.scatter(value)
        extra = None
    else:
        op = "max" if case == "max" else "sum"
        contrib = not (case == "contrib" and rank % 3 == 1)
        out, m, rid = t.all_reduce_ex(value, op=op, contrib=contrib,
                                      rider=10 + rank,
                                      codec="int8" if case == "int8"
                                      else "raw")
        extra = (m, rid)
    return {k: _np(v) for k, v in out.items()}, extra


CASES = ["sum", "max", "contrib", "int8", "scatter"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,base", [(4, 2), (7, 3)])
def test_tensor_leaves_match_numpy_leaves(case, n, base):
    """A port tree with torch CPU tensor leaves gives the same bits, counts
    and riders as the same tree with numpy leaves; the caller's tensors are
    left as they were and never aliased."""
    vals = _values(n)
    results = {}
    for kind in ("numpy", "torch"):
        port = _port()

        def node(rank):
            v = vals[rank]
            if kind == "torch":
                v = {k: torch.from_numpy(np.array(a)) for k, a in v.items()}
            t = LocalhostTree(rank, n, port, base=base)
            got = _round(t, v, case, rank)
            if kind == "torch":
                for k, a in vals[rank].items():
                    np.testing.assert_array_equal(v[k].numpy(), a)
            t.close()
            return got

        results[kind] = tree_map_spawn(node, n)
    for rank, ((a, ea), (b, eb)) in enumerate(zip(results["numpy"],
                                                  results["torch"])):
        assert ea == eb
        for k in a:
            # tensors keep their shape; the numpy path returns 0-d leaves
            # as shape (1,), as the JAX package's does
            assert b[k].shape == vals[rank][k].shape
            assert a[k].dtype == b[k].dtype and a[k].size == b[k].size
            np.testing.assert_array_equal(a[k].reshape(b[k].shape), b[k])


@pytest.mark.parametrize("case", CASES)
def test_mixed_jax_and_port_ranks_match_all_jax(case):
    """Even ranks JAX, odd ranks port (torch tensors), in one tree: every
    rank gets the all-JAX tree's bits, contributor count and rider."""
    n, base = 6, 2
    vals = _values(n, seed=11)
    results = {}
    for mix in ("jax", "mixed"):
        port = _port()

        def node(rank):
            v = vals[rank]
            if mix == "mixed" and rank % 2:
                t = LocalhostTree(rank, n, port, base=base)
                v = {k: torch.from_numpy(np.array(a)) for k, a in v.items()}
            else:
                t = jax_tree.LocalhostTree(rank, n, port, base=base)
            got = _round(t, v, case, rank)
            t.close()
            return got

        results[mix] = tree_map_spawn(node, n)
    for (a, ea), (b, eb) in zip(results["jax"], results["mixed"]):
        assert ea == eb
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].size == b[k].size
            np.testing.assert_array_equal(a[k].reshape(b[k].shape), b[k])
