"""The port's ring allreduce (``distlearn_tpu_torch/comm/ring.py``) against
the JAX package's: the counterparts of ``tests/test_ring.py`` on port
ranks, torch tensor leaves against numpy leaves, rings that mix JAX and
port ranks (every rank gets the all-JAX bits), and the ring against the
tree.  Threads over real localhost TCP, as in the reference's ``ipc.map``
fixture."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.comm import ring as jax_ring  # noqa: E402
from distlearn_tpu_torch.comm.ring import LocalhostRing  # noqa: E402
from distlearn_tpu_torch.comm.tree import (LocalhostTree,  # noqa: E402
                                           tree_map_spawn)
from distlearn_tpu_torch.parallel.host_algorithms import (  # noqa: E402
    TreeAllReduceSGD)

from tests.net_util import reserve_port_window  # noqa: E402


def _port() -> int:
    return reserve_port_window(1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_ring_allreduce_sum_and_count(n):
    port = _port()
    rng = np.random.RandomState(0)
    values = [rng.randn(37, 5).astype(np.float32) for _ in range(n)]

    def node(rank):
        r = LocalhostRing(rank, n, port)
        red, m = r.all_reduce({"v": torch.from_numpy(values[rank]),
                               "s": torch.tensor(float(rank))})
        r.close()
        return red, m

    expected = np.sum(values, axis=0)
    for red, m in tree_map_spawn(node, n):
        np.testing.assert_allclose(red["v"].numpy(), expected, rtol=1e-5)
        np.testing.assert_allclose(red["s"].numpy(), sum(range(n)), rtol=1e-6)
        assert red["s"].shape == ()
        assert m == n


def test_ring_mixed_dtypes_and_scalar_leaves():
    n, port = 4, _port()

    def node(rank):
        r = LocalhostRing(rank, n, port)
        red, m = r.all_reduce({"f": np.full((9,), 1.5, np.float64),
                               "i": np.arange(3, dtype=np.int64) + rank,
                               "tiny": np.int64(1)})
        r.close()
        return red, m

    for red, m in tree_map_spawn(node, n):
        np.testing.assert_array_equal(red["f"], 6.0)
        np.testing.assert_array_equal(
            red["i"], n * np.arange(3) + sum(range(n)))
        assert red["tiny"] == n
        assert m == n


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_ring_flush_and_rider(kind):
    n, port = 4, _port()
    wrap = torch.from_numpy if kind == "torch" else (lambda a: a)

    def node(rank):
        r = LocalhostRing(rank, n, port)
        red, m, rid = r.all_reduce_ex(wrap(np.ones(6, np.float64)),
                                      contrib=(rank < 2), rider=10 + rank)
        mx, m2 = r.all_reduce(wrap(np.array([-3.0 - rank])), op="max",
                              contrib=(rank != 0))
        r.close()
        return _np(red), m, rid, _np(mx), m2

    for red, m, rid, mx, m2 in tree_map_spawn(node, n):
        np.testing.assert_array_equal(red, 2.0)
        assert m == 2
        assert rid == 10 + 11 + 12 + 13
        np.testing.assert_array_equal(mx, -4.0)
        assert m2 == n - 1


@pytest.mark.parametrize("n", [2, 3, 5])
def test_ring_scatter(n):
    port = _port()

    def node(rank):
        r = LocalhostRing(rank, n, port)
        mine = {"v": torch.full((4, 4), float(rank)),
                "u": torch.arange(5) + rank}
        sc = r.scatter(mine)
        r.barrier()
        r.close()
        assert all(sc[k] is not mine[k] for k in mine)
        return sc

    for sc in tree_map_spawn(node, n):
        np.testing.assert_array_equal(sc["v"].numpy(), 0.0)
        np.testing.assert_array_equal(sc["u"].numpy(), np.arange(5))


def test_ring_matches_tree_bitwise():
    """Sums whose every partial sum is exact (dyadic floats, int64): the
    port's ring and tree agree bit for bit, with tensors and numpy."""
    n = 4
    rng = np.random.RandomState(5)
    values = [(rng.randint(-2 ** 20, 2 ** 20, 1000) / 2.0 ** 8
               ).astype(np.float32) for _ in range(n)]
    ints = [rng.randint(-100, 100, 257).astype(np.int64) for _ in range(n)]
    got = {}
    for name, make in (("tree", LocalhostTree), ("ring", LocalhostRing)):
        for kind in ("numpy", "torch"):
            port = _port()
            wrap = torch.from_numpy if kind == "torch" else (lambda a: a)

            def node(rank):
                h = make(rank, n, port)
                red, _ = h.all_reduce({"f": wrap(values[rank]),
                                       "i": wrap(ints[rank])})
                h.close()
                return {k: _np(v) for k, v in red.items()}

            got[name, kind] = tree_map_spawn(node, n)
    want = got["tree", "numpy"][0]
    for res in got.values():
        for r in res:
            for k in want:
                assert r[k].dtype == want[k].dtype
                np.testing.assert_array_equal(r[k], want[k])


def test_ring_sgd_reference_invariant():
    rng = np.random.RandomState(11)
    n = int(rng.choice([2, 4, 8]))
    port = _port()

    def node(rank):
        r = LocalhostRing(rank, n, port)
        sgd = TreeAllReduceSGD(r)
        rr = np.random.RandomState(300 + rank)
        params = {"w": torch.zeros((4, 3), dtype=torch.float64)}
        for ep in range(2):
            for _ in range(int(rr.randint(4, 14))):
                g, m = sgd.sum_and_normalize_gradients(
                    {"w": torch.from_numpy(rr.randn(4, 3))})
                params = {"w": params["w"] - 0.01 * g["w"]}
            params = sgd.synchronize_parameters(params)
        r.close()
        return params["w"].numpy()

    results = tree_map_spawn(node, n)
    for w in results[1:]:
        np.testing.assert_array_equal(results[0], w)


@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_ring_single_node(kind):
    wrap = torch.from_numpy if kind == "torch" else (lambda a: a)
    r = LocalhostRing(0, 1, _port())
    red, m, rid = r.all_reduce_ex({"v": wrap(np.ones(3))}, rider=7)
    np.testing.assert_array_equal(_np(red["v"]), 1.0)
    assert (m, rid) == (1, 7)
    sc = r.scatter({"v": wrap(np.zeros(2))})
    np.testing.assert_array_equal(_np(sc["v"]), 0.0)
    r.close()


def test_ring_op_timeout_detects_dead_rank():
    port = _port()

    def node(rank):
        r = LocalhostRing(rank, 2, port)
        if rank == 1:
            r.close()
            return None
        r.set_op_timeout(0.5)
        t0 = time.monotonic()
        try:
            r.all_reduce({"v": torch.ones((4,))})
            return ("no-error", time.monotonic() - t0)
        except (TimeoutError, ConnectionError) as e:
            return (type(e).__name__, time.monotonic() - t0)
        finally:
            r.close()

    kind, dt = tree_map_spawn(node, 2, timeout=30)[0]
    assert kind in ("TimeoutError", "ConnectionError", "PeerClosed"), kind
    assert dt < 10.0


# ---------------------------------------------------------------------------
# Rings mixing JAX and port ranks
# ---------------------------------------------------------------------------

def _values(n, seed=13):
    rng = np.random.RandomState(seed)
    return [{"a": (rng.randn(41, 3) * 10.0 ** rng.randint(-3, 4, (41, 3))
                   ).astype(np.float32),
             "b": rng.randn(6).astype(np.float32),
             "c": rng.randn(5).astype(np.float64),
             "d": rng.randint(-1000, 1000, (4, 2)).astype(np.int64)}
            for _ in range(n)]


@pytest.mark.parametrize("case", ["sum", "max", "contrib", "scatter"])
@pytest.mark.parametrize("n", [3, 4])
def test_mixed_jax_and_port_ranks_match_all_jax(case, n):
    """Even ranks JAX, odd ranks port (torch tensors; two float32 leaves
    share one dtype group), in one ring: every rank gets the all-JAX
    ring's bits, contributor count and rider."""
    vals = _values(n)
    results = {}
    for mix in ("jax", "mixed"):
        port = _port()

        def node(rank):
            v = vals[rank]
            if mix == "mixed" and rank % 2:
                h = LocalhostRing(rank, n, port)
                v = {k: torch.from_numpy(np.array(a)) for k, a in v.items()}
            else:
                h = jax_ring.LocalhostRing(rank, n, port)
            if case == "scatter":
                out, extra = h.scatter(v), None
            else:
                out, m, rid = h.all_reduce_ex(
                    v, op="max" if case == "max" else "sum",
                    contrib=not (case == "contrib" and rank % 3 == 1),
                    rider=10 + rank)
                extra = (m, rid)
            h.close()
            return {k: _np(x) for k, x in out.items()}, extra

        results[mix] = tree_map_spawn(node, n)
    for (a, ea), (b, eb) in zip(results["jax"], results["mixed"]):
        assert ea == eb
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
