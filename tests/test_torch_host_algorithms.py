"""The port's host AllReduceSGD / AllReduceEA
(``distlearn_tpu_torch/parallel/host_algorithms.py``) against the JAX
package's on the same seeds: uneven step counts through the flush protocol,
the port's torch tensors (B2's plain twin on the CPU for the elastic move)
bit for bit the JAX package's numpy run, over the tree and the ring."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.comm import ring as jax_ring  # noqa: E402
from distlearn_tpu.comm import tree as jax_tree  # noqa: E402
from distlearn_tpu.parallel import host_algorithms as jax_ha  # noqa: E402
from distlearn_tpu_torch.comm import ring as port_ring  # noqa: E402
from distlearn_tpu_torch.comm import tree as port_tree  # noqa: E402
from distlearn_tpu_torch.ops import fused_update  # noqa: E402
from distlearn_tpu_torch.parallel import host_algorithms as port_ha  # noqa: E402

from tests.net_util import reserve_port_window  # noqa: E402

TOPOLOGIES = {"tree": (jax_tree.LocalhostTree, port_tree.LocalhostTree),
              "ring": (jax_ring.LocalhostRing, port_ring.LocalhostRing)}


def _run(side, topology, n, body):
    """``body(rank, handle, ha, as_leaf)`` on ``n`` threaded ranks of one
    package: ``ha`` its host_algorithms module, ``as_leaf`` turning a numpy
    array into that side's leaf (numpy for JAX, a torch tensor for the
    port)."""
    port = reserve_port_window(1)
    make = TOPOLOGIES[topology][side == "port"]
    ha = port_ha if side == "port" else jax_ha
    as_leaf = (lambda a: torch.from_numpy(np.array(a))) if side == "port" \
        else (lambda a: np.array(a))

    def node(rank):
        h = make(rank, n, port)
        try:
            return body(rank, h, ha, as_leaf)
        finally:
            h.close()

    return port_tree.tree_map_spawn(node, n)


def _host(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("topology", ["tree", "ring"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sgd_uneven_steps_bit_for_bit_with_jax(topology, dtype):
    n = 4

    def body(rank, h, ha, as_leaf):
        sgd = ha.TreeAllReduceSGD(h)
        r = np.random.RandomState(40 + rank)
        params = {"w": as_leaf(np.zeros((6, 5), dtype)),
                  "b": as_leaf(np.zeros((5,), dtype))}
        params = sgd.synchronize_parameters(params)
        for ep in range(3):
            for _ in range(3 + rank + ep):          # uneven per rank
                g, m = sgd.sum_and_normalize_gradients(
                    {k: as_leaf(r.randn(*v.shape).astype(dtype))
                     for k, v in params.items()})
                params = {k: params[k] - dtype(0.05) * g[k] for k in params}
            params = sgd.synchronize_parameters(params)
        return _host(params)

    jax_res = _run("jax", topology, n, body)
    port_res = _run("port", topology, n, body)
    for a, b in zip(jax_res, port_res):
        for k in a:
            assert a[k].dtype == b[k].dtype == dtype
            np.testing.assert_array_equal(a[k], b[k])
    for b in port_res[1:]:
        for k in b:
            np.testing.assert_array_equal(b[k], port_res[0][k])


@pytest.mark.parametrize("topology", ["tree", "ring"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ea_uneven_rounds_bit_for_bit_with_jax(topology, dtype):
    """Over 20 elastic rounds a rank (tau 2, alpha 0.3), uneven steps per
    epoch and ``synchronize_center`` at each epoch's end: the port's params
    and center equal the JAX package's bit for bit, every round's move
    through ``fused_elastic`` (its plain twin on the CPU)."""
    n, tau, alpha = 3, 2, 0.3
    launches = []

    def body(rank, h, ha, as_leaf):
        ea = ha.TreeAllReduceEA(h, tau, alpha)
        r = np.random.RandomState(70 + rank)
        params = {"w": as_leaf(r.randn(9, 4).astype(dtype)),
                  "b": as_leaf(r.randn(4).astype(dtype))}
        params = ea.synchronize_parameters(params)
        rounds = 0
        for ep in range(4):
            for _ in range(int(r.randint(9, 15))):  # own count only
                params = {k: params[k] + as_leaf(
                    (r.randn(*params[k].shape) * 0.1).astype(dtype))
                    for k in params}
                params = ea.average_parameters(params)
                rounds += ea.step % tau == 0
            params = ea.synchronize_center(params)
        if hasattr(ea, "rounds"):
            launches.append((rank, ea.rounds))
        assert rounds >= 20
        return _host(params), _host(ea.center)

    calls = []
    real = fused_update.fused_elastic

    def counting(p, c, a):
        calls.append(p.numel())
        return real(p, c, a)

    jax_res = _run("jax", topology, n, body)
    fused_update.fused_elastic = counting
    try:
        port_res = _run("port", topology, n, body)
    finally:
        fused_update.fused_elastic = real
    for (pa, ca), (pb, cb) in zip(jax_res, port_res):
        for k in pa:
            assert pb[k].dtype == dtype
            np.testing.assert_array_equal(pa[k], pb[k])
            np.testing.assert_array_equal(ca[k], cb[k])
    # one move a round per rank, over one bucket holding both leaves
    assert len(calls) == sum(r for _, r in launches)
    assert all(k >= 9 * 4 + 4 for k in calls)
