"""The port's AsyncEA parameter server (``distlearn_tpu_torch/parallel/
async_ea.py`` and ``examples/easgd.py``) against the JAX package's, over
real localhost sockets with the roles as threads, all on the CPU:

1. trajectories: 50 rounds of the port's server and client in each codec
   end on the center of tests/test_async_ea_wire.py::_run_ea, bit for bit;
2. mixed fleets: a JAX server with a port client and a port server with a
   JAX client, 50 int8 rounds, bit for bit the all-JAX run;
3. the slice's sync math at full width: the CIFAR-10 convnet's 18 leaves
   from the JAX init, 5 int8 rounds, equal to the JAX pair after the
   layout change;
4. the AsyncEA semantics tests of tests/test_async_ea*.py on the port;
5. end to end against JAX: one client, tau 2, 3 raw syncs of the float64
   MNIST CNN on the same batches, within 1e-9 (PR 1's float64 tolerance);
6. the example's roles as threads: 2 clients, a tester, int8.

The int8 codec is deterministic, so items 1-3 are exact; the float64 run of
item 5 differs only by the two frameworks' convolution arithmetic.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import random  # noqa: E402

from distlearn_tpu.comm import connect as jconnect  # noqa: E402
from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu.models import mnist_cnn as jax_mnist  # noqa: E402
from distlearn_tpu.models.core import loss_fn as jax_loss_fn  # noqa: E402
from distlearn_tpu.parallel import async_ea as jea  # noqa: E402
from distlearn_tpu.utils.logging import set_verbose as jset_verbose  # noqa: E402
from distlearn_tpu_torch.comm import ProtocolError  # noqa: E402
from distlearn_tpu_torch.data import synthetic_mnist  # noqa: E402
from distlearn_tpu_torch.examples import easgd  # noqa: E402
from distlearn_tpu_torch.models import mnist_cnn  # noqa: E402
from distlearn_tpu_torch.models.convert import from_jax, to_jax  # noqa: E402
from distlearn_tpu_torch.parallel import async_ea as pea  # noqa: E402
from distlearn_tpu_torch.train import trainer  # noqa: E402
from distlearn_tpu_torch.utils.logging import set_verbose  # noqa: E402
from distlearn_tpu_torch.utils.tree import tree_leaves  # noqa: E402

from tests.net_util import reserve_port_window  # noqa: E402
from tests.test_async_ea_wire import _run_ea  # noqa: E402

set_verbose(False)
jset_verbose(False)

JOIN_S = 120
E2E_RTOL, E2E_ATOL = 1e-9, 1e-12
HOST = "127.0.0.1"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    # the tier-1 run shares the cores between several worker processes
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _ports() -> int:
    return reserve_port_window(8)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.reshape(-1).view(np.dtype(f"u{a.dtype.itemsize}"))


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == np.shape(w) and g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


def _run_threads(*fns):
    """Run ``fns`` as threads; re-raise the first failure, fail on a hang."""
    errs = []

    def wrap(fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errs.append(e)
        return run

    threads = [threading.Thread(target=wrap(f), daemon=True) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a role hung"
    if errs:
        raise errs[0]


# ---------------------------------------------------------------------------
# Roles of either package behind one call shape

def _server(pkg, port, num_nodes=1, **kw):
    if pkg == "port":
        return pea.AsyncEAServer(HOST, port, num_nodes, device="cpu", **kw)
    return jea.AsyncEAServer(HOST, port, num_nodes, **kw)


def _client(pkg, port, node=1, tau=1, alpha=0.5, codec="raw"):
    if pkg == "port":
        return pea.AsyncEAClient(HOST, port, node=node, tau=tau, alpha=alpha,
                                 codec=codec, device="cpu")
    return jea.AsyncEAClient(HOST, port, node=node, tau=tau, alpha=alpha,
                             codec=codec)


def _tree(pkg, tree_np):
    """A numpy pytree as the package's own leaves."""
    if pkg == "port":
        return {k: (_tree(pkg, v) if isinstance(v, dict)
                    else torch.from_numpy(np.array(v)))
                for k, v in tree_np.items()}
    return {k: (_tree(pkg, v) if isinstance(v, dict) else np.array(v))
            for k, v in tree_np.items()}


def _run_pair(server_pkg, client_pkg, init_np, drift, rounds, codec,
              alpha=0.5):
    """One client syncing every step (tau 1) for ``rounds`` rounds against
    a serial server, both starting from ``init_np``; ``drift(r, params)``
    is the client's local move before sync r.  Returns (final center
    leaves, final client params)."""
    port = _ports()
    out = {}

    def client_fn():
        c = _client(client_pkg, port, alpha=alpha, codec=codec)
        p = c.init_client(_tree(client_pkg, init_np))
        for r in range(rounds):
            p, synced = c.sync_client(drift(r, p))
            assert synced
        out["params"] = p
        c.close()

    def server_fn():
        srv = _server(server_pkg, port)
        srv.init_server(_tree(server_pkg, init_np))
        for _ in range(rounds):
            srv.sync_server(_tree(server_pkg, init_np))
        out["center"] = [t.clone() if isinstance(t, torch.Tensor)
                         else t.copy() for t in srv.center]
        srv.close()

    _run_threads(server_fn, client_fn)
    return out["center"], out["params"]


# ---------------------------------------------------------------------------
# 1. trajectories against tests/test_async_ea_wire.py::_run_ea

def _run_port_ea(codec, rounds=50, seed=3):
    """The port's side of ``_run_ea``: the same drift sequence."""
    drifts = np.random.RandomState(seed).randn(rounds).astype(np.float32)
    center, _ = _run_pair(
        "port", "port", {"w": np.zeros((8, 5), np.float32)},
        lambda r, p: {"w": p["w"] + float(drifts[r])}, rounds, codec)
    return center[0]


@pytest.mark.parametrize("codec", ["int8", "fp16", "raw"])
def test_fifty_round_trajectory_bitwise_vs_jax(codec):
    _assert_bitwise([_run_port_ea(codec)], [_run_ea(_ports(), codec)])


# ---------------------------------------------------------------------------
# 2. mixed fleets

_MIXED_INIT = {"w": np.zeros((8, 5), np.float32),
               "b": np.zeros((3,), np.float32)}


def _mixed_drift(r, p):
    return {k: v + ((r % 5) + 0.25) for k, v in p.items()}


@pytest.fixture(scope="module")
def all_jax_int8_run():
    return _run_pair("jax", "jax", _MIXED_INIT, _mixed_drift, 50, "int8")


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_mixed_fleet_int8_bitwise_vs_all_jax(all_jax_int8_run, server_pkg,
                                             client_pkg):
    center, params = _run_pair(server_pkg, client_pkg, _MIXED_INIT,
                               _mixed_drift, 50, "int8")
    want_center, want_params = all_jax_int8_run
    _assert_bitwise(center, want_center)
    _assert_bitwise([params[k] for k in sorted(params)],
                    [want_params[k] for k in sorted(want_params)])


# ---------------------------------------------------------------------------
# 3. the slice's sync math at full width

def test_convnet_int8_rounds_bitwise_vs_jax_after_layout_change():
    params, _ = jax_cifar().init(random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jax.device_get(params))
    rng = np.random.RandomState(11)
    rounds = 5
    drifts = [jax.tree_util.tree_map(
        lambda a: (0.01 * rng.randn(*a.shape)).astype(np.float32), jparams)
        for _ in range(rounds)]
    port_drifts = [from_jax(d, {})[0] for d in drifts]
    add = lambda a, b: a + b
    jcenter, jclient = _run_pair(
        "jax", "jax", jparams,
        lambda r, p: jax.tree_util.tree_map(add, p, drifts[r]), rounds,
        "int8")
    pinit = {k: {n: v.numpy() for n, v in d.items()}
             for k, d in from_jax(jparams, {})[0].items()}
    pcenter, pclient = _run_pair(
        "port", "port", pinit,
        lambda r, p: {k: {n: v + port_drifts[r][k][n] for n, v in d.items()}
                      for k, d in p.items()}, rounds, "int8")
    assert len(pcenter) == 18
    template = from_jax(jparams, {})[0]
    _assert_bitwise(
        jax.tree_util.tree_leaves(to_jax(pea._rebuild(template, pcenter))),
        jcenter)
    _assert_bitwise(jax.tree_util.tree_leaves(to_jax(pclient)),
                    jax.tree_util.tree_leaves(jclient))


def test_mixed_convnet_fleet_fails_on_the_layout():
    """A known limit of the port: the two packages keep the convnet's conv
    and dense weights in different layouts (HWIO/[in, out] against
    OIHW/[out, in]), so a port client training its own params against a
    JAX server's center cannot form the elastic delta; the client raises
    and the server evicts it, its center untouched."""
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax_cifar().init(random.PRNGKey(0))[0]))
    tparams = from_jax(jparams, {})[0]
    port = _ports()
    box = {}

    def client_fn():
        c = _client("port", port, codec="int8")
        c.init_client(tparams)
        try:
            c.sync_client(tparams)
        except RuntimeError as e:
            box["client_error"] = str(e)
        c.close()

    def server_fn():
        srv = _server("jax", port, handshake_timeout=5.0)
        srv.init_server(jparams)
        with pytest.raises((TimeoutError, RuntimeError)):
            srv.sync_server(jparams, timeout=10.0)
        box["evicted"] = set(srv.evicted)
        box["center"] = [t.copy() for t in srv.center]
        srv.close()

    _run_threads(server_fn, client_fn)
    assert "size of tensor" in box["client_error"]
    assert box["evicted"] == {1}
    _assert_bitwise(box["center"], jax.tree_util.tree_leaves(jparams))


# ---------------------------------------------------------------------------
# 4. AsyncEA semantics (tests/test_async_ea.py, tests/test_async_ea_wire.py)

def _params():
    return {"w": torch.zeros((4, 3)), "b": torch.zeros((3,))}


def test_parse_and_check_wire_like_jax():
    for msg in ("Enter?", {"q": "Enter?", "clientID": 1},
                {"q": "Enter?", "wire": {"v": 1, "codec": "int8"}},
                {"q": "Enter?", "wire": {"v": 1, "codec": "zstd"}},
                {"q": "Enter?", "wire": "bogus"}):
        assert pea._parse_wire_request(msg) == jea._parse_wire_request(msg)
    ok = {"a": "Enter", "wire": {"v": 1, "codec": "int8"}}
    assert pea._check_wire_reply(ok, "Enter", "int8") is True
    assert pea._check_wire_reply("Enter", "Enter", "raw") is False
    with pytest.raises(ProtocolError, match="rejected"):
        pea._check_wire_reply({"a": "Enter", "wire": {"error": "x"}},
                              "Enter", "int8")
    with pytest.raises(ProtocolError, match="desync"):
        pea._check_wire_reply({"a": "Enter", "wire": {"codec": "fp16"}},
                              "Enter", "int8")


def test_client_rejects_bad_node_and_codec():
    with pytest.raises(ValueError, match="1-based"):
        pea.AsyncEAClient(HOST, 1, node=0, tau=1, alpha=0.5, device="cpu")
    with pytest.raises(ValueError, match="unknown wire codec"):
        pea.AsyncEAClient(HOST, 1, node=1, tau=1, alpha=0.5, codec="zstd",
                          device="cpu")
    with pytest.raises(ValueError, match="unknown wire codec"):
        pea.AsyncEATester(HOST, 1, 1, codec="zstd", device="cpu")


def test_roles_raise_without_gpu(monkeypatch):
    """No device given and no GPU: every role raises before it opens a
    socket, and so does the example."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: pea.AsyncEAServer(HOST, 1, 1),
                 lambda: pea.AsyncEAClient(HOST, 1, node=1, tau=1, alpha=0.5),
                 lambda: pea.AsyncEATester(HOST, 1, 1),
                 lambda: easgd.run_server(easgd.parse_role("server", []))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_init_broadcast_delivers_center():
    port = _ports()
    server_params = {"w": torch.full((4, 3), 7.0), "b": torch.full((3,), -1.0)}
    got = {}

    def client_fn(node):
        c = _client("port", port, node=node, tau=10)
        got[node] = c.init_client(_params())
        c.close()

    def server_fn():
        srv = _server("port", port, num_nodes=2)
        srv.init_server(server_params)
        srv.close()

    _run_threads(server_fn, lambda: client_fn(1), lambda: client_fn(2))
    for node in (1, 2):
        for k in server_params:
            assert torch.equal(got[node][k], server_params[k])


def test_init_client_then_sync_keeps_initial_params(monkeypatch):
    """The center's host-to-device copy is complete when init_client
    returns: the host twin it reads from is where the next sync's center
    lands, so overwriting it must not reach the params or the center."""
    port = _ports()
    server_params = {"w": torch.full((4, 3), 7.0), "b": torch.full((3,), -1.0)}
    waited, got = [], {}
    sync = pea._sync

    def spy(device):
        waited.append((threading.get_ident(), device))
        sync(device)

    monkeypatch.setattr(pea, "_sync", spy)

    def client_fn():
        c = _client("port", port, tau=1, codec="int8")
        p = c.init_client(_params())
        me = threading.get_ident()
        got["waited"] = [d for t, d in waited if t == me]
        for h in c._slab.host_leaves:       # the next center's bytes
            h[...] = np.nan
        got["init"] = {k: v.clone() for k, v in p.items()}
        got["center"] = [t.clone() for t in c.center]
        got["synced"], _ = c.sync_client(p)
        c.close()

    def server_fn():
        srv = _server("port", port)
        srv.init_server(server_params)
        srv.sync_server(server_params)
        got["server"] = [t.clone() for t in srv.center]
        srv.close()

    _run_threads(server_fn, client_fn)
    assert got["waited"] == [torch.device("cpu")]
    for k in server_params:
        assert torch.equal(got["init"][k], server_params[k])
        assert torch.equal(got["synced"][k], server_params[k])
    want = tree_leaves(server_params)
    for c, s, w in zip(got["center"], got["server"], want):
        assert torch.equal(c, w) and torch.equal(s, w)


@pytest.mark.parametrize("codec", ["raw", "int8", None])
def test_sync_round_easgd_math(codec):
    """delta = (p - c) * alpha, p -= delta, center += delta
    (lua/AsyncEA.lua:109-119,212-216); tau 2 syncs on the second step."""
    port = _ports()
    out = {}

    def client_fn():
        c = _client("port", port, tau=2, codec=codec)
        p = c.init_client(_params())
        p = {"w": p["w"] + 2.0, "b": p["b"] + 4.0}
        p, synced = c.sync_client(p)
        assert not synced
        p, synced = c.sync_client(p)
        assert synced
        out["p"] = p
        c.close()

    def server_fn():
        srv = _server("port", port)
        srv.init_server(_params())
        out["new"] = srv.sync_server(_params())
        srv.close()

    _run_threads(server_fn, client_fn)
    # delta_w = (2 - 0) * 0.5 = 1 -> client w: 2 - 1 = 1, center w: 0 + 1;
    # delta_b = (4 - 0) * 0.5 = 2 -> client b: 4 - 2 = 2, center b: 0 + 2.
    # int8 ships each constant leaf as q = 127 at scale amax/127, so the
    # center takes 127 * f32(amax/127)
    assert torch.equal(out["p"]["w"], torch.full((4, 3), 1.0))
    assert torch.equal(out["p"]["b"], torch.full((3,), 2.0))
    deq = ((lambda a: float(np.float32(127) * np.float32(a / 127.0)))
           if codec == "int8" else float)
    assert torch.equal(out["new"]["w"], torch.full((4, 3), deq(1.0)))
    assert torch.equal(out["new"]["b"], torch.full((3,), deq(2.0)))


@pytest.mark.parametrize("codec", ["int8", "fp16"])
def test_integer_leaf_rides_raw_in_a_quantized_frame(codec):
    """A non-float leaf rides raw inside an int8/fp16 frame at whatever
    byte offset the float leaves before it leave (here 5 bytes or 10): the
    server applies it exactly, the float leaf through the codec, equal to
    the JAX server on the same run.  (alpha 1: an integer delta scaled by
    0.5 in the leaf's own dtype would be 0.)"""
    init = {"a": np.zeros(5, np.float32), "b": np.zeros(3, np.int64)}

    def drift(r, p):
        return {"a": p["a"] + (r + 1.5), "b": p["b"] + 2 * (r + 1)}

    center, params = _run_pair("port", "port", init, drift, 4, codec, 1.0)
    want_center, want_params = _run_pair("jax", "jax", init, drift, 4, codec,
                                         1.0)
    _assert_bitwise(center, want_center)
    _assert_bitwise([params[k] for k in "ab"], [want_params[k] for k in "ab"])
    assert center[1].dtype == torch.int64 and center[1].any()


@pytest.mark.parametrize("codec", [None, "int8"])
def test_tester_receives_center_push(codec):
    port = _ports()
    out = {}

    def client_fn():
        c = _client("port", port)
        p = c.init_client(_params())
        c.sync_client({"w": p["w"] + 1.0, "b": p["b"]})
        c.close()

    def tester_fn():
        t = pea.AsyncEATester(HOST, port, num_nodes=1, codec=codec,
                              device="cpu")
        out["center"] = t.start_test(_params())
        t.finish_test()
        t.close()

    def server_fn():
        srv = _server("port", port, with_tester=True)
        srv.init_server(_params())
        srv.sync_server(_params())
        out["pushed"] = srv.test_net()
        srv.close()

    _run_threads(server_fn, client_fn, tester_fn)
    assert out["pushed"]
    assert torch.equal(out["center"]["w"], torch.full((4, 3), 0.5))


def test_dead_client_evicted_server_keeps_serving():
    """Client #2 requests the critical section and dies; the server evicts
    it and completes the round with client #1."""
    port = _ports()
    out = {}

    def zombie_fn():
        b = jconnect(HOST, port)
        d = jconnect(HOST, port + 2)
        for _ in range(2):                # the initial center (w, b)
            b.recv_tensor()
        b.send_msg({"q": "Enter?", "clientID": 2})
        b.close()
        d.close()

    def live_fn():
        import time
        c = _client("port", port)
        p = c.init_client(_params())
        time.sleep(0.5)
        p, out["synced"] = c.sync_client({"w": p["w"] + 1.0, "b": p["b"]})
        out["p"] = p
        c.close()

    def server_fn():
        srv = _server("port", port, num_nodes=2, handshake_timeout=5.0)
        srv.init_server(_params())
        out["new"] = srv.sync_server(_params())
        out["evicted"], out["live"] = set(srv.evicted), srv.live_clients
        srv.close()

    _run_threads(server_fn, zombie_fn, live_fn)
    assert out["evicted"] == {2} and out["live"] == 1 and out["synced"]
    assert torch.equal(out["new"]["w"], torch.full((4, 3), 0.5))
    assert torch.equal(out["p"]["w"], torch.full((4, 3), 0.5))


def _skewed_client(port, delta, box):
    """A client that receives the 16-element center and pushes ``delta``
    through a hand-driven handshake."""
    b = jconnect(HOST, port)
    d = jconnect(HOST, port + 1)
    b.recv_tensor()
    b.send_msg({"q": "Enter?", "clientID": 1})
    box["enter"] = d.recv_msg()
    d.send_msg("Center?")
    d.recv_tensor()
    d.send_msg("delta?")
    d.recv_msg()
    d.send_tensor(delta)
    b.close()
    d.close()


@pytest.mark.parametrize("delta", [np.ones(8, np.float32),
                                   np.ones(16, np.float64)],
                         ids=["shape_skew", "dtype_skew"])
def test_server_evicts_skewed_client_before_apply(delta):
    port = _ports()
    init = {"w": torch.ones(16)}
    box = {}

    def server_fn():
        srv = _server("port", port, accept_timeout=60.0,
                      handshake_timeout=5.0)
        srv.init_server(init)
        with pytest.raises((TimeoutError, RuntimeError)):
            srv.sync_server(init, timeout=5.0)
        box["evicted"] = set(srv.evicted)
        box["center"] = srv.center[0].clone()
        srv.close()

    _run_threads(server_fn, lambda: _skewed_client(port, delta, box))
    assert box["enter"] == "Enter"
    assert box["evicted"] == {1}
    assert torch.equal(box["center"], init["w"])            # untouched


@pytest.mark.parametrize("request_q", ["Rejoin?", "Join?", "Leave?",
                                       "Shard?"])
def test_unserved_requests_evict(request_q):
    """The serial port server serves Enter? only: a rejoin, join or leave
    request evicts the client it names, the center untouched."""
    port = _ports()
    box = {}

    def client_fn():
        b = jconnect(HOST, port)
        d = jconnect(HOST, port + 1)
        b.recv_tensors(n=2)
        b.send_msg({"q": request_q, "clientID": 1})
        box["eof"] = b.sock.recv(1) == b""
        b.close()
        d.close()

    def server_fn():
        srv = _server("port", port, handshake_timeout=5.0)
        srv.init_server(_params())
        with pytest.raises((TimeoutError, RuntimeError)):
            srv.sync_server(_params(), timeout=5.0)
        box["evicted"] = set(srv.evicted)
        box["center"] = [t.clone() for t in srv.center]
        srv.close()

    _run_threads(server_fn, client_fn)
    assert box["evicted"] == {1} and box["eof"]
    assert all(not t.any() for t in box["center"])


def test_server_rejects_unsupported_codec_loudly():
    port = _ports()
    box = {}

    def bogus_client():
        b = jconnect(HOST, port)
        d = jconnect(HOST, port + 1)
        b.recv_tensors(n=2)
        b.send_msg({"q": "Enter?", "clientID": 1,
                    "wire": {"v": 1, "codec": "zstd"}})
        box["reply"] = d.recv_msg()
        b.close()
        d.close()

    def server_fn():
        srv = _server("port", port)
        srv.init_server(_params())
        with pytest.raises((RuntimeError, TimeoutError, ProtocolError)):
            srv.sync_server(_params(), timeout=5.0)
        box["evicted"] = set(srv.evicted)
        srv.close()

    _run_threads(server_fn, bogus_client)
    assert box["evicted"] == {1}
    reply = box["reply"]
    assert reply["a"] == "Enter" and "unsupported" in reply["wire"]["error"]


# ---------------------------------------------------------------------------
# 5. end to end against JAX: float64 MNIST CNN, raw codec

E2E_TAU, E2E_SYNCS, E2E_BATCH, E2E_LR, E2E_ALPHA = 2, 3, 8, 0.05, 0.2


def _e2e_batches():
    n = E2E_TAU * E2E_SYNCS
    x, y, _ = synthetic_mnist(n * E2E_BATCH, seed=4)
    x = x.astype(np.float64)
    return [(x[i * E2E_BATCH:(i + 1) * E2E_BATCH],
             y[i * E2E_BATCH:(i + 1) * E2E_BATCH]) for i in range(n)]


def _jax_pair(params0):
    """The JAX server and client: grad, sync, then the SGD update."""
    jm = jax_mnist(dtype=jnp.float64)

    @jax.jit
    def grad(p, x, y):
        return jax.grad(lambda q: jax_loss_fn(jm, q, {}, x, y)[0])(p)

    port = _ports()
    out = {}

    def client_fn():
        c = jea.AsyncEAClient(HOST, port, node=1, tau=E2E_TAU,
                              alpha=E2E_ALPHA, codec="raw")
        p = c.init_client(params0)
        for x, y in _e2e_batches():
            g = jax.tree_util.tree_map(np.asarray, grad(p, x, y))
            p, _ = c.sync_client(p)
            p = jax.tree_util.tree_map(lambda a, b: a - E2E_LR * b, p, g)
        out["params"] = p
        c.close()

    def server_fn():
        srv = jea.AsyncEAServer(HOST, port, num_nodes=1)
        srv.init_server(params0)
        for _ in range(E2E_SYNCS):
            srv.sync_server(params0)
        out["center"] = [t.copy() for t in srv.center]
        srv.close()

    _run_threads(server_fn, client_fn)
    return out


def _port_trio(params0):
    """The port's server, client and tester: the same loop, on the port's
    value_and_grad and SGD update."""
    model = mnist_cnn(torch.float64)
    port = _ports()
    out = {}

    def client_fn():
        c = pea.AsyncEAClient(HOST, port, node=1, tau=E2E_TAU,
                              alpha=E2E_ALPHA, codec="raw", device="cpu")
        p = c.init_client(params0)
        for x, y in _e2e_batches():
            _, _, _, g = trainer.value_and_grad(
                model, p, {}, torch.from_numpy(x), torch.from_numpy(y),
                None, None)
            p, _ = c.sync_client(p)
            p, _ = trainer.local_update(p, g, None, E2E_LR, 0.0)
        out["params"] = p
        c.close()

    def tester_fn():
        t = pea.AsyncEATester(HOST, port, num_nodes=1, codec="raw",
                              device="cpu")
        out["tested"] = t.start_test(params0)
        t.finish_test()
        t.close()

    def server_fn():
        srv = pea.AsyncEAServer(HOST, port, num_nodes=1, with_tester=True,
                                device="cpu")
        srv.init_server(params0)
        for _ in range(E2E_SYNCS):
            srv.sync_server(params0)
        out["pushed"] = srv.test_net()
        out["center"] = [t.clone() for t in srv.center]
        srv.close()

    _run_threads(server_fn, client_fn, tester_fn)
    return out


def test_end_to_end_float64_mnist_vs_jax():
    jp, _ = jax_mnist(dtype=jnp.float64).init(random.PRNGKey(5))
    jp = jax.tree_util.tree_map(np.asarray, jax.device_get(jp))
    want = _jax_pair(jp)
    tp = from_jax(jp, {})[0]
    got = _port_trio(tp)
    assert got["pushed"]
    center = to_jax(pea._rebuild(tp, got["center"]))
    for g, w in zip(jax.tree_util.tree_leaves(center), want["center"]):
        np.testing.assert_allclose(g, w, rtol=E2E_RTOL, atol=E2E_ATOL)
    for g, w in zip(jax.tree_util.tree_leaves(to_jax(got["params"])),
                    jax.tree_util.tree_leaves(want["params"])):
        np.testing.assert_allclose(g, w, rtol=E2E_RTOL, atol=E2E_ATOL)
    # the tester got the final center, bit for bit
    _assert_bitwise(tree_leaves(got["tested"]), got["center"])
    # the center moved: the comparison is not between two initial states
    assert not np.array_equal(want["center"][0],
                              jax.tree_util.tree_leaves(jp)[0])


# ---------------------------------------------------------------------------
# 6. the example's roles as threads

def test_example_trio_in_threads_int8():
    port = _ports()
    common = ["--numNodes", "2", "--port", str(port), "--model", "mnist",
              "--wireCodec", "int8", "--device", "cpu", "--batchSize", "8",
              "--communicationTime", "2", "--numEpochs", "2",
              "--numExamples", "64", "--testTime", "2"]
    # per client: 32 examples / batch 8 = 4 steps an epoch, 2 epochs, a
    # sync every 2 steps -> 4 syncs; 8 in all, 8 // 2 + 1 = 5 test pushes
    out = {}

    def role(name, kind, extra):
        return lambda: out.__setitem__(
            name, easgd.ROLES[kind](easgd.parse_role(kind, common + extra)))

    _run_threads(role("server", "server", ["--tester"]),
                 role("c1", "client", ["--nodeIndex", "1"]),
                 role("c2", "client", ["--nodeIndex", "2"]),
                 role("tester", "tester", ["--numTests", "5"]))
    assert out["server"] == {"served": 8, "tests": 5}
    assert len(out["tester"]["rounds"]) == 5
    for c in ("c1", "c2"):
        assert out[c]["syncs"] == 4 and len(out[c]["losses"]) == 8
        assert np.all(np.isfinite(out[c]["losses"]))
