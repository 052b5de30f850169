"""The port's concurrent AsyncEA server, overlap and rejoin against the JAX
package's (tests/test_async_ea.py and tests/test_async_ea_wire.py replayed
on the port), over real localhost sockets with the roles as threads, on the
CPU:

* overlap: one overlapped sync and six overlapped rounds bit for bit the
  serial client's and the JAX package's;
* rejoin: an evicted client rejoins the serial and the concurrent server
  and syncs with exact math (the same values as the JAX run), renegotiating
  the packed wire; a half-sent frame cannot wedge either server and an
  admitted client's stall becomes an eviction it recovers from; the
  dispatcher's eviction leaves the parked worker serving the fresh conn; a
  silent rejoiner is swept at its deadline;
* the concurrent server: overlapped syncs of three clients accumulate
  exactly; the center on the server's device; a dead client evicted while
  the others continue; the serial API on the concurrent class; two clients
  hammering the serial server; a worker's unexpected failure re-raised by
  ``stop()``; no GPU and no device raises;
* the example's trio as threads: ``--concurrent --shards 2
  --overlapSync``, int8, mnist, with a tester.
"""

import struct
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from distlearn_tpu.comm import connect as jconnect  # noqa: E402
from distlearn_tpu_torch.examples import easgd  # noqa: E402
from distlearn_tpu_torch.parallel import async_ea as pea  # noqa: E402

from tests import torch_async_util as U  # noqa: E402

HOST = U.HOST


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _wb(pkg):
    return U.tree(pkg, {"w": np.zeros((4, 3), np.float32),
                        "b": np.zeros((3,), np.float32)})


# ---------------------------------------------------------------------------
# Overlap (tests/test_async_ea_wire.py)

def _overlap_rounds(pkg, overlap, rounds, codec="raw"):
    port = U.ports()
    out = {}

    def client_fn():
        c = U.client(pkg, port, codec=codec, overlap=overlap)
        p = c.init_client(_wb(pkg))
        for r in range(rounds):
            p, synced = c.sync_client(U.drift(p, r))
            assert synced
        out["p"] = [U.as_np(p[k]).copy() for k in sorted(p)]
        c.close()

    def server_fn():
        srv = U.server(pkg, port, 1)
        srv.init_server(_wb(pkg))
        for _ in range(rounds):
            srv.sync_server(_wb(pkg))
        out["center"] = [np.array(U.as_np(t)) for t in srv.center]
        srv.close()

    U.run_threads(server_fn, client_fn)
    return out


def test_overlap_sync_math_unchanged():
    """The background sender does not change the EASGD math."""
    out = _overlap_rounds("port", True, 1)
    for t in out["center"] + out["p"]:
        np.testing.assert_array_equal(t, np.full_like(t, 0.125))


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_overlap_multi_round_accumulation(codec):
    """Six overlapped rounds: every delta lands exactly once — bit for bit
    the same loop without overlap, and the JAX package's overlapped run."""
    got = _overlap_rounds("port", True, 6, codec)
    U.assert_bitwise(got["center"], _overlap_rounds("port", False, 6,
                                                    codec)["center"])
    want = _overlap_rounds("jax", True, 6, codec)
    U.assert_bitwise(got["center"], want["center"])
    U.assert_bitwise(got["p"], want["p"])


# ---------------------------------------------------------------------------
# Rejoin (tests/test_async_ea.py)

def _live_client_fn(port, out, delay=0.0, before=None, after=None):
    """Client #1: dial after ``delay``, then one sync (+1 on ``w``).  The
    sync waits for ``before`` and sets ``after`` once served, so a test
    orders it against the other roles by events, not by sleeps."""
    def run():
        time.sleep(delay)
        c = U.client("port", port, node=1)
        p = c.init_client(_wb("port"))
        if before is not None:
            assert before.wait(timeout=60), "the other role never got ahead"
        p, out["synced"] = c.sync_client({"w": p["w"] + 1.0,
                                          "b": p["b"] + 2.0})
        out["p"] = p
        if after is not None:
            after.set()
        c.close()
    return run


def _serve_until(srv, params, timeout=30.0):
    """``sync_server`` until it serves one sync, riding out the outage
    windows (no open conn, no request) a rejoin goes through."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return srv.sync_server(params, timeout=5.0)
        except (RuntimeError, TimeoutError):
            assert time.monotonic() < deadline, "rejoin never served"
            time.sleep(0.05)


def test_evicted_client_rejoins_and_syncs_serial():
    """Client #2 hangs mid-handshake and is evicted, then REJOINS — fresh
    channels, Rejoin?, the current center — and syncs; the math stays exact
    across the cycle."""
    port = U.ports()
    out = {}
    evicted, admitted = threading.Event(), threading.Event()

    def flaky_fn():
        c = U.client("port", port, node=2)
        c.init_client(_wb("port"))
        c.broadcast.send_msg({"q": "Enter?", "clientID": 2})
        c.conn.recv_msg()                 # Enter, then silence -> eviction
        admitted.set()                    # only now may #1 ask
        evicted.wait(timeout=60)
        p = c.rejoin(_wb("port"))
        out["after_rejoin"] = p["w"].clone()
        p, out["synced2"] = c.sync_client({"w": p["w"] + 2.0,
                                           "b": p["b"] + 2.0})
        out["p2"] = p
        c.close()

    def server_fn():
        srv = U.server("port", port, 2, handshake_timeout=0.5)
        srv.init_server(_wb("port"))
        srv.sync_server(_wb("port"))        # evicts #2, serves #1
        assert 2 in srv.evicted
        evicted.set()
        out["new"] = _serve_until(srv, _wb("port"))
        out["evicted"], out["live"] = set(srv.evicted), srv.live_clients
        srv.close()

    U.run_threads(server_fn, flaky_fn,
                  _live_client_fn(port, out, 0.5, before=admitted))
    assert out["evicted"] == set() and out["live"] == 2 and out["synced2"]
    # client 1: w 0 -> 0.5.  The rejoiner takes 0.5, drifts +2 -> 2.5,
    # delta (2.5 - 0.5) * 0.5 = 1.0: center and params 1.5
    assert torch.equal(out["after_rejoin"], torch.full((4, 3), 0.5))
    assert torch.equal(out["p2"]["w"], torch.full((4, 3), 1.5))
    assert torch.equal(out["new"]["w"], torch.full((4, 3), 1.5))


def test_rejoin_renegotiates_packed_wire():
    """Rejoin re-runs the wire negotiation on the fresh channels and
    drains the overlap state; the math stays exact."""
    port = U.ports()
    out = {}
    evicted = threading.Event()

    def flaky_fn():
        c = U.client("port", port, codec="raw", overlap=True)
        c.init_client(_wb("port"))
        c.broadcast.send_msg({"q": pea.ENTER_Q, "clientID": 1})
        evicted.wait(timeout=60)
        p = c.rejoin(_wb("port"))
        out["packed"] = c._packed
        p, out["synced"] = c.sync_client({"w": p["w"] + 2.0,
                                          "b": p["b"] + 2.0})
        out["p"] = p
        c.close()

    def server_fn():
        srv = U.server("port", port, 1, handshake_timeout=0.5)
        srv.init_server(_wb("port"))
        with pytest.raises((RuntimeError, TimeoutError)):
            srv.sync_server(_wb("port"), timeout=5.0)
        assert 1 in srv.evicted
        evicted.set()
        out["new"] = _serve_until(srv, _wb("port"))
        srv.close()

    U.run_threads(server_fn, flaky_fn)
    assert out["synced"] and out["packed"] is True
    assert torch.equal(out["p"]["w"], torch.full((4, 3), 1.0))
    assert torch.equal(out["new"]["w"], torch.full((4, 3), 1.0))


def _w8(pkg):
    return U.tree(pkg, {"w": np.zeros(8, np.float32)})


def _rejoin_concurrent(pkg):
    """test_evicted_client_rejoins_concurrent_server's fleet on ``pkg``:
    returns the rejoiner's params and the final center."""
    port = U.ports()
    evicted = threading.Event()
    out = {}

    def flaky_fn():
        c = U.client(pkg, port, node=2)
        c.init_client(_w8(pkg))
        c.broadcast.send_msg({"q": "Enter?", "clientID": 2})
        c.conn.recv_msg()                 # Enter, then silence -> eviction
        evicted.wait(timeout=60)
        p = c.rejoin(_w8(pkg))
        p, out["synced"] = c.sync_client({"w": p["w"] + 2.0})
        out["p"] = U.as_np(p["w"]).copy()
        c.close()

    def good_fn():
        c = U.client(pkg, port, node=1)
        p = c.init_client(_w8(pkg))
        c.sync_client({"w": p["w"] + 2.0})      # center 0 -> 1.0
        c.close()

    def server_fn():
        srv = U.server(pkg, port, 2, concurrent=True, handshake_timeout=0.5,
                       rejoin_grace=30.0)
        srv.init_server(_w8(pkg))
        srv.start()
        U.wait_for(lambda: 2 in srv.evicted and srv.syncs_completed >= 1,
                   30, "the eviction")
        evicted.set()
        U.wait_for(lambda: srv.syncs_completed >= 2, 60, "the rejoiner")
        out["center"] = U.as_np(srv.current_center(_w8(pkg))["w"]).copy()
        out["evicted"] = set(srv.evicted)
        srv.stop()
        srv.close()

    U.run_threads(server_fn, flaky_fn, good_fn)
    return out


def test_evicted_client_rejoins_concurrent_server():
    """The worker that evicted has returned; the rejoin respawns one and
    the accumulation stays exact — the JAX package's values."""
    got = _rejoin_concurrent("port")
    want = _rejoin_concurrent("jax")
    assert got["synced"] and got["evicted"] == set()
    np.testing.assert_array_equal(got["p"], np.full(8, 2.0, np.float32))
    U.assert_bitwise([got["p"], got["center"]], [want["p"], want["center"]])


def test_partial_frame_client_cannot_wedge_server():
    """Client #2 sends HALF a frame header on the broadcast channel and
    stalls; the bounded frame read drops it and the server serves #1."""
    port = U.ports()
    out = {}
    release = threading.Event()

    def partial_fn():
        b = jconnect(HOST, port)
        d = jconnect(HOST, port + 2)
        b.sock.sendall(struct.pack("<BQ", ord("J"), 64)[:5])
        release.wait(timeout=60)
        b.close()
        d.close()

    def server_fn():
        srv = U.server("port", port, 2, handshake_timeout=0.5)
        srv.init_server(_wb("port"))
        t0 = time.monotonic()
        out["new"] = srv.sync_server(_wb("port"))
        out["t"] = time.monotonic() - t0
        release.set()
        srv.close()

    U.run_threads(server_fn, partial_fn, _live_client_fn(port, out, 0.5))
    assert out["t"] < 20 and out["synced"]
    assert torch.equal(out["new"]["w"], torch.full((4, 3), 0.5))


def test_admitted_client_frame_stall_becomes_eviction_then_rejoins():
    """An ADMITTED client whose broadcast stream stalls mid-frame is cut by
    the frame timeout, recorded as a real eviction, and rejoins."""
    port = U.ports()
    out = {}
    stalled, live_synced = threading.Event(), threading.Event()

    def flaky_fn():
        c = U.client("port", port, node=2)
        p = c.init_client(_wb("port"))
        p, synced = c.sync_client({"w": p["w"] + 2.0, "b": p["b"]})
        assert synced
        # #1's sync is served before the stall, so the server's next
        # served sync after the eviction is the rejoiner's
        assert live_synced.wait(timeout=60)
        c.broadcast.sock.sendall(struct.pack("<BQ", ord("J"), 64)[:5])
        stalled.wait(timeout=60)
        p = c.rejoin(_wb("port"))
        p, out["synced2"] = c.sync_client({"w": p["w"] + 2.0, "b": p["b"]})
        c.close()

    def server_fn():
        srv = U.server("port", port, 2, handshake_timeout=0.5)
        srv.init_server(_wb("port"))
        srv.sync_server(_wb("port"))
        deadline = time.monotonic() + 30
        while 2 not in srv.evicted:
            assert time.monotonic() < deadline, "stall never evicted"
            try:
                srv.sync_server(_wb("port"), timeout=2.0)
            except (RuntimeError, TimeoutError):
                time.sleep(0.05)
        stalled.set()
        out["new"] = _serve_until(srv, _wb("port"))
        out["evicted"] = set(srv.evicted)
        srv.close()

    U.run_threads(server_fn, flaky_fn,
                  _live_client_fn(port, out, 1.0, after=live_synced))
    assert out["evicted"] == set() and out["synced2"]
    assert torch.isfinite(out["new"]["w"]).all()


def test_concurrent_dispatcher_evict_then_rejoin_serves_fresh_conn():
    """A dispatcher-side eviction never unparks the client's worker; after
    the rejoin the SAME parked worker serves the FRESH dedicated conn."""
    port = U.ports()
    evicted = threading.Event()
    out = {}

    def flaky_fn():
        c = U.client("port", port)
        p = c.init_client(_w8("port"))
        p, synced = c.sync_client({"w": p["w"] + 2.0})
        assert synced
        c.broadcast.sock.sendall(struct.pack("<BQ", ord("J"), 64)[:5])
        evicted.wait(timeout=60)
        p = c.rejoin(_w8("port"))
        p, out["synced"] = c.sync_client({"w": p["w"] + 2.0})
        c.close()

    def server_fn():
        srv = U.server("port", port, 1, concurrent=True,
                       handshake_timeout=0.5, rejoin_grace=30.0)
        srv.init_server(_w8("port"))
        srv.start()
        U.wait_for(lambda: 1 in srv.evicted, 30, "the eviction")
        evicted.set()
        U.wait_for(lambda: srv.syncs_completed >= 2, 60, "the rejoiner")
        out["center"] = srv.current_center(_w8("port"))["w"]
        out["evicted"] = set(srv.evicted)
        srv.stop()
        srv.close()

    U.run_threads(server_fn, flaky_fn)
    assert out["synced"] and out["evicted"] == set()
    # 0 + 1.0, then the rejoiner takes 1.0, drifts +2: delta 1 -> 2.0
    assert torch.equal(out["center"], torch.full((8,), 2.0))


def test_silent_rejoiner_conn_swept_after_deadline():
    """A rejoiner that dials the broadcast port but never speaks is closed
    once its speak-by deadline passes."""
    import socket
    port = U.ports()
    out = {}
    asked = threading.Event()

    def hung_fn():
        b = jconnect(HOST, port)
        d = jconnect(HOST, port + 2)
        b.send_msg({"q": "Enter?", "clientID": 2})
        asked.set()
        time.sleep(8)
        b.close()
        d.close()

    def server_fn():
        srv = U.server("port", port, 2, handshake_timeout=0.4)
        srv.init_server(_wb("port"))
        srv.sync_server(_wb("port"))       # evicts #2, serves #1
        assert 2 in srv.evicted
        s = socket.create_connection((HOST, port))
        srv._accept_rejoiners()
        out["pending"] = len(srv._rejoin_pending)
        time.sleep(0.5)                    # past the speak-by deadline
        srv._accept_rejoiners()
        out["after"] = list(srv._rejoin_pending)
        s.close()
        srv.close()

    U.run_threads(server_fn, hung_fn,
                  _live_client_fn(port, out, 0.3, before=asked))
    assert out["pending"] == 1 and out["after"] == [] and out["synced"]


# ---------------------------------------------------------------------------
# The concurrent server (tests/test_async_ea.py)

def _accumulation(n_clients=3, rounds=4, shards=1):
    """N clients sync concurrently through per-client workers (and stripe
    workers for ``shards`` > 1); integer drifts with alpha 0.5 keep every
    value dyadic, so the center must be exactly init + the sum of every
    pushed delta in any order."""
    port = U.ports(n_clients + shards + 4)
    pushed = []
    lock = threading.Lock()
    out = {}

    def client_fn(node):
        def run():
            c = U.client("port", port, node=node)
            p = c.init_client({"w": torch.zeros(64)})
            rng = np.random.RandomState(node)
            for _ in range(rounds):
                p = {"w": p["w"] + torch.from_numpy(
                    rng.randint(-4, 5, 64).astype(np.float32) * 2.0)}
                before = p["w"].clone()
                p, synced = c.sync_client(p)
                assert synced
                with lock:
                    pushed.append(((before - c.center[0]) * 0.5).numpy())
            c.close()
        return run

    def server_fn():
        srv = U.server("port", port, n_clients, concurrent=True,
                       accept_timeout=60.0, shards=shards)
        srv.init_server({"w": torch.zeros(64)})
        srv.start()
        # a striped sync is counted when stripe 0 lands (as in the JAX
        # server), so also wait out the other stripes' legs in flight
        U.wait_for(lambda: srv.syncs_completed >= n_clients * rounds
                   and srv.drained, 60, "every sync")
        out["slab_device"] = srv._slab.dev.device
        out["center"] = srv.current_center({"w": torch.zeros(64)})["w"]
        srv.stop()
        srv.close()

    U.run_threads(server_fn, *[client_fn(i + 1) for i in range(n_clients)])
    np.testing.assert_array_equal(out["center"].numpy(),
                                  np.sum(pushed, axis=0))
    return out


def test_concurrent_server_overlapped_syncs_accumulate_exactly():
    _accumulation()


def test_concurrent_striped_stress_accumulates_exactly():
    """More client threads than cores on an S = 4 center (the one leaf cut
    into 4 chunks, so 8 workers and 24 stripe workers share 4 stripe
    locks) with a shortened thread switch interval: a lost or torn stripe
    apply would break the exact sum."""
    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        _accumulation(n_clients=8, rounds=3, shards=4)
    finally:
        sys.setswitchinterval(old)


def test_concurrent_server_device_pinned_center():
    """The center lives in the server's device slab (the CPU here; the
    card in chip_smoke.py phase 8a), snapshots and accumulation exact."""
    out = _accumulation(n_clients=2, rounds=3)
    assert out["slab_device"] == torch.device("cpu")


def test_concurrent_server_evicts_dead_client_others_continue():
    port = U.ports()
    out = {}

    def good_fn():
        c = U.client("port", port, node=1)
        p = c.init_client({"w": torch.zeros(32)})
        for _ in range(3):
            p, _ = c.sync_client({"w": p["w"] + 2.0})
        c.close()

    def dying_fn():
        c = U.client("port", port, node=2)
        c.init_client({"w": torch.zeros(32)})
        c.broadcast.send_msg({"q": "Enter?", "clientID": 2})
        c.conn.recv_msg()
        c.close()                       # die before Center?

    def server_fn():
        srv = U.server("port", port, 2, concurrent=True, accept_timeout=60.0,
                       handshake_timeout=20.0)
        srv.init_server({"w": torch.zeros(32)})
        srv.start()
        U.wait_for(lambda: srv.syncs_completed >= 3 and 2 in srv.evicted,
                   60, "the good client's syncs")
        out["syncs"], out["evicted"] = srv.syncs_completed, set(srv.evicted)
        srv.stop()
        srv.close()

    U.run_threads(server_fn, good_fn, dying_fn)
    assert out["syncs"] == 3 and out["evicted"] == {2}


def test_concurrent_server_serial_api_still_works():
    port = U.ports()
    out = {}

    def client_fn():
        c = U.client("port", port)
        p = c.init_client({"w": torch.zeros(8)})
        p, out["synced"] = c.sync_client({"w": p["w"] + 2.0})
        c.close()

    def server_fn():
        srv = U.server("port", port, 1, concurrent=True, accept_timeout=60.0)
        srv.init_server({"w": torch.zeros(8)})
        out["got"] = srv.sync_server({"w": torch.zeros(8)})
        out["syncs"] = srv.syncs_completed
        srv.close()

    U.run_threads(server_fn, client_fn)
    assert out["synced"] and out["syncs"] == 1
    assert torch.equal(out["got"]["w"], torch.full((8,), 1.0))


def test_concurrent_clients_serialized_and_consistent():
    """Two clients hammer the serial server; every delta lands on the
    center exactly once (the center is the sum of the deltas sent)."""
    port = U.ports()
    rounds = 8
    rng = np.random.RandomState(0)
    drifts = {1: rng.randn(rounds).astype(np.float32),
              2: rng.randn(rounds).astype(np.float32)}
    sent = []
    lock = threading.Lock()
    out = {}

    def client_fn(node):
        def run():
            c = U.client("port", port, node=node)
            p = c.init_client({"w": torch.zeros((2, 2))})
            for r in range(rounds):
                p = {"w": p["w"] + float(drifts[node][r])}
                before = p["w"].clone()
                p, synced = c.sync_client(p)
                assert synced
                with lock:
                    sent.append((before - p["w"]).numpy())
            c.close()
        return run

    def server_fn():
        srv = U.server("port", port, 2)
        srv.init_server({"w": torch.zeros((2, 2))})
        for _ in range(2 * rounds):
            srv.sync_server({"w": torch.zeros((2, 2))})
        out["center"] = srv.center[0].clone()
        srv.close()

    U.run_threads(server_fn, client_fn(1), client_fn(2))
    np.testing.assert_allclose(out["center"].numpy(), np.sum(sent, axis=0),
                               rtol=1e-5, atol=1e-5)


def test_worker_failure_surfaces_at_stop(monkeypatch):
    """A failure inside a worker that is not the client's fault (here the
    apply raising) is not swallowed: ``stop()`` re-raises it."""
    port = U.ports()
    out = {}

    def boom(*_a, **_k):
        raise RuntimeError("apply failed")

    def client_fn():
        c = U.client("port", port)
        p = c.init_client({"w": torch.zeros(8)})
        c.sync_client({"w": p["w"] + 2.0})
        c.close()

    def server_fn():
        srv = U.server("port", port, 1, concurrent=True)
        srv.init_server({"w": torch.zeros(8)})
        monkeypatch.setattr(srv, "_apply_delta", boom)
        srv.start()
        U.wait_for(lambda: srv._errors, 30, "the worker failure")
        with pytest.raises(RuntimeError, match="apply failed"):
            srv.stop()
        out["done"] = True
        srv.close()

    U.run_threads(server_fn, client_fn)
    assert out["done"]


def test_new_roles_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port = U.ports()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pea.AsyncEAServerConcurrent(HOST, port, 1, standby=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pea.AsyncEAClient.join(HOST, port, {"w": torch.zeros(2)}, 1, 0.5)


# ---------------------------------------------------------------------------
# The example's trio as threads

def test_example_concurrent_striped_overlapped_trio():
    port = U.ports()
    common = ["--numNodes", "2", "--port", str(port), "--model", "mnist",
              "--wireCodec", "int8", "--device", "cpu", "--batchSize", "16",
              "--communicationTime", "2", "--numEpochs", "1",
              "--numExamples", "128", "--testTime", "4", "--shards", "2",
              "--overlapSync"]
    out = {}

    def role(name, kind, extra):
        def run():
            out[name] = easgd.ROLES[kind](easgd.parse_role(kind,
                                                           common + extra))
        return run

    # 2 clients x 64 examples / batch 16 = 4 steps, tau 2: 2 syncs each
    U.run_threads(role("server", "server", ["--concurrent", "--tester"]),
                  role("c1", "client", ["--nodeIndex", "1"]),
                  role("c2", "client", ["--nodeIndex", "2"]),
                  role("tester", "tester", ["--numTests", "2"]))
    assert out["server"]["served"] == 4 and out["server"]["tests"] == 2
    assert out["server"]["ledger"] == {1: [2, 2], 2: [2, 2]}
    for c in ("c1", "c2"):
        assert out[c]["syncs"] == 2 and len(out[c]["losses"]) == 4
        assert all(np.isfinite(out[c]["losses"]))
    assert len(out["tester"]["rounds"]) == 2
