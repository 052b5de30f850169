"""The port's fleet router (``distlearn_tpu_torch/serve/router.py``)
against the JAX package's tests (``tests/test_router.py``'s dispatch,
retry, shed, hedge, fence and counter cases, with the same scripted
wire-level fake replicas, here over the port's transport) and across the
packages: a JAX ``Router`` over port replicas, and a port ``Router`` over
a fleet of one JAX and one port replica.  Real replicas hold the JAX
params (``lm_from_jax``); every stream must equal JAX's
``greedy_generate``.
"""

from __future__ import annotations

import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from distlearn_tpu.models.transformer import greedy_generate as jax_greedy  # noqa: E402
from distlearn_tpu.models.transformer import transformer_lm as jax_lm  # noqa: E402
from distlearn_tpu_torch.comm import transport  # noqa: E402
from distlearn_tpu_torch.models.convert import lm_from_jax  # noqa: E402
from distlearn_tpu_torch.serve import (DecodeEngine, ReplicaDead, Router,  # noqa: E402
                                       RouterBusy, ServeError, ServeServer)

VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    params, _ = jax_lm(vocab=VOCAB, dim=DIM, depth=DEPTH, heads=HEADS,
                       max_len=MAX_LEN).init(jax.random.PRNGKey(0))
    return jax.device_get(params)


@pytest.fixture(scope="module")
def lm_params(jax_params):
    return lm_from_jax(jax_params)


def _greedy_ref(jax_params, prompt, steps):
    out = jax_greedy(jax_params, np.asarray(prompt, np.int32)[None], steps)
    return np.asarray(out)[0].tolist()


def _prompts(n, lo=3, hi=9, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _serve_server(lm_params, **kw):
    eng = DecodeEngine(lm_params, num_slots=kw.pop("num_slots", 2),
                       max_len=MAX_LEN, page=8, device="cpu")
    return ServeServer(eng, idle_wait=0.01, **kw).start()


def _jax_serve_server(jax_params, **kw):
    from distlearn_tpu.serve import DecodeEngine as JaxEngine
    from distlearn_tpu.serve import ServeServer as JaxServer
    eng = JaxEngine(jax_params, num_slots=kw.pop("num_slots", 2),
                    max_len=MAX_LEN, page=8)
    return JaxServer(eng, idle_wait=0.01, **kw).start()


# -- scripted wire-level replica ----------------------------------------------

class _FakeReplica:
    """A replica that answers 'J' probes with a healthy snapshot and runs a
    scripted ``behavior(conn, msg, self)`` on each 'G' frame (the JAX
    test's, over the port's transport)."""

    def __init__(self, behavior, *, epoch=1, health=None):
        self.behavior = behavior
        self.epoch = epoch
        self.health_extra = dict(health or {})
        self.srv = transport.Server()
        self.host, self.port = self.srv.host, self.srv.port
        self.name = f"{self.host}:{self.port}"
        self.seen_gen = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                (conn,) = self.srv.accept(1, timeout=0.05)
            except (TimeoutError, OSError):
                continue
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn):
        while not self._stop.is_set():
            try:
                kind, msg = conn.recv_serve(
                    deadline=time.monotonic() + 0.05)
            except TimeoutError:
                continue
            except Exception:  # noqa: BLE001 — peer gone, conn done
                return
            if kind == "J":
                conn.send_msg({"serving": True, "failed": None,
                               "draining": False, "queue_depth": 0,
                               "active": 0, "epoch": self.epoch,
                               **self.health_extra})
            elif kind == "G":
                self.seen_gen += 1
                try:
                    if self.behavior(conn, msg, self):
                        return
                except OSError:
                    return

    def close(self):
        self._stop.set()
        self.srv.close()
        self._thread.join(5.0)


def _die_on_gen(conn, msg, rep):
    conn.close()
    return True


def _stall_on_gen(conn, msg, rep):
    return False


def _shed_on_gen(conn, msg, rep):
    conn.send_stream({"rid": msg.get("rid", ""), "done": True,
                      "error": "admission queue at capacity (1)",
                      "queue_depth": 3, "retry_after": 0.2,
                      "epoch": rep.epoch})
    return False


def _reject_on_gen(conn, msg, rep):
    conn.send_stream({"rid": msg.get("rid", ""), "done": True,
                      "error": "prompt + max_new exceeds max_len",
                      "epoch": rep.epoch})
    return False


def _die_mid_stream(conn, msg, rep):
    conn.send_stream({"rid": msg.get("rid", ""), "tokens": [5],
                      "done": False, "epoch": rep.epoch})
    conn.close()
    return True


def _fence_mid_stream(conn, msg, rep):
    conn.send_stream({"rid": msg.get("rid", ""), "tokens": [5],
                      "done": False, "epoch": rep.epoch})
    conn.send_stream({"rid": msg.get("rid", ""), "tokens": [6],
                      "done": False, "epoch": rep.epoch + 1})
    return False


def _router(replicas, router_cls=Router, **kw):
    kw.setdefault("health_ttl", 0.02)
    kw.setdefault("retry_interval", 0.01)
    kw.setdefault("dial_deadline", 1.0)
    return router_cls([(r.host, r.port) for r in replicas], **kw)


# -- real fleet: parity and introspection -------------------------------------

def test_router_fleet_parity_and_health(lm_params, jax_params):
    prompts = _prompts(4, seed=5)
    max_new = 6
    refs = [_greedy_ref(jax_params, p, max_new) for p in prompts]
    a = _serve_server(lm_params, max_queue=8)
    b = _serve_server(lm_params, max_queue=8)
    try:
        with _router([a, b]) as router:
            names = {f"{a.host}:{a.port}", f"{b.host}:{b.port}"}
            for i, p in enumerate(prompts):
                r = router.generate(p, max_new, rid=f"r{i}")
                assert r["tokens"] == refs[i]
                assert r["reason"] == "complete"
                assert r["replica"] in names
            h = router.health()
            assert h["serving"] and h["live"] == 2
            assert len(h["replicas"]) == 2
    finally:
        a.stop()
        b.stop()


def test_router_requires_replicas_and_unique_addresses():
    with pytest.raises(ValueError):
        Router([])
    with pytest.raises(ValueError):
        Router([("h", 1), ("h", 1)])


# -- retry on death -----------------------------------------------------------

def test_router_resubmits_queued_request_on_replica_death(lm_params,
                                                          jax_params):
    dead = _FakeReplica(_die_on_gen)
    real = _serve_server(lm_params)
    try:
        with _router([dead, real]) as router:
            p = _prompts(1, seed=3)[0]
            r = router.generate(p, 4, rid="x")
            assert r["reason"] == "complete"
            assert r["tokens"] == _greedy_ref(jax_params, p, 4)
            assert r["replica"] == f"{real.host}:{real.port}"
            assert dead.seen_gen == 1
    finally:
        dead.close()
        real.stop()


def test_router_all_replicas_dead_raises_replicadead():
    a, b = _FakeReplica(_die_on_gen), _FakeReplica(_die_on_gen)
    try:
        with _router([a, b]) as router:
            with pytest.raises(ReplicaDead, match="replicas tried"):
                router.generate([1, 2, 3], 4, rid="x")
        assert a.seen_gen == 1 and b.seen_gen == 1
    finally:
        a.close()
        b.close()


def test_router_no_listener_raises_replicadead_fast():
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with Router([("127.0.0.1", port)], health_ttl=0.01,
                retry_interval=0.01, max_interval=0.05, max_attempts=2,
                dial_deadline=0.2) as router:
        with pytest.raises(ReplicaDead):
            router.generate([1, 2, 3], 4, timeout=10.0)


def test_router_mid_stream_death_is_clean_terminal_failure(lm_params):
    dying = _FakeReplica(_die_mid_stream)
    real = _serve_server(lm_params)
    try:
        with _router([dying, real]) as router:
            r = router.generate([1, 2, 3], 4, rid="x")
            assert r["reason"] == "failed"
            assert r["tokens"] == [5]
            assert "died mid-stream" in r["error"]
            assert r["replica"] == dying.name
    finally:
        dying.close()
        real.stop()


# -- load shedding ------------------------------------------------------------

def test_router_sheds_at_watermark_without_dispatching():
    busy = _FakeReplica(_stall_on_gen, health={"queue_depth": 5})
    try:
        with _router([busy], shed_watermark=4) as router:
            with pytest.raises(RouterBusy) as ei:
                router.generate([1, 2, 3], 4)
            assert ei.value.retry_after and ei.value.retry_after > 0
            assert ei.value.queue_depth == 5
            assert busy.seen_gen == 0
    finally:
        busy.close()


def test_router_surfaces_replica_shed_as_busy():
    a, b = _FakeReplica(_shed_on_gen), _FakeReplica(_shed_on_gen)
    try:
        with _router([a, b]) as router:
            with pytest.raises(RouterBusy, match="every replica shed") as ei:
                router.generate([1, 2, 3], 4, rid="x")
            assert ei.value.retry_after == pytest.approx(0.2)
        assert a.seen_gen == 1 and b.seen_gen == 1
    finally:
        a.close()
        b.close()


def test_router_nonretryable_rejection_raises_serveerror_once():
    a, b = _FakeReplica(_reject_on_gen), _FakeReplica(_reject_on_gen)
    try:
        with _router([a, b]) as router:
            with pytest.raises(ServeError, match="max_len") as ei:
                router.generate([1, 2, 3], 4, rid="x")
            assert not isinstance(ei.value, RouterBusy)
        assert a.seen_gen + b.seen_gen == 1
    finally:
        a.close()
        b.close()


# -- hedging ------------------------------------------------------------------

def test_router_hedges_off_stalled_replica(lm_params, jax_params):
    stalled = _FakeReplica(_stall_on_gen)
    real = _serve_server(lm_params)
    try:
        with _router([stalled, real], hedge_after=0.1) as router:
            p = _prompts(1, seed=11)[0]
            t0 = time.monotonic()
            r = router.generate(p, 4, rid="x", timeout=30.0)
            assert r["reason"] == "complete"
            assert r["tokens"] == _greedy_ref(jax_params, p, 4)
            assert r["replica"] == f"{real.host}:{real.port}"
            assert stalled.seen_gen == 1
            assert time.monotonic() - t0 < 20.0
    finally:
        stalled.close()
        real.stop()


def test_router_hedge_disarmed_without_alternative():
    stalled = _FakeReplica(_stall_on_gen)
    try:
        with _router([stalled], hedge_after=0.05) as router:
            with pytest.raises(TimeoutError):
                router.generate([1, 2, 3], 4, rid="x", timeout=1.0)
        assert stalled.seen_gen == 1
    finally:
        stalled.close()


# -- epoch fence --------------------------------------------------------------

def test_router_epoch_fence_terminates_mixed_stream():
    fencer = _FakeReplica(_fence_mid_stream)
    try:
        with _router([fencer]) as router:
            r = router.generate([1, 2, 3], 4, rid="x")
            assert r["reason"] == "failed"
            assert "epoch fence" in r["error"]
            assert r["tokens"] == [5]
            assert r["epoch"] == 1
    finally:
        fencer.close()


def test_router_health_reports_mixed_fleet_epochs():
    a = _FakeReplica(_stall_on_gen, epoch=3)
    b = _FakeReplica(_stall_on_gen, epoch=4)
    try:
        with _router([a, b]) as router:
            h = router.health()
            assert h["epochs"] == [3, 4]
            assert h["live"] == 2
    finally:
        a.close()
        b.close()


# -- observability ------------------------------------------------------------

def test_router_counters_record_the_walk(lm_params):
    from distlearn_tpu_torch.obs import core
    core.configure(True)
    core.REGISTRY.reset()
    try:
        dead = _FakeReplica(_die_on_gen)
        real = _serve_server(lm_params)
        try:
            with _router([dead, real]) as router:
                r = router.generate(_prompts(1, seed=3)[0], 4, rid="x")
                assert r["reason"] == "complete"
        finally:
            dead.close()
            real.stop()
        snap = core.REGISTRY.snapshot()

        def fam(name):
            for f in snap:
                if f["name"] == name:
                    return {tuple(sorted(s["labels"].items())): s["value"]
                            for s in f["samples"]}
            return {}

        dispatch = fam("router_dispatch_total")
        assert sum(dispatch.values()) == 2
        retries = fam("router_retries_total")
        assert retries == {(("replica", dead.name),): 1}
        hist = next(f for f in snap
                    if f["name"] == "router_failover_seconds")
        assert sum(s["count"] for s in hist["samples"]) == 1
    finally:
        core.REGISTRY.reset()
        core.configure(None)


# -- across the packages ------------------------------------------------------

def test_jax_router_over_port_replicas(lm_params, jax_params):
    """The JAX package's Router fronts two port replicas: its 'G' frames,
    'J' probes and 'R' chunks are the port's, byte for byte."""
    from distlearn_tpu.serve import Router as JaxRouter
    prompts = _prompts(4, seed=6)
    a = _serve_server(lm_params, max_queue=8, epoch=1)
    b = _serve_server(lm_params, max_queue=8, epoch=1)
    try:
        with _router([a, b], router_cls=JaxRouter) as router:
            got = [router.generate(p, 5, rid=f"j{i}")
                   for i, p in enumerate(prompts)]
            h = router.health()
        assert [r["tokens"] for r in got] == \
            [_greedy_ref(jax_params, p, 5) for p in prompts]
        assert all(r["reason"] == "complete" and r["epoch"] == 1
                   for r in got)
        assert h["live"] == 2 and h["epochs"] == [1]
    finally:
        a.stop()
        b.stop()


def test_port_router_over_a_mixed_fleet(lm_params, jax_params):
    """The port's Router over one JAX and one port replica: every stream
    is greedy_generate's on whichever package serves it; the first request
    goes to the JAX replica (both idle, ties break by list order), and
    once that replica is gone the next lands on the port's."""
    jx = _jax_serve_server(jax_params, max_queue=8, epoch=1)
    pt = _serve_server(lm_params, max_queue=8, epoch=1)
    prompts = _prompts(4, seed=7)
    try:
        with _router([jx, pt]) as router:
            assert router.health()["live"] == 2
            got = [router.generate(p, 5, rid=f"m{i}", timeout=60)
                   for i, p in enumerate(prompts)]
            assert [r["tokens"] for r in got] == \
                [_greedy_ref(jax_params, p, 5) for p in prompts]
            assert got[0]["replica"] == f"{jx.host}:{jx.port}"
            jx.stop()
            r = router.generate(prompts[1], 5, rid="after", timeout=60)
            assert r["replica"] == f"{pt.host}:{pt.port}"
            assert r["tokens"] == got[1]["tokens"]
    finally:
        jx.stop()
        pt.stop()


def test_serve_fleet_example_on_the_cpu(capsys):
    """``examples/serve_fleet.py --device cpu``: the JAX demo's three acts
    (steady traffic, a replica killed mid-traffic, an epoch-fenced hot
    swap) over the port's fleet."""
    from distlearn_tpu_torch.examples import serve_fleet
    assert serve_fleet.main(["--device", "cpu", "--requests", "4",
                             "--maxNew", "6"]) == 0
    out = capsys.readouterr().out
    assert "[steady] 4/4 complete" in out
    assert "[post hot-swap] 4/4 complete" in out and "epochs=[2]" in out
    assert "done: fleet survived" in out
