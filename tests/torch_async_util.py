"""Fleet helpers shared by the port's AsyncEA fleet tests
(``tests/test_torch_async_ea_*.py``, ``test_torch_elastic.py``,
``test_torch_ha.py``): roles of either package behind one call shape
(``pkg`` is ``"port"`` — the port's roles with ``device="cpu"`` — or
``"jax"``), thread runners with bounded joins, and the fleet lifecycle of
``tools/chaos.py`` (spawn, settle, kill and promote, teardown) for both
packages."""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from distlearn_tpu.parallel import async_ea as jea
from distlearn_tpu.parallel import ha as jha
from distlearn_tpu.utils.logging import set_verbose as jset_verbose
from distlearn_tpu_torch.comm import ProtocolError
from distlearn_tpu_torch.parallel import async_ea as pea
from distlearn_tpu_torch.parallel import ha as pha
from distlearn_tpu_torch.utils.logging import set_verbose

from tests.net_util import reserve_port_window

set_verbose(False)
jset_verbose(False)

HOST = "127.0.0.1"
JOIN_S = 60.0
SETTLE_S = 30.0
SYNC_ERRORS = (OSError, ProtocolError, jea.ProtocolError)

#: the shard tests' six leaves: at S = 4 the list is striped AND the
#: dominant leaf "c" (about three quarters of the bytes) is split
SHAPES = (("a", (64, 3)), ("b", (7,)), ("c", (32, 32)), ("d", (5,)),
          ("e", (128,)), ("f", (2, 2)))


def ports(n: int = 12) -> int:
    return reserve_port_window(n)


def params_np(seed: int | None = 0) -> dict:
    """The six leaves, seeded standard normals (zeros for ``None``)."""
    if seed is None:
        return {k: np.zeros(s, np.float32) for k, s in SHAPES}
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES}


def tree(pkg: str, t: dict) -> dict:
    """A numpy tree as the package's own leaves (copies)."""
    if pkg == "port":
        return {k: torch.from_numpy(np.array(v)) for k, v in t.items()}
    return {k: np.array(v) for k, v in t.items()}


def as_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def drift(p: dict, r: int) -> dict:
    """The chaos drift: a dyadic step, exact in float32 in both packages."""
    step = np.float32((r % 5) + 0.25)
    return {k: v + (float(step) if isinstance(v, torch.Tensor) else step)
            for k, v in p.items()}


def bits(a) -> np.ndarray:
    a = np.ascontiguousarray(as_np(a))
    return a.reshape(-1).view(np.dtype(f"u{a.dtype.itemsize}"))


def assert_bitwise(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = as_np(g), as_np(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(bits(g), bits(w))


def run_threads(*fns, timeout: float = 120.0):
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
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a role hung"
    if errs:
        raise errs[0]


def wait_for(cond, timeout: float = 30.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.02)


def server(pkg: str, port: int, num_nodes: int, concurrent: bool = False,
           **kw):
    if pkg == "port":
        cls = pea.AsyncEAServerConcurrent if concurrent else pea.AsyncEAServer
        return cls(HOST, port, num_nodes, device="cpu", **kw)
    cls = jea.AsyncEAServerConcurrent if concurrent else jea.AsyncEAServer
    return cls(HOST, port, num_nodes, **kw)


def client(pkg: str, port: int, node: int = 1, **kw):
    kw.setdefault("tau", 1)
    kw.setdefault("alpha", 0.5)
    if pkg == "port":
        return pea.AsyncEAClient(HOST, port, node=node, device="cpu", **kw)
    return jea.AsyncEAClient(HOST, port, node=node, **kw)


def join(pkg: str, port: int, params: dict, **kw):
    tau, alpha = kw.pop("tau", 1), kw.pop("alpha", 0.5)
    if pkg == "port":
        return pea.AsyncEAClient.join(HOST, port, params, tau, alpha,
                                      device="cpu", **kw)
    return jea.AsyncEAClient.join(HOST, port, params, tau, alpha, **kw)


def spawn_fleet(server_pkg: str, port: int, num_clients: int, shards: int,
                codecs, base: dict, client_pkgs=None, overlap=False,
                centers=None, handshake_timeout: float = 5.0,
                rejoin_grace: float = 60.0, elastic: bool = False,
                server_centers=None, tau: int = 1, alpha: float = 0.5):
    """A concurrent server and ``num_clients`` clients, started together
    (both constructors block on the accept/dial handshake).  Returns
    ``(server, [clients], [params])`` with the server serving."""
    client_pkgs = client_pkgs or [server_pkg] * num_clients
    box: dict = {}

    def dial(i):
        try:
            box[i] = client(client_pkgs[i], port, node=i + 1, tau=tau,
                            alpha=alpha, codec=codecs[i % len(codecs)],
                            overlap=overlap, centers=centers)
        except Exception as e:  # noqa: BLE001 — surfaced below
            box[i] = e

    threads = [threading.Thread(target=dial, args=(i,), daemon=True)
               for i in range(num_clients)]
    for t in threads:
        t.start()
    srv = server(server_pkg, port, num_clients, concurrent=True,
                 shards=shards, accept_timeout=60.0,
                 handshake_timeout=handshake_timeout,
                 rejoin_grace=rejoin_grace, elastic=elastic,
                 centers=server_centers)
    for t in threads:
        t.join(timeout=JOIN_S)
    clients = []
    for i in range(num_clients):
        got = box.get(i)
        if isinstance(got, Exception) or got is None:
            raise RuntimeError(f"client {i + 1} dial failed: {got!r}")
        clients.append(got)
    srv.init_server(tree(server_pkg, base))
    ps = [cl.init_client(tree(pkg, base))
          for cl, pkg in zip(clients, client_pkgs)]
    srv.start()
    return srv, clients, ps


def quiet(srv) -> bool:
    with srv._lock:
        if srv._inflight:
            return False
    return (all(q.empty() for q in srv._queues.values())
            and all(q.empty() for q in srv._shard_queues.values()))


def settle(clients, srv, timeout: float = SETTLE_S):
    """Block until every submitted delta is applied: overlap senders
    flushed, nothing in flight, the sync count stable over two polls."""
    for cl in clients:
        if cl._sender is not None:
            cl._sender.flush()
    deadline = time.monotonic() + timeout
    last = -1
    while time.monotonic() < deadline:
        if quiet(srv):
            n = srv.syncs_completed
            if n == last:
                return
            last = n
        else:
            last = -1
        time.sleep(0.05)
    raise AssertionError("fleet did not settle (legs still in flight)")


def snapshot(srv) -> list[np.ndarray]:
    """The server's real center leaves as numpy copies."""
    return [np.array(as_np(t)) for t in srv._snapshot()]


def teardown(clients, srv):
    for cl in clients:
        try:
            cl.close()
        except (OSError, RuntimeError):
            pass
    try:
        srv.stop(deadline=5.0)
    finally:
        srv.close()


def kill_and_promote(srv, standby_pkg: str, new_port: int, base: dict,
                     ckpt_dir: str, shards: int, ckpt_every: int = 1,
                     flush_first: bool = True, **kw):
    """Stop the primary (after a final checkpoint when ``flush_first``),
    promote a ``standby_pkg`` standby on ``new_port`` from ``ckpt_dir``
    and start it serving.  Returns the promoted server."""
    if flush_first:
        srv.checkpoint_now(wait=True)
    srv.stop(deadline=2.0)
    srv.close()
    standby = server(standby_pkg, new_port, srv.num_nodes, concurrent=True,
                     shards=shards, handshake_timeout=5.0,
                     rejoin_grace=60.0, standby=True, **kw)
    (pha if standby_pkg == "port" else jha).promote(
        standby, ckpt_dir, tree(standby_pkg, base))
    standby.enable_checkpoint(ckpt_dir, every=ckpt_every)
    standby.start()
    return standby


def sync_with_failover(cl, p, attempts: int = 50):
    """One sync, retried through ``failover`` until it lands."""
    last = None
    for _ in range(attempts):
        try:
            return cl.sync_client(p)[0]
        except SYNC_ERRORS as e:
            last = e
            cl.failover(p, retries=40, retry_interval=0.01,
                        handshake_timeout=15.0)
    raise AssertionError(f"sync never succeeded after failover: {last!r}")


class DropSender:
    """A stand-in for the client's overlap sender that drops the push: the
    sync completes locally (its delta stays pending for a replay) and the
    server never receives it."""

    def submit(self, job):
        pass

    def flush(self):
        pass

    def drain(self):
        pass

    def close(self):
        pass


def die_before_push(cl, p):
    """Sync ``p`` up to the push and die there: the center is fetched and
    the delta encoded (pending, seq N), then every channel closes, so the
    server's handshake fails and it evicts the client.  Returns the
    client's params after the local move."""
    sender, cl._sender = cl._sender, DropSender()
    try:
        p, synced = cl.sync_client(p)
        assert synced
    finally:
        cl._sender = sender
    for c in (cl.broadcast, cl.conn, *cl._shard_conns):
        c.close()
    return p
