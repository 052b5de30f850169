"""Center HA on the port (``distlearn_tpu_torch/parallel/ha.py`` and the
server's checkpoint half) against the JAX package's (tests/test_ha.py
replayed on the port), on the CPU:

* checkpoints round-trip bit for bit (int8 and fp16, S = 1 and 4), and a
  fresh standby promotes into the next epoch;
* a mixed-codec fleet fails over to a promoted standby and keeps syncing;
* the epoch fence: a stale center is refused and leaves the dial list;
* start/stop cycles leak no thread; SIGTERM flushes a final checkpoint and
  chains the prior handler;
* across the packages: a JAX primary's checkpoint promoted by a port
  standby and the reverse, the promoted center bit for bit the
  checkpoint's and its epoch bumped; the client's delta the checkpoint
  missed is replayed once, landing the promoted center bit for bit on the
  primary's final one.
"""

import os
import signal
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.parallel import ha as jha  # noqa: E402
from distlearn_tpu.utils.checkpoint import latest_step  # noqa: E402
from distlearn_tpu_torch.comm import ProtocolError  # noqa: E402
from distlearn_tpu_torch.obs import core  # noqa: E402
from distlearn_tpu_torch.parallel import ha  # noqa: E402
from distlearn_tpu_torch.parallel.async_ea import (  # noqa: E402
    StaleCenterError)

from tests import torch_async_util as U  # noqa: E402

HOST = U.HOST


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def obs_on():
    core.configure(True)
    core.REGISTRY.reset()
    yield
    core.REGISTRY.reset()
    core.configure(None)


def _totals() -> dict:
    out = {}
    for fam in core.REGISTRY.snapshot():
        if fam["kind"] in ("counter", "gauge"):
            out[fam["name"]] = sum(s.get("value", 0) for s in fam["samples"])
    return out


# ----------------------------------------------- checkpoint round-trips

@pytest.mark.shard
@pytest.mark.parametrize("codec", ["int8", "fp16"])
@pytest.mark.parametrize("shards", [1, 4])
def test_checkpoint_roundtrip_bitwise(tmp_path, obs_on, codec, shards):
    base = U.params_np(0)
    srv, (cl,), (p,) = U.spawn_fleet("port", U.ports(8), 1, shards, [codec],
                                     base)
    standby = None
    try:
        srv.enable_checkpoint(str(tmp_path), every=1)
        for r in range(3):
            p, _ = cl.sync_client(U.drift(p, r))
        U.settle([cl], srv)
        srv.checkpoint_now(wait=True)
        want = U.snapshot(srv)
        restored, meta = ha.restore_center(str(tmp_path), U.tree("port",
                                                                 base))
        U.assert_bitwise([restored[k] for k in sorted(restored)], want)
        assert meta["epoch"] == srv.epoch == 0
        assert meta["shards"] == shards and meta["step"] == 3
        standby = U.server("port", U.ports(8), 1, concurrent=True,
                           shards=shards, standby=True)
        ha.promote(standby, str(tmp_path), U.tree("port", base))
        assert standby.epoch == 1 and standby.syncs_completed == 3
        U.assert_bitwise(U.snapshot(standby), want)
        assert len(standby._applied_seq[1]) == len(standby.stripes)
    finally:
        if standby is not None:
            standby.close()
        U.teardown([cl], srv)


@pytest.mark.shard
def test_mixed_fleet_readmits_after_promotion(tmp_path, obs_on):
    """raw + int8 + fp16 clients on a striped center: kill + promote, every
    client fails over and keeps syncing — one promotion, no stale
    refusal."""
    base = U.params_np(0)
    win_a, win_b = U.ports(10), U.ports(10)
    srv, clients, ps = U.spawn_fleet("port", win_a, 3, 4,
                                     ["raw", "int8", "fp16"], base,
                                     centers=[(HOST, win_b)])
    try:
        srv.enable_checkpoint(str(tmp_path), every=1)
        for r in range(2):
            for i, cl in enumerate(clients):
                ps[i], _ = cl.sync_client(U.drift(ps[i], r))
        U.settle(clients, srv)
        srv = U.kill_and_promote(srv, "port", win_b, base, str(tmp_path), 4)
        for i, cl in enumerate(clients):
            ps[i] = U.sync_with_failover(cl, U.drift(ps[i], 2))
        U.settle(clients, srv)
        totals = _totals()
        assert totals["async_ea_failover_promotions_total"] == 1
        assert totals.get("async_ea_failover_stale_refusals_total", 0) == 0
        assert srv.syncs_completed >= 9
    finally:
        U.teardown(clients, srv)


# ------------------------------------------------------- the epoch fence

def test_stale_center_refused_and_dropped_from_dial_list(obs_on):
    base = U.params_np(0)
    srv, (cl,), (p,) = U.spawn_fleet("port", U.ports(4), 1, 1, ["raw"], base)
    try:
        p, _ = cl.sync_client(U.drift(p, 0))
        assert cl._seen_epoch == 0
        cl._seen_epoch = 5      # as if a promoted center was seen elsewhere
        with pytest.raises(StaleCenterError):
            cl.sync_client(U.drift(p, 1))
        assert issubclass(StaleCenterError, ProtocolError)
        U.wait_for(lambda: 1 in srv.evicted, 5, "the zombie's eviction")
        with pytest.raises(ConnectionError):
            cl.failover(p, retries=3, retry_interval=0.01,
                        handshake_timeout=2.0)
        assert cl._centers == []
        # server Enter fence + server rejoin fence + the client's dial walk
        assert _totals()["async_ea_failover_stale_refusals_total"] == 3
    finally:
        U.teardown([cl], srv)


# ------------------------------------------- shutdown hygiene (no leaks)

def test_start_stop_cycles_leak_nothing(obs_on):
    base = U.params_np(0)
    readings = []
    for cycle in range(4):
        srv, (cl,), (p,) = U.spawn_fleet("port", U.ports(6), 1, 2, ["raw"],
                                         base)
        p, _ = cl.sync_client(U.drift(p, cycle))
        U.settle([cl], srv)
        U.teardown([cl], srv)
        deadline = time.monotonic() + 5.0
        while threading.active_count() > 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        readings.append((len(os.listdir("/proc/self/fd")),
                         threading.active_count()))
    assert max(f for f, _ in readings[1:]) <= readings[0][0], readings
    assert max(t for _, t in readings[1:]) <= readings[0][1], readings
    totals = _totals()
    assert totals.get("async_ea_server_threads", 0) == 0
    assert totals.get("async_ea_inflight", 0) == 0


# --------------------------------------------------- SIGTERM final flush

def test_install_signal_flush_checkpoints_and_chains(tmp_path, obs_on):
    base = U.params_np(0)
    srv, (cl,), (p,) = U.spawn_fleet("port", U.ports(4), 1, 1, ["raw"], base)
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda n, f: hits.append(n))
    try:
        srv.enable_checkpoint(str(tmp_path), every=10 ** 9)
        p, _ = cl.sync_client(U.drift(p, 0))
        U.settle([cl], srv)
        assert latest_step(str(tmp_path)) is None   # cadence never hit
        ha.install_signal_flush(srv, signums=(signal.SIGUSR1,))
        os.kill(os.getpid(), signal.SIGUSR1)
        U.wait_for(lambda: hits, 5, "the chained handler")
        assert hits == [signal.SIGUSR1]
        assert latest_step(str(tmp_path)) == 1
    finally:
        signal.signal(signal.SIGUSR1, prev)
        U.teardown([cl], srv)


# ------------------------------------- promotion across the two packages

@pytest.mark.parametrize("primary_pkg,standby_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_cross_package_promotion_replays_once_bitwise(tmp_path, primary_pkg,
                                                      standby_pkg):
    """A ``primary_pkg`` S = 4 center with two int8 clients checkpoints
    after 4 syncs; client 1 then syncs once more and the primary dies.  A
    ``standby_pkg`` standby promotes from the checkpoint: its center is the
    checkpoint's bit for bit, its epoch 1.  Client 1 fails over claiming
    its pending delta, which the promoted ledger misses: it is replayed
    once and the promoted center equals the primary's final center bit for
    bit; client 2's failover replays nothing."""
    base = U.params_np(4)
    win_a, win_b = U.ports(8), U.ports(8)
    srv, clients, ps = U.spawn_fleet(primary_pkg, win_a, 2, 4, ["int8"],
                                     base, centers=[(HOST, win_b)])
    standby = None
    try:
        srv.enable_checkpoint(str(tmp_path), every=10 ** 9)
        for r in range(2):
            for i, cl in enumerate(clients):
                ps[i], _ = cl.sync_client(U.drift(ps[i], r))
        U.settle(clients, srv)
        srv.checkpoint_now(wait=True)
        at_ckpt = U.snapshot(srv)
        ps[0], _ = clients[0].sync_client(U.drift(ps[0], 2))
        U.settle(clients, srv)
        final = U.snapshot(srv)
        srv.stop(deadline=2.0)
        srv.close()
        standby = U.server(standby_pkg, win_b, 2, concurrent=True, shards=4,
                           handshake_timeout=5.0, standby=True)
        (ha if standby_pkg == "port" else jha).promote(
            standby, str(tmp_path), U.tree(standby_pkg, base))
        assert standby.epoch == 1 and standby.syncs_completed == 4
        U.assert_bitwise(U.snapshot(standby), at_ckpt)
        assert standby._applied_seq == {1: [2] * 4, 2: [2] * 4}
        standby.start()
        for cl, p in zip(clients, ps):
            cl.failover(p, retries=20, retry_interval=0.01,
                        handshake_timeout=10.0)
        U.settle(clients, standby)
        U.assert_bitwise(U.snapshot(standby), final)
        assert standby.syncs_completed == 5
        assert standby._applied_seq == {1: [3] * 4, 2: [2] * 4}
    finally:
        if standby is not None:
            U.teardown(clients, standby)
        else:
            U.teardown(clients, srv)
