"""Elastic membership on the port's AsyncEA server against the JAX
package's (tests/test_elastic.py replayed on the port), on the CPU:

* capacity weights ``cap * N / sum(live caps)``: exactly 1.0 for an
  equal-capacity or fixed fleet, renormalised on join, leave and eviction —
  the JAX package's values;
* the straggler-adaptive tau bounds, the JAX package's on a grid;
* one join (capacity 2) and one leave on an elastic S = 2 concurrent
  server, on one seeded sequence of syncs: the port's fleet, and mixed
  JAX/port fleets, bit for bit the all-JAX run;
* a joiner survives a center kill through the roster of its join reply
  (a fresh Join? on the promoted standby).
"""

import types

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu.parallel import async_ea as jea  # noqa: E402
from distlearn_tpu_torch.parallel import async_ea as pea  # noqa: E402

from tests import torch_async_util as U  # noqa: E402

pytestmark = pytest.mark.elastic


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ------------------------------------------- capacity-weight normalization

def _srv(members, capacity=(), num_nodes=2, elastic=True, evicted=()):
    """The attribute slice ``_delta_weight`` reads."""
    return types.SimpleNamespace(
        elastic=elastic, members=set(members), evicted=set(evicted),
        _capacity=dict(capacity), num_nodes=num_nodes)


def _w(ns, cid):
    got = pea.AsyncEAServer._delta_weight(ns, cid)
    assert got == jea.AsyncEAServer._delta_weight(ns, cid)
    return got


def test_initial_equal_capacity_fleet_weighs_exactly_one():
    ns = _srv({1, 2})
    assert _w(ns, 1) == 1.0 and _w(ns, 2) == 1.0


def test_non_elastic_server_never_scales():
    ns = _srv({1, 2, 3}, capacity={3: 5.0}, elastic=False)
    assert _w(ns, 3) == 1.0


def test_weights_renormalize_on_join_and_sum_to_budget():
    ns = _srv({1, 2, 3}, capacity={3: 2.0})
    assert _w(ns, 1) == pytest.approx(0.5)
    assert _w(ns, 3) == pytest.approx(1.0)
    live = ns.members - ns.evicted
    assert sum(_w(ns, c) for c in live) == pytest.approx(ns.num_nodes)


def test_weights_renormalize_on_leave_and_eviction():
    ns = _srv({1, 2, 3}, capacity={3: 2.0})
    ns.members.discard(3)
    assert _w(ns, 1) == 1.0
    ns = _srv({1, 2, 3}, capacity={3: 2.0}, evicted={3})
    assert _w(ns, 1) == 1.0


# --------------------------------------------------- adaptive-tau bounds

def test_adaptive_tau_bounds_values():
    assert pea.adaptive_tau_bounds(4, 0.05) == (4, 18)
    assert pea.adaptive_tau_bounds(1, 0.1) == (1, 9)
    assert pea.adaptive_tau_bounds(8, 0.5) == (8, 8)   # never below tau
    for tau in (1, 2, 4, 8):
        for alpha in (0.0, 0.02, 0.05, 0.1, 0.3, 0.5):
            assert pea.adaptive_tau_bounds(tau, alpha) == \
                jea.adaptive_tau_bounds(tau, alpha)


def test_adaptive_tau_ceiling_respects_stability_product():
    assert pea.ALPHA_TAU_PRODUCT == jea.ALPHA_TAU_PRODUCT
    for tau in (1, 2, 4):
        for alpha in (0.02, 0.05, 0.1, 0.3):
            lo, hi = pea.adaptive_tau_bounds(tau, alpha)
            assert 1 <= lo <= hi
            assert hi * alpha <= pea.ALPHA_TAU_PRODUCT or hi == lo


def test_adaptive_tau_stretches_with_latency_within_bounds():
    """The port's EWMA rule on a latency sequence: the JAX client's
    ``tau_effective`` after every sample, within the bounds."""
    seq = [0.01, 0.01, 0.05, 0.2, 0.2, 0.02, 0.01]

    def taus(cls, bounds):
        c = object.__new__(cls)     # the rule's state only, no sockets
        c._lat_ewma = c._lat_floor = None
        c._tau_lo, c._tau_hi = bounds(2, 0.1)
        c._obs_on = False
        out = []
        for dt in seq:
            c._note_sync_latency(dt)
            out.append(c.tau_effective)
        return out

    got = taus(pea.AsyncEAClient, pea.adaptive_tau_bounds)
    assert got == taus(jea.AsyncEAClient, jea.adaptive_tau_bounds)
    assert max(got) > 2 and all(2 <= t <= 9 for t in got)


# ------------------------------------- one join and one leave, cap != 1

def _elastic_run(server_pkg, client_pkg):
    """Founding clients 1 (int8) and 2 (raw) on an elastic S = 2 server;
    round 0: both sync; a capacity-2 int8 client joins; round 1: all three
    sync; client 2 leaves; round 2: clients 1 and 3 sync.  Every sync is
    settled before the next, so the sequence is one order."""
    base = U.params_np(7)
    port = U.ports()
    srv, clients, ps = U.spawn_fleet(server_pkg, port, 2, 2,
                                     ["int8", "raw"], base,
                                     client_pkgs=[client_pkg] * 2,
                                     elastic=True)
    joiner = None
    try:
        def sync(i, cl, r):
            ps[i], synced = cl.sync_client(U.drift(ps[i], r))
            assert synced
            U.settle([cl], srv)

        for i, cl in enumerate(clients):
            sync(i, cl, 0)
        joiner, pj = U.join(client_pkg, port, U.tree(client_pkg, base),
                            capacity=2.0, codec="int8")
        clients.append(joiner)
        ps.append(pj)
        assert joiner.node == 3
        for i, cl in enumerate(clients):
            sync(i, cl, 1)
        weights = {c: srv._delta_weight(c) for c in (1, 2, 3)}
        clients[1].leave()
        U.wait_for(lambda: 2 not in srv.members, 30, "the leave")
        for i in (0, 2):
            sync(i, clients[i], 2)
        out = {"center": U.snapshot(srv), "served": srv.syncs_completed,
               "members": sorted(srv.members), "weights": weights,
               "weights_after": {c: srv._delta_weight(c) for c in (1, 3)},
               "params": [[U.as_np(p[k]).copy() for k in sorted(p)]
                          for p in ps]}
        return out
    finally:
        U.teardown([clients[0]] + ([joiner] if joiner else []), srv)


@pytest.fixture(scope="module")
def all_jax_elastic():
    return _elastic_run("jax", "jax")


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_join_and_leave_with_capacity_bitwise_vs_jax(all_jax_elastic,
                                                     server_pkg, client_pkg):
    got = _elastic_run(server_pkg, client_pkg)
    want = all_jax_elastic
    assert got["served"] == want["served"] == 7
    assert got["members"] == want["members"] == [1, 3]
    assert got["weights"] == want["weights"] == {1: 0.5, 2: 0.5, 3: 1.0}
    assert got["weights_after"] == want["weights_after"]
    assert sum(got["weights_after"].values()) == pytest.approx(2.0)
    U.assert_bitwise(got["center"], want["center"])
    for g, w in zip(got["params"], want["params"]):
        U.assert_bitwise(g, w)


# ------------------------------ joiner failover via the join-ACK roster

def test_joiner_survives_center_kill_via_join_ack_roster(tmp_path):
    """A Join?-admitted client learns the failover dial list from its join
    reply; when the primary dies and the advertised standby is promoted,
    it re-enters through a fresh Join? (its ephemeral dedicated listener
    died with the primary) alongside the founders' Rejoin? failover."""
    base = U.params_np(0)
    win_a, win_b = U.ports(8), U.ports(8)
    srv, clients, ps = U.spawn_fleet(
        "port", win_a, 2, 1, ["raw"], base,
        centers=[(U.HOST, win_b)], elastic=True,
        server_centers=[(U.HOST, win_b)])
    joiner = None
    try:
        srv.enable_checkpoint(str(tmp_path), every=1)
        for r in range(2):
            for i, cl in enumerate(clients):
                ps[i], _ = cl.sync_client(U.drift(ps[i], r))
        joiner, pj = U.join("port", win_a, U.tree("port", base),
                            sharded=False)
        assert (U.HOST, win_b) in joiner._centers
        pj, _ = joiner.sync_client(U.drift(pj, 0))
        U.settle(clients + [joiner], srv)
        srv.checkpoint_now(wait=True)
        srv.stop(deadline=2.0)
        srv.close()
        srv = U.server("port", win_b, 2, concurrent=True, shards=1,
                       handshake_timeout=5.0, rejoin_grace=60.0,
                       standby=True, elastic=True)
        from distlearn_tpu_torch.parallel import ha
        ha.promote(srv, str(tmp_path), U.tree("port", base))
        srv.start()
        old = joiner._ded_port
        pj = U.sync_with_failover(joiner, U.drift(pj, 1))
        # re-entry was a fresh Join? (a new ephemeral dedicated port), not a
        # Rejoin? under the dead primary's roster
        assert joiner._ded_port is not None and joiner._ded_port != old
        for i, cl in enumerate(clients):
            ps[i] = U.sync_with_failover(cl, U.drift(ps[i], 2))
        U.settle(clients + [joiner], srv)
        assert joiner.node in srv.members and srv.epoch == 1
    finally:
        U.teardown(clients + ([joiner] if joiner else []), srv)


# ------------------------------------------- the example's fleet drills

def test_example_elastic_fleet_drills():
    """The example's roles as threads on an elastic, striped, concurrent
    server (int8, mnist, overlapped clients): client 2 drops its channels
    after its first sync and rejoins, client 3 leaves after one sync, a
    capacity-2 client joins.  Every sync a client counted is applied once,
    client 2's ledger ends at its last sequence on both stripes, the live
    weights sum to the founding fleet's size, and the server stops when the
    fleet drains."""
    import threading

    from distlearn_tpu_torch.examples import easgd
    port = U.ports()
    common = ["--numNodes", "3", "--port", str(port), "--model", "mnist",
              "--wireCodec", "int8", "--device", "cpu", "--batchSize", "16",
              "--communicationTime", "2", "--numEpochs", "1",
              "--numExamples", "288", "--shards", "2", "--overlapSync"]
    out = {}
    serving = threading.Event()

    def role(name, kind, extra, wait=False):
        def run():
            opt = easgd.parse_role(kind, common + extra)
            if kind == "server":
                out[name] = easgd.run_server(
                    opt, on_serving=lambda srv: serving.set())
            else:
                out[name] = easgd.run_client(opt, before_dial=(
                    lambda: serving.wait(60)) if wait else None)
        return run

    # 96 examples a client / batch 16 = 6 steps, tau 2: 3 syncs each
    U.run_threads(
        role("server", "server", ["--concurrent", "--elastic",
                                  "--numSyncs", "1000",
                                  "--syncTimeout", "30"]),
        role("c1", "client", ["--nodeIndex", "1"]),
        role("c2", "client", ["--nodeIndex", "2", "--cutAfter", "1"]),
        role("c3", "client", ["--nodeIndex", "3", "--leaveAfterSyncs",
                              "1"]),
        role("c4", "client", ["--nodeIndex", "4", "--joinFleet",
                              "--capacity", "2"], wait=True))
    srv = out["server"]
    clients = [out[f"c{i}"] for i in range(1, 5)]
    assert srv["served"] == sum(c["syncs"] for c in clients)
    assert out["c2"]["recoveries"] == 1 and out["c3"]["left"]
    assert out["c2"]["syncs"] == 2 and out["c2"]["seq"] == 4
    assert out["c3"]["syncs"] == 1 and out["c4"]["node"] == 4
    assert srv["members"] == [1, 2, 4] and srv["evicted"] == []
    assert srv["ledger"][2] == [out["c2"]["seq"]] * 2
    assert sum(srv["weights"].values()) == pytest.approx(3.0)
    assert srv["weights"][4] == pytest.approx(1.5)
    assert all(np.isfinite(c["losses"]).all() for c in clients)
