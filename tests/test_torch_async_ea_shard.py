"""The port's striped AsyncEA center (``shards > 1``) against the JAX
package's (tests/test_async_ea_shard.py replayed on the port), over real
localhost sockets with the roles as threads, on the CPU:

* the stripe plan: the dominant leaf split, the plan the JAX server
  publishes for the same leaves;
* striped syncs: exact EASGD math, S = 4 bit for bit S = 1 over 50 raw
  rounds, int8 striped trajectories bit for bit the JAX package's, on the
  six test leaves (S = 4) and on the full-width CIFAR-10 convnet (S = 3,
  which cuts conv4 into chunks at element offsets that are not multiples
  of 4);
* mixed-version fleets: sharded client / unsharded server and the inverse,
  a legacy per-leaf client against a sharded server;
* mixed JAX/port concurrent fleets (S = 4), int8 and raw, with one client
  dying before its push and failing over with the pending delta replayed
  once: bit for bit the all-JAX run;
* a mid-stripe death evicts and cleans every shard channel, and the rejoin
  resyncs every stripe;
* per-shard counters.

The codecs are deterministic, so every comparison is exact.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax import random  # noqa: E402

from distlearn_tpu.models import cifar_convnet as jax_cifar  # noqa: E402
from distlearn_tpu_torch.models.convert import (CONVNET_WIRE,  # noqa: E402
                                                from_jax, to_jax)
from distlearn_tpu_torch.obs import core  # noqa: E402
from distlearn_tpu_torch.parallel import async_ea as pea  # noqa: E402

from tests import torch_async_util as U  # noqa: E402

pytestmark = pytest.mark.shard


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _plan(pkg):
    port = U.ports()
    box = {}

    def client_fn():
        c = U.client(pkg, port)
        c.init_client(U.tree(pkg, U.params_np(None)))
        c.close()

    def server_fn():
        srv = U.server(pkg, port, 1, shards=4)
        srv.init_server(U.tree(pkg, U.params_np(None)))
        box["srv"] = (srv.splits, srv.stripes, srv._shard_spec)
        if pkg == "port":
            box["spans"] = srv._spans
            box["vbytes"] = [m[1] for m in srv._vmeta]
        srv.close()

    U.run_threads(server_fn, client_fn)
    return box


def test_sharded_server_splits_dominant_leaf():
    """The published stripe plan indexes the VIRTUAL leaf list, the
    dominant leaf cut so no stripe holds most of the bytes — the plan the
    JAX server publishes, ports and all but the port numbers."""
    got, want = _plan("port"), _plan("jax")
    splits, stripes, spec = got["srv"]
    jsplits, jstripes, jspec = want["srv"]
    assert max(splits) > 1
    assert (splits, stripes) == (jsplits, jstripes)
    assert {k: v for k, v in spec.items() if k != "ports"} == \
        {k: v for k, v in jspec.items() if k != "ports"}
    per_stripe = [sum(got["vbytes"][lo:hi]) for lo, hi in stripes]
    assert max(per_stripe) < 0.5 * sum(got["vbytes"])
    # each stripe is one contiguous byte span of the center slab (its
    # bytes and the 16-byte alignment padding between its leaves), in
    # order and disjoint
    spans = got["spans"]
    assert all(0 <= (b1 - b0) - n < 16 * (hi - lo) for (b0, b1), n, (lo, hi)
               in zip(spans, per_stripe, stripes))
    assert all(spans[i][1] <= spans[i + 1][0] for i in range(len(spans) - 1))


def _run_serial(pkg, codec, shards, rounds=3, sharded_client=True,
                base=None):
    port = U.ports()
    out = {}
    base = U.params_np(None) if base is None else base

    def client_fn():
        c = U.client(pkg, port, codec=codec, sharded=sharded_client)
        p = c.init_client(U.tree(pkg, base))
        for r in range(rounds):
            p, synced = c.sync_client(U.drift(p, r))
            assert synced
        out["p"] = [U.as_np(p[k]).copy() for k in sorted(p)]
        out["stripes"] = c._stripes
        c.close()

    def server_fn():
        srv = U.server(pkg, port, 1, shards=shards)
        srv.init_server(U.tree(pkg, base))
        for _ in range(rounds):
            srv.sync_server(U.tree(pkg, base))
        out["center"] = [np.array(U.as_np(t)) for t in srv.center]
        srv.close()

    U.run_threads(server_fn, client_fn)
    return out


def test_striped_sync_math_exact():
    """One S = 4 striped sync: center += alpha*(p - c) on every leaf, the
    client takes p - delta."""
    out = _run_serial("port", "raw", 4, rounds=1)
    assert out["stripes"] is not None and len(out["stripes"]) >= 2
    for t in out["center"] + out["p"]:
        np.testing.assert_array_equal(t, np.full_like(t, 0.125))


@pytest.mark.parametrize("codec", ["int8", "fp16", "raw"])
def test_striped_serial_trajectory_bitwise_vs_jax(codec):
    """Five S = 4 rounds from seeded leaves: the port's serial pair lands
    on the JAX pair's center and params (per-chunk int8 scales included)."""
    base = U.params_np(3)
    got = _run_serial("port", codec, 4, rounds=5, base=base)
    want = _run_serial("jax", codec, 4, rounds=5, base=base)
    assert [tuple(s) for s in got["stripes"]] == \
        [tuple(s) for s in want["stripes"]]
    U.assert_bitwise(got["center"], want["center"])
    U.assert_bitwise(got["p"], want["p"])


def test_sharded_client_against_unsharded_server():
    out = _run_serial("port", "raw", 1, rounds=2)
    assert out["stripes"] is None               # no plan advertised


def test_unsharded_client_against_sharded_server():
    """sharded=False pins the single-channel packed sync even when the
    server stripes for everyone else."""
    out = _run_serial("port", "raw", 4, rounds=1, sharded_client=False)
    assert out["stripes"] is None
    for t in out["center"]:
        np.testing.assert_array_equal(t, np.full_like(t, 0.125))


def test_legacy_client_against_sharded_server():
    """A pre-shard client (codec None, per-leaf frames) syncs against a
    sharded server through the one-stripe legacy path."""
    out = _run_serial("port", None, 4, rounds=1)
    assert out["stripes"] is None
    for t in out["center"]:
        np.testing.assert_array_equal(t, np.full_like(t, 0.125))


def _run_concurrent(pkg, shards, rounds, codec="raw"):
    port = U.ports()
    out = {}

    def client_fn():
        c = U.client(pkg, port, codec=codec)
        p = c.init_client(U.tree(pkg, U.params_np(None)))
        for r in range(rounds):
            p, synced = c.sync_client(U.drift(p, r))
            assert synced
        out["p"] = [U.as_np(p[k]).copy() for k in sorted(p)]
        c.close()

    def server_fn():
        srv = U.server(pkg, port, 1, concurrent=True, shards=shards)
        srv.init_server(U.tree(pkg, U.params_np(None)))
        srv.start()
        U.wait_for(lambda: srv.syncs_completed >= rounds and srv.drained,
                   60, "the concurrent server to drain")
        out["center"] = U.snapshot(srv)
        srv.stop()
        srv.close()

    U.run_threads(server_fn, client_fn)
    return out


def test_fifty_round_bitwise_parity_s4_vs_s1():
    """50 single-client raw rounds on the concurrent server: the S = 4
    striped pipeline and the S = 1 packed path give bit-identical centers
    and params (striping, sub-leaf chunks included, is transport only),
    and both equal the JAX package's S = 4 run."""
    s1 = _run_concurrent("port", 1, 50)
    s4 = _run_concurrent("port", 4, 50)
    j4 = _run_concurrent("jax", 4, 50)
    for run in (s4, j4):
        U.assert_bitwise(run["center"], s1["center"])
        U.assert_bitwise(run["p"], s1["p"])


def test_convnet_int8_stripes_bitwise_vs_jax():
    """The full-width CIFAR-10 convnet (18 leaves, JAX's seed-0 init) on
    S = 3 concurrent servers, 3 int8 rounds of a seeded drift: the port's
    server and client (on the JAX package's wire layout, conv4 cut into
    three chunks of 1,092,267 / 1,092,267 / 1,092,266 elements, so two
    start at offsets that are not multiples of 4) end on the JAX pair's
    center and params bit for bit."""
    jparams = jax.tree_util.tree_map(
        np.asarray, jax.device_get(jax_cifar().init(random.PRNGKey(0))[0]))
    rng = np.random.RandomState(11)
    drifts = [jax.tree_util.tree_map(
        lambda a: (0.01 * rng.randn(*a.shape)).astype(np.float32), jparams)
        for _ in range(3)]
    port_init = from_jax(jparams, {})[0]
    port_drifts = [from_jax(d, {})[0] for d in drifts]

    def run(pkg):
        port = U.ports()
        out = {}

        def client_fn():
            if pkg == "port":
                c = pea.AsyncEAClient(U.HOST, port, node=1, tau=1,
                                      alpha=0.5, codec="int8", device="cpu",
                                      layout=CONVNET_WIRE)
                p = c.init_client(port_init)
                for r in range(3):
                    p = {k: {n: v + port_drifts[r][k][n]
                             for n, v in d.items()} for k, d in p.items()}
                    p, _ = c.sync_client(p)
                out["p"] = to_jax(p)
            else:
                c = U.client("jax", port, codec="int8")
                p = c.init_client(jparams)
                for r in range(3):
                    p = jax.tree_util.tree_map(lambda a, b: a + b, p,
                                               drifts[r])
                    p, _ = c.sync_client(p)
                out["p"] = p
            c.close()

        def server_fn():
            if pkg == "port":
                srv = pea.AsyncEAServerConcurrent(
                    U.HOST, port, 1, shards=3, device="cpu",
                    layout=CONVNET_WIRE)
                srv.init_server(port_init)
            else:
                srv = U.server("jax", port, 1, concurrent=True, shards=3)
                srv.init_server(jparams)
            srv.start()
            U.wait_for(lambda: srv.syncs_completed >= 3 and srv.drained,
                       60, "the convnet server to drain")
            out["center"] = U.snapshot(srv)
            out["splits"] = srv.splits
            srv.stop()
            srv.close()

        U.run_threads(server_fn, client_fn)
        return out

    got, want = run("port"), run("jax")
    assert len(got["center"]) == 18 and got["splits"] == want["splits"]
    assert got["splits"][15] == 3 and 3_276_800 % 3
    U.assert_bitwise(got["center"], want["center"])
    U.assert_bitwise(jax.tree_util.tree_leaves(got["p"]),
                     jax.tree_util.tree_leaves(want["p"]))


# ---------------------------------------------------------------------------
# Mixed JAX/port concurrent fleets with a death before the push and a
# replayed pending delta

MIXED_ROUNDS = 5
DIE_AT = 3


def _mixed_fleet(server_pkg, client_pkg, codec):
    """One client on an S = 4 concurrent server: rounds 0-2 sync, round 3
    dies between its encode and its push (evicted), fails over to the same
    center claiming the pending delta (replayed, once), round 4 syncs.
    Returns the center, the client's params and the server's count."""
    base = U.params_np(5)
    port = U.ports()
    srv, (cl,), (p,) = U.spawn_fleet(server_pkg, port, 1, 4, [codec], base,
                                     client_pkgs=[client_pkg])
    try:
        for r in range(MIXED_ROUNDS):
            if r == DIE_AT:
                p = U.die_before_push(cl, U.drift(p, r))
                U.wait_for(lambda: 1 in srv.evicted, 30, "the eviction")
                cl.failover(p, retries=10, retry_interval=0.01,
                            handshake_timeout=10.0)
                continue
            p, synced = cl.sync_client(U.drift(p, r))
            assert synced
        U.settle([cl], srv)
        return (U.snapshot(srv), [U.as_np(p[k]).copy() for k in sorted(p)],
                srv.syncs_completed, dict(srv._applied_seq))
    finally:
        U.teardown([cl], srv)


@pytest.fixture(scope="module")
def all_jax_fleet():
    runs = {}

    def get(codec):
        if codec not in runs:
            runs[codec] = _mixed_fleet("jax", "jax", codec)
        return runs[codec]
    return get


@pytest.mark.parametrize("codec", ["int8", "raw"])
@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("jax", "port"), ("port", "jax")])
def test_mixed_concurrent_fleet_with_replay_bitwise_vs_all_jax(
        all_jax_fleet, server_pkg, client_pkg, codec):
    center, params, served, ledger = _mixed_fleet(server_pkg, client_pkg,
                                                  codec)
    want_center, want_params, want_served, want_ledger = \
        all_jax_fleet(codec)
    assert served == want_served == MIXED_ROUNDS
    assert ledger == want_ledger == {1: [MIXED_ROUNDS] * 4}
    U.assert_bitwise(center, want_center)
    U.assert_bitwise(params, want_params)


# ---------------------------------------------------------------------------
# Mid-stripe eviction + rejoin

def test_mid_stripe_death_cleans_every_shard_and_rejoin_resyncs():
    """A client dying between the Enter reply and its stripe legs is
    evicted with its conns dropped from EVERY shard endpoint and its
    connection generation bumped; its rejoin re-dials and resyncs ALL
    stripes."""
    port = U.ports()
    box = {}

    def server_fn():
        srv = U.server("port", port, 1, concurrent=True, shards=4,
                       handshake_timeout=5.0, rejoin_grace=60.0)
        srv.init_server(U.tree("port", U.params_np(None)))
        box["srv"] = srv
        srv.start()

    def client_fn():
        box["cl"] = U.client("port", port, codec="raw")
        box["p"] = box["cl"].init_client(U.tree("port", U.params_np(None)))

    U.run_threads(server_fn, client_fn)
    srv, cl, p = box["srv"], box["cl"], box["p"]
    try:
        gen0 = srv._conn_gen[1]
        assert cl._announce(pea.ENTER_Q, pea.ENTER) is True
        assert cl._stripes is not None and len(cl._stripes) >= 2
        for c in (cl.broadcast, cl.conn, *cl._shard_conns):
            c.close()
        U.wait_for(lambda: 1 in srv.evicted, 30, "the eviction")
        assert srv._conn_gen[1] > gen0
        U.wait_for(lambda: not any(1 in ep.conns
                                   for ep in srv.shard_endpoints),
                   10, "the shard channels to drop")
        gen1 = srv._conn_gen[1]
        p = cl.rejoin(p)
        U.wait_for(lambda: srv._conn_gen[1] > gen1, 10, "the readmit")
        assert cl._stripes is not None
        p2, synced = cl.sync_client({k: v + 2.0 for k, v in p.items()})
        assert synced
        U.settle([cl], srv)
        assert srv.syncs_completed == 1
        for t in U.snapshot(srv):
            np.testing.assert_array_equal(t, np.full_like(t, 1.0))
    finally:
        U.teardown([cl], srv)


def test_per_shard_obs_counters():
    core.configure(True)
    core.REGISTRY.reset()
    try:
        out = _run_serial("port", "raw", 4, rounds=2)
        nstripes = len(out["stripes"])
        fams = {f["name"]: f for f in core.REGISTRY.snapshot()}
        legs = fams["async_ea_shard_syncs_total"]["samples"]
        by_shard = {s["labels"]["shard"]: s["value"] for s in legs}
        assert by_shard == {str(i): 2 for i in range(nstripes)}
        wire_bytes = fams["async_ea_shard_wire_bytes_total"]["samples"]
        assert all(s["value"] > 0 for s in wire_bytes)
        assert len(wire_bytes) == nstripes
        applies = fams["async_ea_shard_apply_seconds"]["samples"]
        assert {s["labels"]["shard"] for s in applies} == \
            {str(i) for i in range(nstripes)}
    finally:
        core.REGISTRY.reset()
        core.configure(None)


def _fifty_rounds_s4(server_pkg, client_pkg, rounds=50):
    """tests/test_wire_kernels.py::test_fifty_round_trajectory_parity_s4's
    fleet: one int8 client on an S = 4 concurrent server, 50 rounds."""
    port = U.ports()
    init = {"w": np.zeros((8, 5), np.float32),
            "b": np.zeros((3,), np.float32)}
    out = {}

    def client_fn():
        c = U.client(client_pkg, port, codec="int8")
        p = c.init_client(U.tree(client_pkg, init))
        for r in range(rounds):
            p, synced = c.sync_client(U.drift(p, r))
            assert synced
        out["p"] = [U.as_np(p[k]).copy() for k in sorted(p)]
        c.close()

    def server_fn():
        srv = U.server(server_pkg, port, 1, concurrent=True, shards=4)
        srv.init_server(U.tree(server_pkg, init))
        srv.start()
        U.wait_for(lambda: srv.syncs_completed >= rounds and srv.drained,
                   60, "the fifty rounds")
        out["center"] = U.snapshot(srv)
        out["stripes"] = len(srv.stripes)
        srv.stop()
        srv.close()

    U.run_threads(server_fn, client_fn)
    return out


@pytest.fixture(scope="module")
def all_jax_fifty():
    return _fifty_rounds_s4("jax", "jax")


@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("port", "port"), ("jax", "port"),
                          ("port", "jax")])
def test_fifty_round_trajectory_parity_s4_across_packages(
        all_jax_fifty, server_pkg, client_pkg):
    """50 int8 rounds on the S = 4 striped concurrent pipeline (the dense
    leaf cut into four chunks, per-stripe frames, the undecoded stripe
    leg, B4's twin a stripe): the port's pair and the mixed pairs land on
    the all-JAX center and params bit for bit."""
    got = _fifty_rounds_s4(server_pkg, client_pkg)
    assert got["stripes"] == all_jax_fifty["stripes"] == 4
    U.assert_bitwise(got["center"], all_jax_fifty["center"])
    U.assert_bitwise(got["p"], all_jax_fifty["p"])
