"""chaos — kill/promote and elastic-membership soak runner for AsyncEA,
the port's copy of the root ``tools/chaos.py``: the same subcommands,
flags, scenarios, thresholds and report keys, over the port's roles
(``AsyncEAClient``, ``AsyncEAServerConcurrent``, ``comm.FaultPlan``,
``parallel.ha``, ``DecodeEngine``, ``ServeServer``, ``Router``,
``obs.agg`` and ``tools.autoscaler``), every role's tensors on
``--device`` (the card unless ``cpu`` is asked for).

Three entry points (docs/HA.md, docs/ELASTIC.md):

    python -m distlearn_tpu_torch.tools.chaos parity   --rounds 16 --kills 5,11 [--mid-flight]
    python -m distlearn_tpu_torch.tools.chaos churn    --rounds 12 --clients 3 --server-kills 2
    python -m distlearn_tpu_torch.tools.chaos scenario --name flash_join --rounds 12 --seed 0
    ... [--device cpu]

The sizes are the caller's: ``shapes`` (the AsyncEA leaves) is a keyword
of every run function, and the serving scenarios take the LM's config
(``lm``), its weights (``params``), the prompt lengths
(``prompt_lens``, ``prefix_len``) and the replicas' ``prefill_chunk``;
the JAX tool's toy sizes are the defaults.  At those sizes no kernel
launches on the card: a full-width run passes its own.

``parity`` runs one client against a striped concurrent center with
checkpointing on, kills the center at the requested rounds (either on a
round boundary or genuinely mid-stripe-leg with ``--mid-flight``),
promotes a standby on a second port window each time, and asserts the
surviving fleet converges to BITWISE the same center and client params
as an unkilled S=1 reference run — plus zero leaked fds/threads and
clean obs counters (``async_ea_failover_*``, ``center_ckpt_*``).  The
client object is never restarted; recovery is ``AsyncEAClient.failover``
walking its dial list.

Why bitwise parity holds under any kill point: the client's flush-at-
top-of-sync raises BEFORE any param mutation, so its local trajectory
is kill-invariant; and the per-(cid, stripe) applied-seq ledger is
checkpointed in the same lock hold as the center slice it covers, so
the rejoin replay re-applies exactly the stripes the restored center is
missing — never zero, never twice (docs/HA.md).

``churn`` is the multi-client liveness soak (the ``slow``/``chaos``
marked tier-2 test): random-ish client self-kills mid-handshake plus
center kills under load; asserts every client finishes its rounds, one
promotion per center kill, and no fd/thread accumulation — not parity
(rejoin adopts the current center, deliberately forking the
trajectory).

``scenario`` is the elastic-fleet chaos runner (docs/ELASTIC.md): four
named, seeded scenarios over the comm-layer fault-injection plan
(``comm/faults.py``) and the elastic membership verbs —

* ``flash_join``     — the fleet doubles (2 -> 4 clients) mid-run via
  ``Join?`` and must still converge to the descent target within
  tolerance of a fixed 2-client reference run;
* ``rolling_leave``  — join two (one at double capacity), then leave
  them one at a time through the graceful ``Leave?`` flush; membership
  must return to the founding fleet with every leave accounted;
* ``slow_node``      — a seeded delay is injected on one client's
  dedicated link AFTER its latency floor is established; its
  straggler-adaptive τ must stretch above τ_lo (bounded by the α·τ
  product) while the fleet still converges;
* ``partition_heal`` — a one-way send partition lands exactly between
  the sync's param math and the delta push; the server evicts, the
  link heals, and the rejoin replay must land the blackholed delta
  EXACTLY once — asserted bitwise against the unkilled reference.

Four more scenarios drive the SERVING fleet (docs/SERVING.md): a
``serve.Router`` over shared-nothing ``ServeServer`` replicas —

* ``replica_kill``        — kill 1 of 3 replicas mid-wave; every
  accepted request must end in a terminal result (resubmitted to a
  survivor or a clean partial ``failed``), and the post-kill fleet
  keeps serving;
* ``slow_replica``        — a straggler replica stalls prefill; hedged
  requests must cancel there and complete on the healthy one;
* ``overload_shed``       — a saturated fleet refuses with RouterBusy +
  ``retry_after`` at both the router watermark and the replica's
  QueueFull, then admits again once drained;
* ``swap_during_traffic`` — an epoch-2 checkpoint lands under shared-
  prefix load with the radix prefix cache on; zero failed streams,
  zero fence violations, no stream observes two epochs, and the swap
  must invalidate the cache — post-swap repeats of pre-swap prompts
  are checked against a fresh epoch-2 reference (zero stale-KV
  streams).

Three TRAFFIC scenarios exercise the observability plane end-to-end
(docs/OBSERVABILITY.md) — realistic request mixes instead of injected
faults —

* ``zipf_mix``     — Zipf-popularity shared-prefix catalog (a system-
  prompt pool) over a 2-replica fleet with the radix prefix cache on;
  every repeat of a prompt must decode to the identical token stream
  whether its prefill came from compute or cached pages (greedy decode
  is a fleet-wide contract), cache hits and ``cached_tokens`` must
  surface, TTFT p95 must hold, and the obs counters must account for
  every request;
* ``diurnal``      — a one-day sine of wave sizes against one replica;
  the windowed TTFT-p95 SLO must breach at the peak and recover once
  the trough traffic leaves the window (``slo_breaches_total`` /
  ``slo_recoveries_total`` both fire);
* ``flash_crowd``  — a 10x request burst against a one-replica fleet;
  the obs-driven autoscaler (``tools.autoscaler``) must scale up on the
  TTFT breach, the burst must complete with the spawned replica taking
  real dispatches, and after the crowd passes the fleet must cool down
  and retire back to baseline.

Settle/recovery budgets honor ``DISTLEARN_CHAOS_SETTLE_S`` and
``DISTLEARN_CHAOS_RECOVER_S`` (seconds) for slow CI machines.

Importable: the tests and ``chip_smoke.py`` drive run_parity /
run_churn / run_scenario directly.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import socket
import sys
import tempfile
import threading
import time
from contextlib import closing

import numpy as np
import torch

from distlearn_tpu_torch.comm import FaultPlan, ProtocolError
from distlearn_tpu_torch.obs import core, export, trace
from distlearn_tpu_torch.parallel import ha
from distlearn_tpu_torch.parallel.async_ea import (
    ENTER, ENTER_Q, AsyncEAClient, AsyncEAServerConcurrent)
from distlearn_tpu_torch.utils.platform import resolve_device

_SYNC_ERRORS = (OSError, TimeoutError, ProtocolError)

#: CI-tunable budgets: how long a fleet may take to drain in-flight legs
#: (settle) and how long a client may take to re-enter after a fault
#: (recover).  Loaded once at import; override via the environment.
CHAOS_SETTLE_S = float(os.environ.get("DISTLEARN_CHAOS_SETTLE_S", "30"))
CHAOS_RECOVER_S = float(os.environ.get("DISTLEARN_CHAOS_RECOVER_S", "120"))


def _open_trail(trail: str | None) -> None:
    """Spill the run's spans to ``trail`` (a JSONL path; ``None``: none)."""
    if trail is not None:
        trace.set_spill(trail)


def _close_trail(trail: str | None) -> None:
    """End the spill and append the run's registry snapshot to ``trail``
    (before the run resets the registry), so ``tools.diststat`` reads its
    counters and histograms."""
    if trail is not None:
        trace.set_spill(None)
        export.write_snapshot(trail)


def _reserve_window(n: int, host: str = "127.0.0.1") -> int:
    """A base port whose window ``base .. base+n-1`` was just bindable
    (tests/net_util.py idiom — tools must not import tests/)."""
    for _ in range(256):
        with closing(socket.socket()) as probe:
            probe.bind((host, 0))
            base = probe.getsockname()[1]
        if base + n >= 65535:
            continue
        socks = []
        try:
            try:
                for i in range(n):
                    s = socket.socket()
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    s.bind((host, base + i))
                    socks.append(s)
            except OSError:
                continue
            return base
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"could not reserve a {n}-port window")


_SHAPES = (("a", (64, 3)), ("b", (7,)), ("c", (32, 32)),
           ("d", (5,)), ("e", (128,)), ("f", (2, 2)))


def _seeded(seed: int, shapes, device) -> dict:
    """Seeded standard normals (the JAX tool's numpy draws, leaf by leaf)
    as float32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).to(device)
            for k, shape in shapes}


def _params(shapes=_SHAPES, device="cpu") -> dict:
    """Six float32 leaves, ragged shapes (mirrors the shard tests) —
    exercises sub-leaf striping at S=4 (or ``shapes``' leaves)."""
    return _seeded(0, shapes, device)


def _target(shapes=_SHAPES, device="cpu") -> dict:
    """The descent target for the elastic scenarios — a fixed point every
    client pulls toward, so 'did the varying fleet still converge' is a
    measurable distance, not a vibe."""
    return _seeded(1, shapes, device)


def _drift(p: dict, r: int) -> dict:
    """Deterministic dyadic local 'training' step — exactly
    representable in float32, so parity can be asserted bitwise."""
    step = float(np.float32((r % 5) + 0.25))
    return {k: v + step for k, v in p.items()}


def _descend(p: dict, tgt: dict) -> dict:
    """One gradient step toward ``tgt`` (lr 0.25, dyadic): unlike
    ``_drift`` the fixed point is the same for ANY fleet size, so the
    elastic scenarios can assert distance-to-target against a
    fixed-fleet reference."""
    lr = 0.25
    return {k: v - lr * (v - tgt[k]) for k, v in p.items()}


def _dist(center: list, tgt: dict) -> float:
    """Max per-leaf RMS distance between a center snapshot and the
    target (leaf order: sorted keys, matching the pytree flatten)."""
    worst = 0.0
    for leaf, key in zip(center, sorted(tgt)):
        want = tgt[key].cpu().numpy()
        if leaf.shape != want.shape:
            raise RuntimeError(
                f"leaf order drifted: {leaf.shape} vs {key}:{want.shape}")
        worst = max(worst, float(np.sqrt(np.mean((leaf - want) ** 2))))
    return worst


def _live(srv) -> int:
    return len(srv.members - srv.evicted)


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return -1


def _totals(snap: list[dict]) -> dict:
    """Counter/gauge family name -> summed value across label sets."""
    out = {}
    for fam in snap:
        if fam["kind"] not in ("counter", "gauge"):
            continue
        out[fam["name"]] = sum(s.get("value", 0) for s in fam["samples"])
    return out


def _labeled(snap: list[dict], name: str) -> dict:
    for fam in snap:
        if fam["name"] == name:
            return {json.dumps(s["labels"], sort_keys=True): s["value"]
                    for s in fam["samples"]}
    return {}


def _quiet(srv) -> bool:
    with srv._lock:
        if srv._inflight:
            return False
    return (all(q.empty() for q in srv._queues.values())
            and all(q.empty() for q in srv._shard_queues.values()))


def _settle_fleet(clients, srv, timeout: float | None = None) -> None:
    """Block until every submitted delta is fully applied: overlap
    senders flushed, no leg in flight, sync count stable across two
    quiet polls."""
    for cl in clients:
        if cl._sender is not None:
            cl._sender.flush()
    deadline = time.monotonic() + (CHAOS_SETTLE_S if timeout is None
                                   else timeout)
    last = -1
    while time.monotonic() < deadline:
        if _quiet(srv):
            n = srv.syncs_completed
            if n == last:
                return
            last = n
        else:
            last = -1
        time.sleep(0.05)
    raise RuntimeError("fleet did not settle (legs still in flight)")


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


def _spawn_fleet(host, port, num_clients, shards, codecs, overlap,
                 centers, params, handshake_timeout=5.0,
                 rejoin_grace=60.0, elastic=False, tau=1, alpha=0.5,
                 adaptive_tau=False, server_centers=None):
    """Server + clients, concurrently (both constructors block on the
    accept/dial handshake), every role on ``params``' device.  Returns
    (server, [clients], [params]).  ``server_centers`` is the HA roster
    the server advertises in Join ACKs so Join?-admitted clients can
    failover() too."""
    box: dict = {}
    device = _device_of(params)

    def _dial(i):
        try:
            box[i] = AsyncEAClient(
                host, port, node=i + 1, tau=tau, alpha=alpha,
                codec=codecs[i % len(codecs)], overlap=overlap,
                centers=centers, adaptive_tau=adaptive_tau, device=device)
        except Exception as e:  # noqa: BLE001 — surfaced below
            box[i] = e

    threads = [threading.Thread(target=_dial, args=(i,), daemon=True)
               for i in range(num_clients)]
    for t in threads:
        t.start()
    srv = AsyncEAServerConcurrent(
        host, port, num_nodes=num_clients, shards=shards,
        accept_timeout=60.0, handshake_timeout=handshake_timeout,
        rejoin_grace=rejoin_grace, elastic=elastic,
        centers=server_centers, device=device)
    for t in threads:
        t.join(timeout=60.0)
    clients = []
    for i in range(num_clients):
        got = box.get(i)
        if not isinstance(got, AsyncEAClient):
            raise RuntimeError(f"client {i + 1} dial failed: {got!r}")
        clients.append(got)
    # the clients receive the center while the server sends it: a center
    # larger than the sockets' buffers would block a server sending alone
    ps: list = [None] * num_clients

    def _init(i):
        try:
            ps[i] = clients[i].init_client(params)
        except Exception as e:  # noqa: BLE001 — surfaced below
            ps[i] = e

    threads = [threading.Thread(target=_init, args=(i,), daemon=True)
               for i in range(num_clients)]
    for t in threads:
        t.start()
    srv.init_server(params)
    for t in threads:
        t.join(timeout=60.0)
    for i, got in enumerate(ps):
        if not isinstance(got, dict):
            raise RuntimeError(f"client {i + 1} init failed: {got!r}")
    srv.start()
    return srv, clients, ps


def _kill_and_promote(srv, host, new_port, params, ckpt_dir, shards,
                      ckpt_every, *, flush_first, stop_deadline=2.0,
                      handshake_timeout=5.0, rejoin_grace=60.0):
    """The failover event: (optionally checkpoint, then) kill the
    primary, construct a standby on the other port window, promote it
    from the checkpoint directory, start serving.  Returns the promoted
    server."""
    if flush_first:
        srv.checkpoint_now(wait=True)
    srv.stop(deadline=stop_deadline)
    srv.close()   # blocks on the async ckpt writer: promotion sees it
    standby = AsyncEAServerConcurrent(
        host, new_port, num_nodes=srv.num_nodes, shards=shards,
        handshake_timeout=handshake_timeout, rejoin_grace=rejoin_grace,
        standby=True, device=_device_of(params))
    ha.promote(standby, ckpt_dir, params)
    standby.enable_checkpoint(ckpt_dir, every=ckpt_every)
    standby.start()
    return standby


def _sync_with_failover(cl, p, attempts: int = 100):
    """One round's sync, retried through ``failover`` until it lands.
    The drift for the round happened OUTSIDE this loop, so a retry
    replays the same local state."""
    last = None
    for _ in range(attempts):
        try:
            p2, _ = cl.sync_client(p)
            return p2
        except _SYNC_ERRORS as e:
            last = e
            cl.failover(p, retries=40, retry_interval=0.01,
                        handshake_timeout=15.0)
    raise RuntimeError(f"sync never succeeded after failover: {last!r}")


def _leaves_of(srv) -> list[np.ndarray]:
    return [np.array(t) for t in srv._snapshot()]


def _teardown(clients, srv):
    for cl in clients:
        try:
            cl.close()
        except (OSError, RuntimeError):
            pass
    srv.stop(deadline=5.0)
    srv.close()


def _settle_leaks(fd_base: int, th_base: int, timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _fd_count() <= fd_base and threading.active_count() <= th_base:
            break
        time.sleep(0.1)
    return _fd_count(), threading.active_count()


def _run_reference(host: str, rounds: int, overlap: bool,
                   shapes=_SHAPES, device="cpu") -> tuple:
    """Unkilled S=1 raw-wire run — the parity oracle."""
    port = _reserve_window(4, host)
    base = _params(shapes, device)
    srv, (cl,), (p,) = _spawn_fleet(host, port, 1, 1, ["raw"], overlap,
                                    None, base)
    for r in range(rounds):
        p = _drift(p, r)
        p, _ = cl.sync_client(p)
    _settle_fleet([cl], srv)
    center = _leaves_of(srv)
    _teardown([cl], srv)
    return p, center


def run_parity(rounds: int = 16, kills=(6,), shards: int = 4,
               overlap: bool = True, ckpt_every: int = 1,
               mid_flight: bool = False, host: str = "127.0.0.1", *,
               shapes=_SHAPES, device=None, trail: str | None = None
               ) -> dict:
    """Kill/promote soak asserting bitwise convergence-to-parity.

    ``kills``: rounds at which the center dies.  Boundary mode kills
    between rounds (checkpoint flushed first); ``mid_flight`` kills
    while the kill-round's delta is on the wire, so recovery leans on
    the rejoin replay instead of the checkpoint alone.  ``shapes``: the
    leaves, ``(name, shape)`` pairs; ``device``: every role's; ``trail``:
    a JSONL path the run's spans and final registry snapshot go to.
    """
    kills = sorted(set(int(k) for k in kills))
    if kills and (kills[0] < 1 or kills[-1] >= rounds):
        raise ValueError("kill rounds must fall inside 1..rounds-1")
    device = resolve_device(device)
    core.configure(True)
    core.REGISTRY.reset()
    _open_trail(trail)
    tmp = tempfile.mkdtemp(prefix="chaos-ckpt-")
    try:
        ref_p, ref_center = _run_reference(host, rounds, overlap, shapes,
                                           device)
        fd_base, th_base = _fd_count(), threading.active_count()

        windows = [_reserve_window(8, host), _reserve_window(8, host)]
        win = 0
        base = _params(shapes, device)
        srv, (cl,), (p,) = _spawn_fleet(
            host, windows[0], 1, shards, ["raw"], overlap,
            [(host, windows[1])], base)
        srv.enable_checkpoint(tmp, every=ckpt_every)
        killset = set(kills)
        for r in range(rounds):
            if r in killset:
                _settle_fleet([cl], srv)
                if mid_flight:
                    # prior rounds durable; the kill-round delta itself
                    # is covered by the ledger + rejoin replay
                    srv.checkpoint_now(wait=True)
                    p = _drift(p, r)
                    p, _ = cl.sync_client(p)
                    win = 1 - win
                    srv = _kill_and_promote(
                        srv, host, windows[win], base, tmp, shards,
                        ckpt_every, flush_first=False, stop_deadline=0.25)
                    continue
                win = 1 - win
                srv = _kill_and_promote(
                    srv, host, windows[win], base, tmp, shards,
                    ckpt_every, flush_first=True)
            p = _drift(p, r)
            p = _sync_with_failover(cl, p)
        _settle_fleet([cl], srv)
        center = _leaves_of(srv)
        _teardown([cl], srv)
        fd_end, th_end = _settle_leaks(fd_base, th_base)
        snap = core.REGISTRY.snapshot()

        totals = _totals(snap)
        failures = []
        for i, (a, b) in enumerate(zip(ref_center, center)):
            if a.dtype != b.dtype or not np.array_equal(a, b):
                failures.append(f"center leaf {i} diverged "
                                f"(max |d|={np.abs(a - b).max()})")
        for k in ref_p:
            if not torch.equal(ref_p[k], p[k]):
                failures.append(f"client param {k!r} diverged")
        n_kills = len(kills)
        checks = [
            ("promotions", totals.get(
                "async_ea_failover_promotions_total", 0), n_kills),
            ("ckpt_restores", totals.get(
                "center_ckpt_restores_total", 0), n_kills),
            ("stale_refusals", totals.get(
                "async_ea_failover_stale_refusals_total", 0), 0),
        ]
        for name, got, want in checks:
            if got != want:
                failures.append(f"{name}: got {got}, want {want}")
        if totals.get("async_ea_failover_redials_total", 0) < n_kills:
            failures.append("fewer re-dials than kills")
        if totals.get("center_ckpt_saves_total", 0) < 1:
            failures.append("no checkpoints were saved")
        if totals.get("async_ea_server_threads", 0) != 0:
            failures.append("server thread gauge nonzero after stop")
        if totals.get("async_ea_inflight", 0) != 0:
            failures.append("inflight gauge nonzero after stop")
        if fd_end > fd_base + 2:
            failures.append(f"fd leak: {fd_base} -> {fd_end}")
        if th_end > th_base:
            failures.append(f"thread leak: {th_base} -> {th_end}")

        report = {
            "scenario": "parity",
            "rounds": rounds, "kills": kills, "shards": shards,
            "overlap": overlap, "mid_flight": mid_flight,
            "promotions": totals.get(
                "async_ea_failover_promotions_total", 0),
            "redials": totals.get("async_ea_failover_redials_total", 0),
            "replays": _labeled(snap,
                                "async_ea_failover_replays_total"),
            "ckpt_saves": totals.get("center_ckpt_saves_total", 0),
            "fds": [fd_base, fd_end], "threads": [th_base, th_end],
            "failures": failures,
        }
        if failures:
            raise AssertionError("chaos parity failed: "
                                 + "; ".join(failures)
                                 + f"\n{json.dumps(report, indent=2)}")
        return report
    finally:
        _close_trail(trail)
        core.REGISTRY.reset()
        core.configure(None)
        shutil.rmtree(tmp, ignore_errors=True)


def _client_self_kill(cl):
    """Die mid-handshake: announce Enter?, then vanish.  The center's
    handshake deadline evicts the cid; the same client object later
    recovers through rejoin/failover — no restart."""
    try:
        cl._announce(ENTER_Q, ENTER)
    except Exception:  # noqa: BLE001 — dying is the point
        pass
    for c in (cl.broadcast, cl.conn, *cl._shard_conns):
        try:
            c.close()
        except OSError:
            pass


def _recover(cl, p, deadline_s: float | None = None):
    """Post-self-kill recovery loop: rejoin the current center (must
    wait out our own eviction), falling back to the failover dial walk
    when the center itself died meanwhile."""
    deadline = time.monotonic() + (CHAOS_RECOVER_S if deadline_s is None
                                   else deadline_s)
    while time.monotonic() < deadline:
        try:
            return cl.rejoin(p, retries=5, retry_interval=0.02,
                             handshake_timeout=5.0)
        except _SYNC_ERRORS:
            time.sleep(0.05)
        try:
            return cl.failover(p, retries=10, retry_interval=0.02,
                               handshake_timeout=5.0)
        except _SYNC_ERRORS:
            time.sleep(0.05)
    raise RuntimeError(f"client {cl.node} could not recover")


def run_churn(rounds: int = 12, num_clients: int = 3, shards: int = 4,
              overlap: bool = True, server_kills: int = 2,
              ckpt_every: int = 1, host: str = "127.0.0.1", *,
              shapes=_SHAPES, device=None, trail: str | None = None
              ) -> dict:
    """Multi-client liveness soak: every client self-kills once
    (mid-handshake), the center dies ``server_kills`` times under load.
    Asserts liveness + counter sanity + zero leaks, NOT parity.
    ``shapes``: the leaves; ``device``: every role's; ``trail``: as
    :func:`run_parity`'s."""
    device = resolve_device(device)
    core.configure(True)
    core.REGISTRY.reset()
    _open_trail(trail)
    tmp = tempfile.mkdtemp(prefix="chaos-churn-")
    fd_base, th_base = _fd_count(), threading.active_count()
    try:
        nports = num_clients + 2 + max(0, shards - 1)
        windows = [_reserve_window(nports, host),
                   _reserve_window(nports, host)]
        base = _params(shapes, device)
        codecs = ["raw", "int8", "fp16"]   # mixed fleet
        srv, clients, ps = _spawn_fleet(
            host, windows[0], num_clients, shards, codecs, overlap,
            [(host, windows[1])], base,
            handshake_timeout=2.0, rejoin_grace=120.0)
        srv.enable_checkpoint(tmp, every=ckpt_every)

        errors: dict = {}
        done = threading.Event()

        def _drive(i, cl, p):
            kill_round = 2 + (i % max(1, rounds - 3))
            try:
                for r in range(rounds):
                    if r == kill_round:
                        _client_self_kill(cl)
                        p = _recover(cl, p)
                    p = _drift(p, r)
                    p = _sync_with_failover(cl, p)
            except Exception as e:  # noqa: BLE001 — reported below
                errors[i] = e

        threads = [threading.Thread(target=_drive, args=(i, cl, p),
                                    daemon=True)
                   for i, (cl, p) in enumerate(zip(clients, ps))]
        for t in threads:
            t.start()

        # center kills from the main thread, spread across the run
        win, kills_done = 0, 0
        total = rounds * num_clients
        srv_box = [srv]
        while any(t.is_alive() for t in threads):
            if (kills_done < server_kills
                    and srv_box[0].syncs_completed
                    >= (kills_done + 1) * total // (server_kills + 1)):
                win = 1 - win
                srv_box[0] = _kill_and_promote(
                    srv_box[0], host, windows[win], base, tmp, shards,
                    ckpt_every, flush_first=True, stop_deadline=2.0,
                    handshake_timeout=2.0, rejoin_grace=120.0)
                kills_done += 1
            time.sleep(0.05)
        done.set()
        for t in threads:
            t.join(timeout=60.0)

        _teardown(clients, srv_box[0])
        fd_end, th_end = _settle_leaks(fd_base, th_base)
        snap = core.REGISTRY.snapshot()

        totals = _totals(snap)
        failures = [f"client {i + 1} died: {e!r}"
                    for i, e in sorted(errors.items())]
        if any(t.is_alive() for t in threads):
            failures.append("client threads still alive (liveness)")
        if totals.get("async_ea_failover_promotions_total",
                      0) != kills_done:
            failures.append("promotions != server kills")
        if totals.get("async_ea_evictions_total", 0) < num_clients:
            failures.append("fewer evictions than client self-kills")
        if totals.get("async_ea_rejoins_total", 0) < num_clients:
            failures.append("fewer rejoins than client self-kills")
        if totals.get("async_ea_server_threads", 0) != 0:
            failures.append("server thread gauge nonzero after stop")
        if totals.get("async_ea_inflight", 0) != 0:
            failures.append("inflight gauge nonzero after stop")
        if fd_end > fd_base + 2:
            failures.append(f"fd leak: {fd_base} -> {fd_end}")
        if th_end > th_base:
            failures.append(f"thread leak: {th_base} -> {th_end}")

        report = {
            "scenario": "churn",
            "rounds": rounds, "clients": num_clients, "shards": shards,
            "server_kills": kills_done,
            "promotions": totals.get(
                "async_ea_failover_promotions_total", 0),
            "evictions": totals.get("async_ea_evictions_total", 0),
            "rejoins": totals.get("async_ea_rejoins_total", 0),
            "redials": totals.get("async_ea_failover_redials_total", 0),
            "replays": _labeled(snap,
                                "async_ea_failover_replays_total"),
            "fds": [fd_base, fd_end], "threads": [th_base, th_end],
            "failures": failures,
        }
        if failures:
            raise AssertionError("chaos churn failed: "
                                 + "; ".join(failures)
                                 + f"\n{json.dumps(report, indent=2)}")
        return report
    finally:
        _close_trail(trail)
        core.REGISTRY.reset()
        core.configure(None)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# Elastic-fleet scenario runner (docs/ELASTIC.md).

def _run_descend_reference(sz, host, steps, *, num_clients=2, tau=1,
                           alpha=0.5, adaptive_tau=False) -> float:
    """Fixed-fleet oracle for the elastic scenarios: the same descent
    dynamics with membership held constant and no faults.  Returns the
    settled center's distance to the target."""
    port = _reserve_window(num_clients + 3, host)
    tgt = _target(sz.shapes, sz.device)
    srv, clients, ps = _spawn_fleet(
        host, port, num_clients, 1, ["raw"], False, None,
        _params(sz.shapes, sz.device),
        tau=tau, alpha=alpha, adaptive_tau=adaptive_tau)
    try:
        for _s in range(steps):
            for i, cl in enumerate(clients):
                ps[i] = _descend(ps[i], tgt)
                ps[i], _ = cl.sync_client(ps[i])
        _settle_fleet(clients, srv)
        return _dist(_leaves_of(srv), tgt)
    finally:
        _teardown(clients, srv)


def _drive_round(clients, ps, tgt):
    for i, cl in enumerate(clients):
        ps[i] = _descend(ps[i], tgt)
        ps[i], _ = cl.sync_client(ps[i])


def _scenario_flash_join(rounds, seed, host, sz):
    """The fleet doubles mid-run: 2 founding clients, 2 more flash-join
    at rounds//3 and stay.  Peak membership must hit 2x and the settled
    center must land within tolerance of the fixed 2-client oracle."""
    del seed  # no faults injected — determinism comes from the dynamics
    tgt = _target(sz.shapes, sz.device)
    ref = _run_descend_reference(sz, host, rounds)
    port = _reserve_window(5, host)
    srv, clients, ps = _spawn_fleet(host, port, 2, 1, ["raw"], False,
                                    None, _params(sz.shapes, sz.device),
                                    elastic=True)
    peak = _live(srv)
    try:
        for r in range(rounds):
            if r == max(1, rounds // 3):
                for _ in range(2):
                    cl, pj = AsyncEAClient.join(
                        host, port, _params(sz.shapes, sz.device), 1, 0.5,
                        sharded=False, device=sz.device)
                    clients.append(cl)
                    ps.append(pj)
            _drive_round(clients, ps, tgt)
            peak = max(peak, _live(srv))
        _settle_fleet(clients, srv)
        dist = _dist(_leaves_of(srv), tgt)
    finally:
        _teardown(clients, srv)
    totals = _totals(core.REGISTRY.snapshot())
    tol = max(4.0 * ref, 1e-3)
    failures = []
    if peak != 4:
        failures.append(f"peak membership {peak}, want 4 (2x fleet)")
    if totals.get("async_ea_membership_joins_total", 0) != 2:
        failures.append("join counter != 2")
    if dist > tol:
        failures.append(f"did not converge: dist {dist:.4g} > tol "
                        f"{tol:.4g} (reference {ref:.4g})")
    return {"peak_members": peak, "dist": dist, "ref_dist": ref,
            "tol": tol}, failures


def _scenario_rolling_leave(rounds, seed, host, sz):
    """Join two clients (one at double capacity — the capacity-weighted
    averaging path), then leave them one at a time through the graceful
    ``Leave?`` flush.  Membership must return to the founding 2 with
    every leave accounted, and convergence must hold throughout."""
    del seed
    tgt = _target(sz.shapes, sz.device)
    ref = _run_descend_reference(sz, host, rounds)
    port = _reserve_window(5, host)
    srv, clients, ps = _spawn_fleet(host, port, 2, 1, ["raw"], False,
                                    None, _params(sz.shapes, sz.device),
                                    elastic=True)
    joined: list = []
    peak = _live(srv)
    leave_at = sorted({max(3, rounds // 2), max(4, (3 * rounds) // 4)})
    try:
        for r in range(rounds):
            if r == 1:
                for capacity in (1.0, 2.0):
                    cl, pj = AsyncEAClient.join(
                        host, port, _params(sz.shapes, sz.device), 1, 0.5,
                        capacity=capacity, sharded=False,
                        device=sz.device)
                    clients.append(cl)
                    ps.append(pj)
                    joined.append(cl)
            if r in leave_at and joined:
                cl = joined.pop()
                i = clients.index(cl)
                cl.leave()
                clients.pop(i)
                ps.pop(i)
            _drive_round(clients, ps, tgt)
            peak = max(peak, _live(srv))
        _settle_fleet(clients, srv)
        dist = _dist(_leaves_of(srv), tgt)
        final_live = _live(srv)
    finally:
        _teardown(clients, srv)
    totals = _totals(core.REGISTRY.snapshot())
    tol = max(4.0 * ref, 1e-3)
    failures = []
    if peak != 4:
        failures.append(f"peak membership {peak}, want 4 (2x fleet)")
    if final_live != 2:
        failures.append(f"final membership {final_live}, want the "
                        "founding 2")
    if totals.get("async_ea_membership_joins_total", 0) != 2:
        failures.append("join counter != 2")
    if totals.get("async_ea_membership_leaves_total", 0) != 2:
        failures.append("leave counter != 2")
    if dist > tol:
        failures.append(f"did not converge: dist {dist:.4g} > tol "
                        f"{tol:.4g} (reference {ref:.4g})")
    return {"peak_members": peak, "final_members": final_live,
            "dist": dist, "ref_dist": ref, "tol": tol}, failures


def _scenario_slow_node(rounds, seed, host, sz):
    """Straggler-adaptive τ under an injected link delay: both clients
    run ``adaptive_tau`` at (τ=2, α=0.1); after the latency floor is
    established, a seeded delay lands on one client's dedicated link.
    Its effective τ must stretch above τ_lo without crossing the α·τ
    stability bound τ_hi, and the fleet must still converge."""
    tgt = _target(sz.shapes, sz.device)
    steps = rounds * 2
    ref = _run_descend_reference(sz, host, steps, tau=2, alpha=0.1,
                                 adaptive_tau=True)
    port = _reserve_window(5, host)
    srv, clients, ps = _spawn_fleet(
        host, port, 2, 1, ["raw"], False, None,
        _params(sz.shapes, sz.device), tau=2, alpha=0.1, adaptive_tau=True)
    plan = FaultPlan(seed)
    slow = clients[1]
    plan.wrap(slow.conn, "slow")
    warm = max(4, steps // 3)
    try:
        for s in range(steps):
            if s == warm:
                # only now: the τ controller must stretch from an
                # OBSERVED floor, not from a never-fast baseline
                plan.delay("slow", 0.05)
            _drive_round(clients, ps, tgt)
        plan.heal("slow")
        _settle_fleet(clients, srv)
        dist = _dist(_leaves_of(srv), tgt)
        tau_slow = slow.tau_effective
        tau_fast = clients[0].tau_effective
        lo, hi = slow._tau_lo, slow._tau_hi
    finally:
        _teardown(clients, srv)
    tol = max(6.0 * ref, 5e-2)
    failures = []
    if tau_slow <= lo:
        failures.append(f"adaptive tau never stretched: {tau_slow} <= "
                        f"tau_lo {lo} despite the injected delay")
    if tau_slow > hi:
        failures.append(f"adaptive tau {tau_slow} crossed the "
                        f"alpha*tau stability bound {hi}")
    if tau_fast > lo:
        failures.append(f"fast client stretched to {tau_fast} with no "
                        "fault on its link")
    if dist > tol:
        failures.append(f"did not converge: dist {dist:.4g} > tol "
                        f"{tol:.4g} (reference {ref:.4g})")
    return {"tau_slow": tau_slow, "tau_fast": tau_fast,
            "tau_bounds": [lo, hi], "dist": dist, "ref_dist": ref,
            "tol": tol, "fault_log": len(plan.decisions())}, failures


def _scenario_partition_heal(rounds, seed, host, sz):
    """One-way send partition landing EXACTLY between a sync's param
    math and its delta push (the overlap sender's submit hook): the
    blackholed delta 'succeeds' client-side, the server's handshake
    timeout evicts the cid without applying it, the link heals, and the
    rejoin replay must land the pending delta exactly once — asserted
    BITWISE against the unkilled reference run (same guarantee the
    parity soak proves for kill/promote, here for partition/heal)."""
    ref_p, ref_center = _run_reference(host, rounds, True, sz.shapes,
                                       sz.device)
    port = _reserve_window(4, host)
    base = _params(sz.shapes, sz.device)
    srv, (cl,), (p,) = _spawn_fleet(host, port, 1, 1, ["raw"], True,
                                    None, base)
    plan = FaultPlan(seed)
    plan.wrap(cl.conn, "c1")
    k = max(1, rounds // 2)
    failures = []
    try:
        for r in range(rounds):
            p = _drift(p, r)
            if r == k:
                orig = cl._sender.submit

                def _cut(job, _orig=orig):
                    plan.partition("c1", "send")
                    return _orig(job)

                cl._sender.submit = _cut
                p, _ = cl.sync_client(p)
                cl._sender.submit = orig
                # the push is blackholed mid-handshake; the server's
                # handshake timeout must evict without applying seq k
                deadline = time.monotonic() + CHAOS_RECOVER_S
                while (cl.node not in srv.evicted
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
                if cl.node not in srv.evicted:
                    failures.append("server never evicted the "
                                    "partitioned client")
                plan.heal("c1")
            else:
                p = _sync_with_failover(cl, p)
        _settle_fleet([cl], srv)
        center = _leaves_of(srv)
    finally:
        _teardown([cl], srv)
    totals = _totals(core.REGISTRY.snapshot())
    dropped = plan.dropped_bytes("c1")
    for i, (a, b) in enumerate(zip(ref_center, center)):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            failures.append(f"center leaf {i} diverged "
                            f"(max |d|={np.abs(a - b).max()})")
    for key in ref_p:
        if not torch.equal(ref_p[key], p[key]):
            failures.append(f"client param {key!r} diverged")
    if dropped <= 0:
        failures.append("partition blackholed no bytes — the fault "
                        "never landed on the delta push")
    if totals.get("async_ea_evictions_total", 0) < 1:
        failures.append("no eviction recorded")
    if totals.get("async_ea_rejoins_total", 0) < 1:
        failures.append("no rejoin recorded — the replay path never ran")
    return {"partition_round": k, "dropped_bytes": dropped,
            "evictions": totals.get("async_ea_evictions_total", 0),
            "rejoins": totals.get("async_ea_rejoins_total", 0)}, failures


# ---------------------------------------------------------------------------
# Serving-fleet scenario runner (docs/SERVING.md): a Router over N
# shared-nothing ServeServer replicas under client load while faults land.

_SERVE_LM = {"vocab": 61, "dim": 32, "depth": 2, "heads": 4, "max_len": 64}


@dataclasses.dataclass
class Sizes:
    """What a scenario runs at, and where.  The defaults are the JAX
    tool's: six ragged leaves, ``_SERVE_LM``, prompts of 3-8 tokens and a
    24-token shared prefix, the scheduler's own prefill chunk.

    ``device``: every role's tensors; ``shapes``: the AsyncEA leaves,
    ``(name, shape)`` pairs; ``lm``: the serving LM's config
    (``transformer_lm`` keywords); ``params``: its weights (``None``:
    ``lm``'s seeded init on ``device``); ``prompt_lens``: ``[lo, hi)`` of
    a request's prompt length; ``prefix_len``: the shared-prefix
    catalog's system prompts (keep it a multiple of the page, 8);
    ``prefill_chunk``: the replicas' chunk bound (``None``: the
    scheduler's default, the engine's smallest bucket)."""
    device: torch.device = None
    shapes: tuple = _SHAPES
    lm: dict = dataclasses.field(default_factory=lambda: dict(_SERVE_LM))
    params: object = None
    prompt_lens: tuple = (3, 9)
    prefix_len: int = 24
    prefill_chunk: int | None = None


def _lm_params(sz):
    if sz.params is not None:
        return sz.params
    from distlearn_tpu_torch.models.transformer import transformer_lm
    model = transformer_lm(**sz.lm)
    params, _ = model.init(0, sz.device)
    return params


def _serve_prompts(n, seed, sz):
    rng = np.random.default_rng(seed)
    lo, hi = sz.prompt_lens
    return [rng.integers(1, sz.lm["vocab"],
                         size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def _prefixed_prompts(n, seed, sz, *, pool=3):
    """Shared-prefix catalog: each prompt is a 'system prompt' drawn
    from a small pool (page-aligned length, so the radix prefix cache
    can retain it) plus a short unique suffix — the traffic shape the
    prefix cache exists for."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(1, sz.lm["vocab"],
                             size=sz.prefix_len).astype(np.int32)
                for _ in range(pool)]
    out = []
    for i in range(n):
        sfx = rng.integers(1, sz.lm["vocab"],
                           size=int(rng.integers(4, 9))).astype(np.int32)
        out.append(np.concatenate([prefixes[i % pool], sfx]))
    return out


def _hist_sample(snap, name):
    for fam in snap:
        if fam["name"] == name and fam["samples"]:
            return fam["samples"][0]
    return None


def _hist_p95(sample, base=None):
    """p95 upper bound from a snapshot histogram (the smallest bucket
    edge covering 95% of observations; inf when the tail spilled past
    the last bound).  ``base`` subtracts an earlier snapshot so warmup
    samples (jit compiles) don't pollute the steady-state quantile."""
    if sample is None:
        return None
    buckets = dict(sample["buckets"])
    count = sample["count"]
    if base is not None:
        for k in buckets:
            buckets[k] -= base["buckets"].get(k, 0)
        count -= base["count"]
    if count <= 0:
        return None
    need = math.ceil(0.95 * count)
    cum = 0
    for b in sorted(float(k) for k in buckets):
        cum += buckets[str(b)]
        if cum >= need:
            return b
    return float("inf")


def _spawn_replicas(host, port, n, params, sz, *, num_slots=2,
                    **server_kw):
    """N independent single-process replicas on consecutive ports, each
    with its own engine and KV cache (shared-nothing, like the real
    fleet — only the checkpoint directory may be shared), on
    ``sz.device``."""
    from distlearn_tpu_torch.serve.engine import DecodeEngine
    from distlearn_tpu_torch.serve.server import ServeServer
    servers = []
    for i in range(n):
        eng = DecodeEngine(params, num_slots=num_slots,
                           max_len=sz.lm["max_len"], page=8,
                           device=sz.device)
        servers.append(ServeServer(eng, host=host, port=port + i,
                                   idle_wait=0.005,
                                   prefill_chunk=sz.prefill_chunk,
                                   **server_kw).start())
    return servers


def _stop_replicas(servers):
    for srv in servers:
        try:
            srv.stop()
        except OSError:
            pass


def _fleet_load(router, prompts, max_new, *, stagger=0.0, timeout=None,
                on_index=None):
    """One ``router.generate`` per prompt from worker threads (launch
    staggered from the calling thread), collecting a result-or-exception
    per request.  ``on_index(i)`` runs in the calling thread just before
    request ``i`` launches — the scenario's fault hook.  Returns
    ``(results, hung)`` where ``hung`` counts threads that outlived the
    recovery budget (always a failure)."""
    timeout = CHAOS_RECOVER_S if timeout is None else timeout
    out: list = [None] * len(prompts)

    def _one(i):
        try:
            out[i] = router.generate(prompts[i], max_new, rid=f"q{i}",
                                     timeout=timeout)
        except Exception as e:  # noqa: BLE001 — classified by the caller
            out[i] = e

    threads = []
    for i in range(len(prompts)):
        if on_index is not None:
            on_index(i)
        t = threading.Thread(target=_one, args=(i,), daemon=True)
        t.start()
        threads.append(t)
        if stagger:
            time.sleep(stagger)
    for t in threads:
        t.join(timeout=CHAOS_RECOVER_S)
    return out, sum(1 for t in threads if t.is_alive())


def _scenario_replica_kill(rounds, seed, host, sz):
    """Kill 1 of 3 replicas under a staggered request wave.  Every
    accepted request must end in a terminal result: queued-not-yet-
    prefilled requests resubmitted to survivors (``router_retries_total``),
    mid-stream deaths surfaced as clean ``reason="failed"`` with the
    partial tokens — never a hang or an unclassified error.  The
    post-kill fleet must keep completing fresh requests on the two
    survivors.

    The kill is ordered by an event, not by the wave's timing: at request
    ``kill_at`` replica 0 stops admitting (the scheduler's hold, as a
    swap raises it) and dies once it holds an accepted request that never
    prefilled, so the resubmission path runs on every run."""
    from distlearn_tpu_torch.serve.router import Router
    params = _lm_params(sz)
    port = _reserve_window(3, host)
    servers = _spawn_replicas(host, port, 3, params, sz)
    total = rounds * 3
    kill_at = total // 2
    killer: list = []

    def _kill_when_queued():
        deadline = time.monotonic() + CHAOS_SETTLE_S
        while (servers[0].sched.queue_depth() < 1
               and time.monotonic() < deadline):
            time.sleep(0.005)
        servers[0].stop()               # hard kill: sockets cut

    try:
        with Router([(host, port + i) for i in range(3)],
                    health_ttl=0.05, retry_interval=0.02,
                    dial_deadline=1.0) as router:

            def _fault(i):
                if i == kill_at:
                    servers[0].sched.hold = True
                    killer.append(threading.Thread(
                        target=_kill_when_queued, daemon=True))
                    killer[0].start()

            results, hung = _fleet_load(
                router, _serve_prompts(total, seed, sz), 4,
                stagger=0.02, on_index=_fault)
            for t in killer:
                t.join(CHAOS_SETTLE_S + 10.0)
            post, hung_post = _fleet_load(
                router, _serve_prompts(6, seed + 1, sz), 4)
    finally:
        _stop_replicas(servers)
    snap = core.REGISTRY.snapshot()
    retries = sum(_labeled(snap, "router_retries_total").values())
    dispatched = _labeled(snap, "router_dispatch_total")
    done = [r for r in results
            if isinstance(r, dict) and r["reason"] in ("complete", "eos")]
    failed = [r for r in results
              if isinstance(r, dict) and r["reason"] == "failed"]
    errs = [r for r in results if not isinstance(r, dict)]
    failures = []
    if hung or hung_post:
        failures.append(f"{hung + hung_post} request thread(s) hung past "
                        "the recovery budget")
    if errs:
        failures.append(f"{len(errs)} request(s) raised instead of ending "
                        f"in a terminal result: {errs[:3]!r}")
    if len(done) + len(failed) != total:
        failures.append(f"terminal results {len(done)}+{len(failed)} != "
                        f"accepted {total}")
    if any(len(r["tokens"]) != 4 for r in done):
        failures.append("a completed stream delivered a short token count")
    if retries + len(failed) < 1:
        failures.append("the kill was never observed: no resubmission and "
                        "no mid-stream failure")
    if len(dispatched) < 2:
        failures.append("load never spread past one replica")
    bad_post = [r for r in post
                if not (isinstance(r, dict) and r["reason"] == "complete")]
    if bad_post:
        failures.append(f"post-kill fleet dropped {len(bad_post)} of "
                        f"{len(post)} fresh requests: {bad_post[:3]!r}")
    return {"requests": total, "completed": len(done),
            "failed_mid_stream": len(failed), "retries": retries,
            "replicas_dispatched": len(dispatched)}, failures


def _scenario_slow_replica(rounds, seed, host, sz):
    """One of two replicas turns straggler: its prefill path sleeps 0.4s
    (a replica wedged on compilation/paging — alive, answering probes,
    producing nothing).  With deadline-aware hedging armed at 0.1s,
    requests stuck behind it with no first token must cancel there and
    re-dispatch: every request completes and ``router_hedges_total``
    fires.  At-most-once holds — the canceled copy decodes into a
    closed socket, never into the client.  The stall wraps
    ``engine.prefill_step``, the call the scheduler prefills through
    (the JAX tool wraps ``engine.admit``, which its scheduler never
    calls)."""
    from distlearn_tpu_torch.serve.router import Router
    params = _lm_params(sz)
    port = _reserve_window(2, host)
    servers = _spawn_replicas(host, port, 2, params, sz)
    slow = servers[0]                       # list head wins score ties
    orig_prefill = slow.engine.prefill_step

    def _slow_prefill(*a, **kw):
        time.sleep(0.4)
        return orig_prefill(*a, **kw)

    slow.engine.prefill_step = _slow_prefill
    try:
        with Router([(host, port), (host, port + 1)], health_ttl=0.02,
                    hedge_after=0.1, retry_interval=0.02,
                    dial_deadline=1.0) as router:
            results, hung = _fleet_load(
                router, _serve_prompts(rounds, seed, sz), 4, stagger=0.05)
    finally:
        _stop_replicas(servers)
    snap = core.REGISTRY.snapshot()
    hedges = sum(_labeled(snap, "router_hedges_total").values())
    done = [r for r in results
            if isinstance(r, dict) and r["reason"] == "complete"]
    failures = []
    if hung:
        failures.append(f"{hung} request thread(s) hung")
    if len(done) != rounds:
        bad = [r for r in results if r not in done]
        failures.append(f"only {len(done)}/{rounds} completed: "
                        f"{bad[:3]!r}")
    if hedges < 1:
        failures.append("no hedge fired despite the straggler")
    fast = f"{host}:{port + 1}"
    if not any(r.get("replica") == fast for r in done):
        failures.append("no completion landed on the healthy replica")
    return {"requests": rounds, "completed": len(done),
            "hedges": hedges}, failures


def _scenario_overload_shed(rounds, seed, host, sz):
    """Saturate a one-replica fleet with a long slow decode.  Router
    admission control must refuse new work with ``RouterBusy`` carrying
    a ``retry_after`` hint (graceful degradation, not a client-side
    timeout); the replica's own ``QueueFull`` shed must surface through
    a watermark-less router as RouterBusy too; and once the backlog
    drains the same fleet must accept work again."""
    from distlearn_tpu_torch.serve.router import Router, RouterBusy
    params = _lm_params(sz)
    port = _reserve_window(1, host)
    (srv,) = _spawn_replicas(host, port, 1, params, sz, num_slots=1,
                             max_queue=1)
    orig_tick = srv.engine.tick

    def _slow_tick(*a, **kw):
        time.sleep(0.05)                    # ~2.4s for the 48-token run
        return orig_tick(*a, **kw)

    srv.engine.tick = _slow_tick
    prompts = _serve_prompts(3, seed, sz)
    failures: list = []
    box: dict = {}
    try:
        with Router([(host, port)], shed_watermark=1, health_ttl=0.01,
                    dial_deadline=1.0) as router, \
             Router([(host, port)], shed_watermark=None, health_ttl=0.01,
                    dial_deadline=1.0) as bare:

            def _bg(key, rtr, prompt, max_new):
                def _run():
                    try:
                        box[key] = rtr.generate(prompt, max_new, rid=key,
                                                timeout=CHAOS_RECOVER_S)
                    except Exception as e:  # noqa: BLE001
                        box[key] = e
                t = threading.Thread(target=_run, daemon=True)
                t.start()
                return t

            t_long = _bg("long", router, prompts[0], 48)
            deadline = time.monotonic() + CHAOS_SETTLE_S
            while time.monotonic() < deadline:
                h = router.health()
                if h["queue_depth"] + h["active"] >= 1:
                    break
                time.sleep(0.01)
            else:
                failures.append("the long request never showed up in "
                                "fleet health")
            # router-level shed: aggregate depth is at the watermark
            sheds = hint = 0
            for i in range(rounds):
                try:
                    router.generate(prompts[1], 4, rid=f"shed{i}",
                                    timeout=5.0)
                    failures.append("a request was admitted past the "
                                    "watermark")
                except RouterBusy as e:
                    sheds += 1
                    hint = e.retry_after
                    if not e.retry_after or e.retry_after <= 0:
                        failures.append("RouterBusy without a retry_after "
                                        "hint")
            # replica-level shed: fill the depth-1 queue, then the next
            # submit gets the QueueFull rejection chunk and the
            # watermark-less router re-raises it as "every replica shed"
            t_fill = _bg("fill", bare, prompts[2], 4)
            deadline = time.monotonic() + CHAOS_SETTLE_S
            while (srv.sched.queue_depth() < 1
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            try:
                bare.generate(prompts[1], 4, rid="reject", timeout=5.0)
                failures.append("the replica's QueueFull never surfaced")
            except RouterBusy as e:
                if not e.retry_after:
                    failures.append("replica shed lost its retry_after "
                                    "hint through the router")
            t_long.join(CHAOS_RECOVER_S)
            t_fill.join(CHAOS_RECOVER_S)
            for key, want in (("long", 48), ("fill", 4)):
                got = box.get(key)
                if not (isinstance(got, dict)
                        and got["reason"] == "complete"
                        and len(got["tokens"]) == want):
                    failures.append(f"backlogged request {key!r} did not "
                                    f"complete: {got!r}")
            # drained fleet must admit again
            try:
                router.generate(prompts[1], 4, rid="after", timeout=30.0)
            except Exception as e:  # noqa: BLE001
                failures.append(f"post-drain request failed: {e!r}")
    finally:
        _stop_replicas([srv])
    totals = _totals(core.REGISTRY.snapshot())
    if totals.get("router_shed_total", 0) < sheds + 1:
        failures.append("router_shed_total undercounts the sheds")
    return {"sheds": sheds, "retry_after_hint": hint,
            "shed_total": totals.get("router_shed_total", 0)}, failures


def _scenario_swap_during_traffic(rounds, seed, host, sz):
    """Epoch-fenced hot weight swap under live SHARED-PREFIX traffic
    with the radix prefix cache on: both replicas tail one checkpoint
    directory; a new center (epoch 2) lands mid-wave while cached
    KV pages from epoch-1 prefills are live in both caches.  The fence
    must hold — zero failed streams, zero fence violations, every
    stream pinned to exactly one epoch (the 'R'-chunk echo), both
    replicas converging to epoch 2 — AND the swap must invalidate the
    prefix cache: post-swap repeats of pre-swap catalog prompts are
    decoded against a fresh epoch-2 reference engine, so a single
    stale epoch-1 KV page surviving the fence shows up as a diverged
    stream (zero tolerated)."""
    from distlearn_tpu_torch.models.transformer import greedy_generate
    from distlearn_tpu_torch.serve.router import Router
    from distlearn_tpu_torch.utils.checkpoint import save_checkpoint
    from distlearn_tpu_torch.utils.tree import tree_map
    params = _lm_params(sz)
    port = _reserve_window(2, host)
    ckpt_dir = tempfile.mkdtemp(prefix="chaos-swap-")
    servers = _spawn_replicas(host, port, 2, params, sz, ckpt_dir=ckpt_dir,
                              ckpt_poll=0.02, epoch=1, prefix_cache=True)
    total = rounds * 2
    swap_at = total // 3
    catalog = _prefixed_prompts(6, seed, sz)
    next_params = {}
    failures: list = []
    try:
        next_params = tree_map(lambda a: a * 0.5, params)
        with Router([(host, port), (host, port + 1)], health_ttl=0.02,
                    dial_deadline=1.0) as router:

            def _fault(i):
                if i == swap_at:
                    save_checkpoint(ckpt_dir, 1, next_params,
                                    metadata={"epoch": 2})

            results, hung = _fleet_load(
                router, [catalog[i % len(catalog)] for i in range(total)],
                6, stagger=0.02, on_index=_fault)
            deadline = time.monotonic() + CHAOS_RECOVER_S
            while time.monotonic() < deadline:
                if all(s.epoch == 2 for s in servers):
                    break
                time.sleep(0.02)
            else:
                failures.append(f"replicas never converged to epoch 2: "
                                f"{[s.epoch for s in servers]}")
            # post-swap wave REPEATS pre-swap catalog prompts: their
            # prefixes were cached under epoch-1 weights, so stale pages
            # surviving the fence would feed these prefills
            post, hung_post = _fleet_load(router, catalog[:4], 4)
    finally:
        _stop_replicas(servers)
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    totals = _totals(core.REGISTRY.snapshot())
    swaps = totals.get("serve_weight_swaps_total", 0)
    fences = totals.get("router_fence_violations_total", 0)
    hits = totals.get("serve_prefix_cache_hits_total", 0)
    done = [r for r in results
            if isinstance(r, dict) and r["reason"] == "complete"]
    epochs_seen = sorted({r["epoch"] for r in done})
    if hung or hung_post:
        failures.append("request thread(s) hung through the swap")
    if len(done) != total:
        bad = [r for r in results if r not in done]
        failures.append(f"{len(bad)} stream(s) did not complete cleanly "
                        f"through the swap: {bad[:3]!r}")
    if fences:
        failures.append(f"{fences} fence violation(s): a stream observed "
                        "two epochs")
    if swaps != 2:
        failures.append(f"weight swaps {swaps}, want exactly 1 per replica")
    if not set(epochs_seen) <= {1, 2}:
        failures.append(f"unknown epochs in streams: {epochs_seen}")
    if 1 not in epochs_seen:
        failures.append("no stream completed on the pre-swap epoch "
                        "(swap landed before traffic?)")
    if hits < 1:
        failures.append("the prefix cache never engaged — the "
                        "invalidation check proved nothing")
    bad_post = [r for r in post
                if not (isinstance(r, dict) and r["reason"] == "complete"
                        and r["epoch"] == 2)]
    if bad_post:
        failures.append(f"post-swap traffic not entirely on epoch 2: "
                        f"{bad_post[:3]!r}")
    stale = 0
    for i, r in enumerate(post):
        if not isinstance(r, dict) or r["reason"] != "complete":
            continue
        dev = next_params["embed"].device
        want = greedy_generate(
            next_params, torch.as_tensor(catalog[i][None], device=dev),
            4)[0].cpu().tolist()
        if r["tokens"] != want:
            stale += 1
            failures.append(
                f"STALE KV past the epoch fence: post-swap stream for "
                f"catalog[{i}] decoded {r['tokens']} on epoch-2 weights, "
                f"reference says {want}")
    return {"requests": total, "completed": len(done),
            "stream_epochs": epochs_seen, "swaps": swaps,
            "fence_violations": fences, "prefix_cache_hits": hits,
            "stale_kv_streams": stale}, failures


# ---------------------------------------------------------------------------
# Traffic scenarios (docs/OBSERVABILITY.md): realistic request mixes
# driving the observability plane — windowed SLOs and the obs-driven
# autoscaler — instead of injected faults.

def _throttle_ticks(srv, delay: float):
    """Make one replica's decode step cost ``delay`` seconds: queueing
    (and therefore TTFT under load) becomes a deterministic function of
    backlog instead of machine speed."""
    orig_tick = srv.engine.tick

    def _slow_tick(*a, **kw):
        time.sleep(delay)
        return orig_tick(*a, **kw)

    srv.engine.tick = _slow_tick


_TTFT_RULE = {"name": "ttft-p95", "kind": "quantile",
              "metric": "serve_ttft_seconds", "q": 0.95,
              "target": 0.05, "window_s": 3.0}


def _scenario_zipf_mix(rounds, seed, host, sz):
    """Zipf-popularity SHARED-PREFIX catalog over a 2-replica fleet
    with the radix prefix cache on: a few head prompts dominate, every
    prompt opens with a system prompt from a 3-entry pool, so repeats
    and siblings hit cached KV pages.  Greedy decode is a fleet-wide
    contract — every repeat of a catalog prompt must produce the
    IDENTICAL token stream whether its prefill came from compute or
    from cached pages, on whichever replica served it.  The cache must
    actually engage (hits counted, ``cached_tokens`` surfaced on the
    wire) and the steady-state TTFT p95 must hold — cache churn under
    page pressure may not degrade into re-prefill storms or stalls."""
    from distlearn_tpu_torch.serve.router import Router
    params = _lm_params(sz)
    port = _reserve_window(2, host)
    servers = _spawn_replicas(host, port, 2, params, sz, prefix_cache=True)
    catalog = _prefixed_prompts(10, seed, sz)
    weights = 1.0 / np.arange(1, 11) ** 1.5
    weights /= weights.sum()
    total = rounds * 3
    idx = np.random.default_rng(seed).choice(10, size=total, p=weights)
    try:
        # a tight health_ttl: with the cache on, requests drain fast
        # enough that a stale load snapshot would pin the whole wave to
        # the tie-winning list head
        # warm EVERY replica's compiled paths (prefill buckets,
        # cached-suffix chunks, the tick) so the asserted wave measures
        # steady state, not jit compiles — a fleet-wide router would
        # send the whole warmup to one fast replica
        for i in range(2):
            with Router([(host, port + i)], dial_deadline=1.0) as warm:
                _fleet_load(warm, catalog[:4], 4)
        with Router([(host, port + i) for i in range(2)],
                    health_ttl=0.005, dial_deadline=1.0) as router:
            snap0 = core.REGISTRY.snapshot()
            results, hung = _fleet_load(
                router, [catalog[int(k)] for k in idx], 4, stagger=0.003)
    finally:
        _stop_replicas(servers)
    snap = core.REGISTRY.snapshot()
    totals = _totals(snap)
    dispatched = _labeled(snap, "router_dispatch_total")
    done = [r for r in results
            if isinstance(r, dict) and r["reason"] == "complete"]
    failures = []
    if hung:
        failures.append(f"{hung} request thread(s) hung")
    if len(done) != total:
        bad = [r for r in results if r not in done]
        failures.append(f"only {len(done)}/{total} completed: {bad[:3]!r}")
    streams: dict[int, set] = {}
    for k, r in zip(idx, results):
        if isinstance(r, dict) and r["reason"] == "complete":
            streams.setdefault(int(k), set()).add(tuple(r["tokens"]))
    skewed = {k: len(v) for k, v in streams.items() if len(v) != 1}
    if skewed:
        failures.append("cached and uncached prefills disagreed on "
                        "repeated prompts (prompt -> distinct streams): "
                        f"{skewed}")
    if len(dispatched) < 2:
        failures.append("the mix never spread past one replica")
    counts = np.bincount(idx, minlength=10)
    if counts.max() < total / 4:
        failures.append(f"the zipf draw lost its head: {counts.tolist()}")
    completed_ctr = (
        sum(v for lbl, v in _labeled(snap, "serve_requests_total").items()
            if "complete" in str(lbl))
        - sum(v for lbl, v in _labeled(snap0, "serve_requests_total")
              .items() if "complete" in str(lbl)))
    if completed_ctr != len(done):
        failures.append(f"serve_requests_total{{complete}} = "
                        f"{completed_ctr} != {len(done)} completions")
    hits = totals.get("serve_prefix_cache_hits_total", 0)
    if hits < total // 8:
        failures.append(f"prefix cache never engaged: {hits} hits over "
                        f"{total} shared-prefix requests")
    if not any(r.get("cached_tokens") for r in done):
        failures.append("no stream reported cached_tokens despite the "
                        "shared-prefix catalog")
    # a generous absolute bound: the burst queues ~30 deep on 4 slots,
    # so p95 mostly measures queue wait (~1s here); the bound catches a
    # cache bug degenerating into admission stalls or retry storms
    # (deadlocks read as inf), not machine-speed jitter
    p95 = _hist_p95(_hist_sample(snap, "serve_ttft_seconds"),
                    _hist_sample(snap0, "serve_ttft_seconds"))
    if p95 is None or p95 > 5.0:
        failures.append(f"TTFT p95 did not hold under shared-prefix "
                        f"traffic: {p95}")
    return {"requests": total, "completed": len(done),
            "head_share": round(float(counts.max()) / total, 3),
            "distinct_prompts": int((counts > 0).sum()),
            "replicas_dispatched": len(dispatched),
            "prefix_cache_hits": hits,
            "cached_streams": sum(1 for r in done
                                  if r.get("cached_tokens")),
            "ttft_p95": p95}, failures


def _scenario_diurnal(rounds, seed, host, sz):
    """A one-day sine of wave sizes (trough 1 -> peak 8 -> trough 1)
    against a single throttled replica, with the full telemetry loop
    watching: export endpoint -> Collector -> windowed TTFT-p95 SLO.
    The peak waves must breach (queueing behind the throttled ticks is
    deterministic), and once the trough traffic leaves the window the
    rule must recover — both transitions counted."""
    from distlearn_tpu_torch.obs import agg as obs_agg
    from distlearn_tpu_torch.obs.export import start_http_server
    from distlearn_tpu_torch.serve.router import Router
    params = _lm_params(sz)
    port = _reserve_window(1, host)
    (srv,) = _spawn_replicas(host, port, 1, params, sz, num_slots=2)
    _throttle_ticks(srv, 0.02)
    exp = start_http_server(0, host)
    collector = obs_agg.Collector(endpoints=[(host, exp.port)])
    slo = obs_agg.SLOEngine([dict(_TTFT_RULE)])
    peak = 8
    curve = [1 + int(round((peak - 1) * 0.5 *
                           (1 - math.cos(2 * math.pi * p / rounds))))
             for p in range(rounds)]
    results: list = []
    hung_total = 0
    phase_ok: list[bool] = []
    failures: list = []
    try:
        with Router([(host, port)], health_ttl=0.05,
                    dial_deadline=1.0) as router:
            for p, lvl in enumerate(curve):
                out, hung = _fleet_load(
                    router, _serve_prompts(lvl, seed + p, sz), 4,
                    stagger=0.005)
                results.extend(out)
                hung_total += hung
                phase_ok.append(slo.evaluate(collector.poll())[0]["ok"])
            deadline = time.monotonic() + CHAOS_SETTLE_S
            while time.monotonic() < deadline:
                if slo.evaluate(collector.poll())[0]["ok"]:
                    break
                time.sleep(0.1)
            else:
                failures.append("the windowed TTFT SLO never recovered "
                                "after the trough")
    finally:
        exp.close()
        _stop_replicas([srv])
    total = sum(curve)
    totals = _totals(core.REGISTRY.snapshot())
    done = [r for r in results
            if isinstance(r, dict) and r["reason"] == "complete"]
    if hung_total:
        failures.append(f"{hung_total} request thread(s) hung")
    if len(done) != total:
        failures.append(f"only {len(done)}/{total} completed")
    if all(phase_ok[p] for p, lvl in enumerate(curve) if lvl == peak):
        failures.append(f"no peak wave (size {peak}) breached the SLO: "
                        f"curve={curve} ok={phase_ok}")
    if totals.get("slo_breaches_total", 0) < 1:
        failures.append("slo_breaches_total never fired")
    if totals.get("slo_recoveries_total", 0) < 1:
        failures.append("slo_recoveries_total never fired")
    fleet_ttft = collector.fleet.histogram("serve_ttft_seconds")
    if not fleet_ttft or fleet_ttft["count"] != total:
        failures.append(f"fleet TTFT histogram count "
                        f"{fleet_ttft and fleet_ttft['count']} != {total}")
    return {"requests": total, "completed": len(done), "curve": curve,
            "phases_breached": sum(1 for ok in phase_ok if not ok),
            "breaches": totals.get("slo_breaches_total", 0),
            "recoveries": totals.get("slo_recoveries_total", 0)}, failures


def _scenario_flash_crowd(rounds, seed, host, sz):
    """The autoscaler acceptance run: a 10x request burst against a
    one-replica fleet wired to the obs-driven autoscaler
    (``tools.autoscaler``).  The windowed TTFT breach must scale the
    fleet up mid-burst, the spawned replica must take real dispatches,
    every request must complete, and once the crowd passes the rule
    must recover and cooldown must retire the fleet back to one
    replica."""
    from distlearn_tpu_torch.obs import agg as obs_agg
    from distlearn_tpu_torch.obs.export import start_http_server
    from distlearn_tpu_torch.tools.autoscaler import Actuator, Autoscaler
    from distlearn_tpu_torch.serve.router import Router
    params = _lm_params(sz)
    port = _reserve_window(3, host)
    tick_s = 0.05
    (base_srv,) = _spawn_replicas(host, port, 1, params, sz, num_slots=2)
    _throttle_ticks(base_srv, tick_s)
    exp = start_http_server(0, host)
    collector = obs_agg.Collector(endpoints=[(host, exp.port)])
    rule = dict(_TTFT_RULE, target=0.1, window_s=2.5)
    slo = obs_agg.SLOEngine([rule])
    extra: list = []
    failures: list = []
    baseline = max(2, rounds // 5)
    burst = baseline * 10
    try:
        with Router([(host, port)], health_ttl=0.02,
                    dial_deadline=1.0) as router:

            def _spawn():
                p = port + 1 + len(extra)
                (srv,) = _spawn_replicas(host, p, 1, params, sz, num_slots=2)
                _throttle_ticks(srv, tick_s)
                extra.append(srv)
                return (srv, router.add_replica(host, p))

            def _retire(handle):
                srv, name = handle
                router.remove_replica(name)
                srv.stop()

            # warm the decode path first: the first-admit jit compile
            # counts as a TTFT sample, and a compile-second sample must
            # leave the window before the scaler is armed or it would
            # scale on warmup, not on the crowd
            _fleet_load(router, _serve_prompts(2, seed + 7, sz), 4)
            deadline = time.monotonic() + CHAOS_SETTLE_S
            while time.monotonic() < deadline:
                if slo.evaluate(collector.poll())[0]["ok"]:
                    break
                time.sleep(0.1)
            else:
                failures.append("warmup TTFT never left the SLO window")
            snap0 = _totals(core.REGISTRY.snapshot())

            scaler = Autoscaler(
                collector, slo,
                Actuator(spawn=_spawn, retire=_retire, min_size=1,
                         max_size=3, initial=1),
                scale_on={rule["name"]}, cooldown_s=1.0)

            # baseline: light load, the scaler must hold at one replica
            pre, hung_pre = _fleet_load(
                router, _serve_prompts(baseline, seed, sz), 4, stagger=0.05)
            report = scaler.step()
            if report["action"] != "hold" or report["size"] != 1:
                failures.append(f"baseline load moved the scaler: "
                                f"{report['action']} -> {report['size']}")

            # flash crowd: 10x the baseline wave.  Two constraints pick
            # the shape: arrivals must exceed the one-replica drain rate
            # (2 slots per tick_s => ~2/(9*tick_s) req/s at 8 tokens
            # each) so the queue really builds and TTFT really breaches,
            # AND the submit window must outlive the scaler's reaction
            # (~poll interval + one breach-visible TTFT sample) so the
            # spawned replica still has arrivals left to dispatch —
            # requests route at submit time, not from a shared queue
            box: dict = {}

            def _crowd():
                box["out"] = _fleet_load(
                    router, _serve_prompts(burst, seed + 1, sz), 8,
                    stagger=0.15)

            crowd = threading.Thread(target=_crowd, daemon=True)
            crowd.start()
            peak_size = 1
            while crowd.is_alive():
                peak_size = max(peak_size, scaler.step()["size"])
                time.sleep(0.1)
            crowd.join(CHAOS_RECOVER_S)
            results, hung = box.get("out", ([], burst))

            # aftermath: keep the loop running until the SLO recovers
            # and cooldown retires the fleet back to baseline
            deadline = time.monotonic() + CHAOS_SETTLE_S
            while time.monotonic() < deadline:
                report = scaler.step()
                if report["size"] == 1 and report["events"][0]["ok"]:
                    break
                time.sleep(0.1)
            else:
                failures.append(
                    f"fleet never cooled back down: size "
                    f"{report['size']}, ok {report['events'][0]['ok']}")
            left = router.replica_names()
    finally:
        exp.close()
        _stop_replicas([base_srv] + extra)
    snap = core.REGISTRY.snapshot()
    totals = _totals(snap)
    scale_events = _labeled(snap, "autoscaler_scale_events_total")
    ups = sum(v for lbl, v in scale_events.items() if "up" in str(lbl))
    downs = sum(v for lbl, v in scale_events.items()
                if "down" in str(lbl))
    dispatched = _labeled(snap, "router_dispatch_total")
    done = [r for r in results
            if isinstance(r, dict) and r["reason"] == "complete"]
    pre_done = [r for r in pre
                if isinstance(r, dict) and r["reason"] == "complete"]
    if hung_pre or hung:
        failures.append(f"{hung_pre + hung} request thread(s) hung")
    if len(pre_done) != baseline or len(done) != burst:
        failures.append(f"completions {len(pre_done)}+{len(done)} != "
                        f"{baseline}+{burst}")
    if peak_size < 2 or ups < 1:
        failures.append(f"the crowd never scaled the fleet up "
                        f"(peak {peak_size}, ups {ups})")
    if downs < 1:
        failures.append("cooldown never retired a replica")
    if len(left) != 1:
        failures.append(f"{len(left)} replicas left in the router, "
                        "want the baseline 1")
    if len(dispatched) < 2:
        failures.append("no dispatch ever landed on a spawned replica")
    breaches = totals.get("slo_breaches_total", 0) \
        - snap0.get("slo_breaches_total", 0)
    recoveries = totals.get("slo_recoveries_total", 0) \
        - snap0.get("slo_recoveries_total", 0)
    if breaches < 1:
        failures.append("the flash crowd never breached the SLO")
    if recoveries < 1:
        failures.append("the SLO never recovered after the crowd")
    return {"baseline": baseline, "burst": burst,
            "completed": len(pre_done) + len(done),
            "peak_size": peak_size, "scale_ups": ups,
            "scale_downs": downs, "breaches": breaches,
            "recoveries": recoveries,
            "replicas_dispatched": len(dispatched)}, failures


_SCENARIOS = {
    "flash_join": _scenario_flash_join,
    "rolling_leave": _scenario_rolling_leave,
    "slow_node": _scenario_slow_node,
    "partition_heal": _scenario_partition_heal,
    "replica_kill": _scenario_replica_kill,
    "slow_replica": _scenario_slow_replica,
    "overload_shed": _scenario_overload_shed,
    "swap_during_traffic": _scenario_swap_during_traffic,
    "zipf_mix": _scenario_zipf_mix,
    "diurnal": _scenario_diurnal,
    "flash_crowd": _scenario_flash_crowd,
}


def run_scenario(name: str, rounds: int = 12, seed: int = 0,
                 host: str = "127.0.0.1", *, device=None,
                 trail: str | None = None, **sizes) -> dict:
    """Run one named chaos scenario (elastic membership or serving
    fleet — see module docstring) and assert its invariants + zero
    fd/thread leaks.  Deterministically seeded: every injected fault
    decision flows from ``seed`` (FaultPlan per-link RNG streams, the
    request mix of the serve scenarios).  ``device``: every role's;
    ``trail``: as :func:`run_parity`'s; ``sizes``: the fields of :class:`Sizes` (``shapes``, ``lm``,
    ``params``, ``prompt_lens``, ``prefix_len``, ``prefill_chunk``)."""
    if name not in _SCENARIOS:
        raise ValueError(f"unknown scenario {name!r} "
                         f"(have: {', '.join(sorted(_SCENARIOS))})")
    if rounds < 8:
        raise ValueError("scenarios need rounds >= 8 (join/leave/fault "
                         "rounds must stay distinct)")
    sz = Sizes(device=resolve_device(device), **sizes)
    core.configure(True)
    core.REGISTRY.reset()
    _open_trail(trail)
    fd_base, th_base = _fd_count(), threading.active_count()
    try:
        fields, failures = _SCENARIOS[name](rounds, seed, host, sz)
        fd_end, th_end = _settle_leaks(fd_base, th_base)
        if fd_end > fd_base + 2:
            failures.append(f"fd leak: {fd_base} -> {fd_end}")
        if th_end > th_base:
            failures.append(f"thread leak: {th_base} -> {th_end}")
        report = {"scenario": name, "rounds": rounds, "seed": seed,
                  **fields, "fds": [fd_base, fd_end],
                  "threads": [th_base, th_end], "failures": failures}
        if failures:
            raise AssertionError(f"chaos scenario {name} failed: "
                                 + "; ".join(failures)
                                 + f"\n{json.dumps(report, indent=2)}")
        return report
    finally:
        _close_trail(trail)
        core.REGISTRY.reset()
        core.configure(None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="chaos", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("parity", help="kill/promote bitwise-parity soak")
    pp.add_argument("--rounds", type=int, default=16)
    pp.add_argument("--kills", default="6",
                    help="comma-separated kill rounds (1..rounds-1)")
    pp.add_argument("--shards", type=int, default=4)
    pp.add_argument("--no-overlap", action="store_true")
    pp.add_argument("--mid-flight", action="store_true",
                    help="kill while the round's delta is on the wire")
    pp.add_argument("--ckpt-every", type=int, default=1)
    pp.add_argument("--device", default=None,
                    help="the roles' device (default: the card)")
    pp.add_argument("--trail", default=None,
                    help="JSONL path for the run's spans and snapshot")
    cp = sub.add_parser("churn", help="multi-client liveness soak")
    cp.add_argument("--rounds", type=int, default=12)
    cp.add_argument("--clients", type=int, default=3)
    cp.add_argument("--shards", type=int, default=4)
    cp.add_argument("--server-kills", type=int, default=2)
    cp.add_argument("--no-overlap", action="store_true")
    cp.add_argument("--device", default=None,
                    help="the roles' device (default: the card)")
    cp.add_argument("--trail", default=None,
                    help="JSONL path for the run's spans and snapshot")
    sp = sub.add_parser("scenario",
                        help="elastic membership / serving fleet chaos "
                             "scenarios")
    sp.add_argument("--name", required=True,
                    choices=sorted(_SCENARIOS))
    sp.add_argument("--rounds", type=int, default=12)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default=None,
                    help="the roles' device (default: the card)")
    sp.add_argument("--trail", default=None,
                    help="JSONL path for the run's spans and snapshot")
    args = ap.parse_args(argv)
    if args.cmd == "scenario":
        report = run_scenario(args.name, rounds=args.rounds,
                              seed=args.seed, device=args.device,
                              trail=args.trail)
    elif args.cmd == "parity":
        kills = [int(k) for k in str(args.kills).split(",") if k.strip()]
        report = run_parity(rounds=args.rounds, kills=kills,
                            shards=args.shards,
                            overlap=not args.no_overlap,
                            ckpt_every=args.ckpt_every,
                            mid_flight=args.mid_flight, device=args.device,
                            trail=args.trail)
    else:
        report = run_churn(rounds=args.rounds, num_clients=args.clients,
                           shards=args.shards,
                           overlap=not args.no_overlap,
                           server_kills=args.server_kills,
                           device=args.device, trail=args.trail)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
