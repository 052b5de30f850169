"""Host-communication protocol checker (rules DL101-DL104) — counterpart of
``distlearn_tpu/lint/protocol.py`` over the port's sources: the tree
schedule comes from the port's ``comm/tree.py`` topology, and the lock
audit reads the port's ``comm/{transport,tree,ring}.py`` and
``parallel/async_ea.py``.

Two independent analyses:

**Schedule simulation** — the blocking send/recv sequence each rank
executes in ``comm/tree.py`` / ``comm/ring.py`` / the AsyncEA handshake is
written down as a list of :class:`Op` per rank (the schedule builders here
derive topology from the same helpers the implementations use, so they
track the real code).  :func:`check_schedules` then executes all ranks
against each other: an op fires when its counterpart is ready, and when no
rank can make progress the wait-for graph is extracted and reported —
a cycle is DL101 (static deadlock), a rank waiting on a terminated peer is
starvation (also DL101).  ``buffered_sends`` selects the transport model:
``True`` matches the repo's transports (OS socket buffers + the ring's
``_Sender`` thread make sends asynchronous), ``False`` models rendezvous
sends — under which the ring schedule deadlocks, which is exactly why
``ring.py`` owns a sender thread.  Tag mismatches on delivery are DL104:
the peers disagree on message *order*, which on the wire shows up as a
header parsed as payload.

**Lock audit** — an AST walk over the threaded modules
(``comm/transport.py``, ``parallel/async_ea.py``).  Nested ``with
<lock>:`` statements contribute edges to a lock-order graph; a cycle
across the whole audited set is DL102.  A blocking network call
(``recv_msg``/``send_tensor``/``accept``/...) issued while holding a lock
is DL103 — it extends lock hold times by a network round-trip and, when
the peer needs the same lock to answer, deadlocks.
"""

from __future__ import annotations

import ast
import inspect
from collections import deque
from dataclasses import dataclass
from typing import Iterable, Mapping, Sequence

from distlearn_tpu_torch.lint.core import Finding

__all__ = [
    "Op", "send", "recv", "recv_any",
    "tree_allreduce_schedule", "ring_allreduce_schedule",
    "async_ea_sync_schedule", "async_ea_sharded_schedule",
    "async_ea_rejoin_sharded_schedule", "async_ea_failover_schedule",
    "async_ea_promote_rejoin_schedule", "async_ea_stale_epoch_schedule",
    "async_ea_join_schedule", "async_ea_leave_schedule",
    "check_schedules", "lock_order_audit",
]


@dataclass(frozen=True)
class Op:
    """One blocking endpoint operation in a rank's schedule."""

    kind: str           # 'send' | 'recv' | 'recv_any'
    peer: object = None  # rank id; None for recv_any
    tag: str = ""       # message label, checked on delivery (DL104)
    #: op is armed with an IO timeout whose expiry ABORTS the rank's
    #: remaining schedule (the AsyncEA server's handshake_timeout -> evict
    #: path).  The simulator only reports DL101 for ranks stuck on ops
    #: that cannot time out.
    timeout: bool = False


def send(peer, tag="", timeout=False):
    return Op("send", peer, tag, timeout)


def recv(peer, tag="", timeout=False):
    return Op("recv", peer, tag, timeout)


def recv_any(tag="", timeout=False):
    return Op("recv_any", None, tag, timeout)


# ---------------------------------------------------------------------------
# Schedule builders for the repo's protocols.

def tree_allreduce_schedule(num_nodes: int, base: int = 2) -> dict:
    """Per-rank op sequence of ``Tree.all_reduce_ex`` (up fold, parent
    exchange, down fan-out) on the same topology ``comm.tree`` builds."""
    from distlearn_tpu_torch.comm.tree import _children, _parent
    sched = {}
    for r in range(num_nodes):
        ops = []
        for kid in _children(r, base, num_nodes):
            ops.append(recv(kid, "up"))
        if r != 0:
            p = _parent(r, base)
            ops.append(send(p, "up"))
            ops.append(recv(p, "down"))
        for kid in _children(r, base, num_nodes):
            ops.append(send(kid, "down"))
        sched[r] = ops
    return sched


def ring_allreduce_schedule(num_nodes: int) -> dict:
    """Per-rank op sequence of ``Ring._ring_allreduce_flat``: N-1
    reduce-scatter steps then N-1 allgather steps, send-to-successor
    before recv-from-predecessor each step (full duplex on the wire)."""
    n = num_nodes
    sched = {}
    for r in range(n):
        succ, pred = (r + 1) % n, (r - 1) % n
        ops = []
        for phase in ("rs", "ag"):
            for s in range(n - 1):
                ops.append(send(succ, f"{phase}{s}"))
                ops.append(recv(pred, f"{phase}{s}"))
        sched[r] = ops
    return sched


def async_ea_sync_schedule(num_leaves: int = 2, *, client_order=None,
                           packed: bool = False) -> dict:
    """One AsyncEA sync round between the serial server ``S`` and one
    client ``C`` (``AsyncEAServer.sync_server`` / ``AsyncEAClient.sync``).

    ``client_order`` overrides the client's question order — the linter's
    known-bad configuration swaps ``Center?``/``delta?`` to demonstrate the
    DL104 desync such an edit would introduce.

    ``packed=True`` models the negotiated coalesced wire (frame kind
    ``'P'``, comm/wire.py): the per-leaf ``center``/``delta_t`` legs
    collapse into ONE ``center_p`` / ``delta_p`` frame each way, so the
    simulator keeps covering both framings of the handshake.
    """
    L = num_leaves
    if packed:
        # Enter carries the wire ack; each tensor stream is one 'P' frame.
        server = [recv_any("Enter?"), send("C", "Enter"),
                  recv("C", "Center?"), send("C", "center_p"),
                  recv("C", "delta?"), send("C", "delta"),
                  recv("C", "delta_p")]
        order = client_order or ("Center?", "delta?")
        client = [send("S", "Enter?"), recv("S", "Enter"),
                  send("S", order[0]), recv("S", "center_p"),
                  send("S", order[1]), recv("S", "delta"),
                  send("S", "delta_p")]
        return {"S": server, "C": client}
    server = ([recv_any("Enter?"), send("C", "Enter"), recv("C", "Center?")]
              + [send("C", "center")] * L
              + [recv("C", "delta?"), send("C", "delta")]
              + [recv("C", "delta_t")] * L)
    order = client_order or ("Center?", "delta?")
    client = [send("S", "Enter?"), recv("S", "Enter"), send("S", order[0])]
    client += [recv("S", "center")] * L
    client += [send("S", order[1]), recv("S", "delta")]
    client += [send("S", "delta_t")] * L
    return {"S": server, "C": client}


def _stripe_leg_server(c: str, to: bool) -> list:
    """Server half of one stripe leg (``_serve_stripe_leg``): center slice
    down, delta slice up, every recv armed with handshake_timeout."""
    return [recv(c, "Center?", timeout=to), send(c, "center_p"),
            recv(c, "delta?", timeout=to), send(c, "delta"),
            recv(c, "delta_p", timeout=to)]


def _stripe_leg_client(s: str) -> list:
    """Client half of one stripe leg (strict: a client has no timeouts)."""
    return [send(s, "Center?"), recv(s, "center_p"),
            send(s, "delta?"), recv(s, "delta"), send(s, "delta_p")]


def async_ea_sharded_schedule(num_shards: int = 4, *,
                              server_timeouts: bool = False,
                              truncate_tail: int = 0) -> dict:
    """One SHARDED AsyncEA sync round (``AsyncEAServer._serve_striped`` /
    the striped ``AsyncEAClient.sync_client``).

    Ranks ``S0..S{n-1}`` are the server's per-stripe serving legs (S0 the
    dedicated-channel worker, Ss the shard-endpoint workers); ``C0..``
    are the client's fanned-out stripe legs.  Admission rides leg 0 only;
    the synthetic ``go`` messages model the client's thread fan-out (no
    shard leg speaks before leg 0's Enter reply lands), and each shard
    leg opens with its ``Shard?`` hello exactly like a first dial.

    ``server_timeouts=True`` arms every server recv with the
    handshake-timeout abort (the eviction path); ``truncate_tail`` drops
    that many trailing ops from EVERY client leg (a client dying
    mid-stripe).  Together they assert the eviction schedule drains —
    and without the timeouts, that the truncation would be a real DL101.
    """
    n = max(2, int(num_shards))
    to = bool(server_timeouts)
    sched: dict = {"S0": [recv_any("Enter?", timeout=to), send("C0", "Enter")]
                   + _stripe_leg_server("C0", to)}
    for s in range(1, n):
        sched[f"S{s}"] = ([recv(f"C{s}", "Shard?", timeout=to)]
                          + _stripe_leg_server(f"C{s}", to))
    sched["C0"] = ([send("S0", "Enter?"), recv("S0", "Enter")]
                   + [send(f"C{s}", "go") for s in range(1, n)]
                   + _stripe_leg_client("S0"))
    for s in range(1, n):
        sched[f"C{s}"] = ([recv("C0", "go"), send(f"S{s}", "Shard?")]
                          + _stripe_leg_client(f"S{s}"))
    if truncate_tail:
        for r in list(sched):
            if r.startswith("C"):
                sched[r] = sched[r][:-truncate_tail]
    return sched


def async_ea_rejoin_sharded_schedule(num_shards: int = 4) -> dict:
    """An evicted sharded client's readmission (``_readmit`` streams the
    FULL center on the fresh dedicated channel) followed by its first
    striped sync: the Rejoin reply re-advertises the stripe plan, the
    client re-dials every shard endpoint (fresh ``Shard?`` hellos — the
    server dropped its old shard conns at eviction), so every stripe is
    resynced by construction."""
    n = max(2, int(num_shards))
    sched = {"S0": [recv_any("Rejoin?"), send("C0", "Rejoin"),
                    send("C0", "center"), recv("C0", "ack"),
                    recv_any("Enter?"), send("C0", "Enter")]
             + _stripe_leg_server("C0", False)}
    for s in range(1, n):
        sched[f"S{s}"] = ([recv(f"C{s}", "Shard?")]
                          + _stripe_leg_server(f"C{s}", False))
    # _announce parses the reply (re-dialing the shard channels) BEFORE
    # rejoin() receives the center — hence go-then-center on leg 0
    sched["C0"] = ([send("S0", "Rejoin?"), recv("S0", "Rejoin")]
                   + [send(f"C{s}", "go") for s in range(1, n)]
                   + [recv("S0", "center"), send("S0", "ack"),
                      send("S0", "Enter?"), recv("S0", "Enter")]
                   + _stripe_leg_client("S0"))
    for s in range(1, n):
        sched[f"C{s}"] = ([recv("C0", "go"), send(f"S{s}", "Shard?")]
                          + _stripe_leg_client(f"S{s}"))
    return sched


def _rejoin_replay_server(c: str, num_shards: int) -> list:
    """Server half of a Rejoin-with-replay handshake (``_readmit`` +
    ``_recv_replay``): reply, full center down, Ack up, then the pending
    delta's un-applied stripe payloads, acked."""
    return ([recv_any("Rejoin?"), send(c, "Rejoin"),
             send(c, "center"), recv(c, "ack"),
             recv(c, "Replay")]
            + [recv(c, "replay_p")] * num_shards
            + [send(c, "ack")])


def _rejoin_replay_client(s: str, num_shards: int) -> list:
    """Client half (``_rejoin_handshake`` + ``_replay_exchange``), minus
    the shard-fanout ``go`` ops the sharded callers splice in."""
    return ([send(s, "Rejoin?"), recv(s, "Rejoin"),
             recv(s, "center"), send(s, "ack"),
             send(s, "Replay")]
            + [send(s, "replay_p")] * num_shards
            + [recv(s, "ack")])


def async_ea_failover_schedule(num_shards: int = 4, *,
                               strict: bool = False) -> dict:
    """Center failover end to end: the primary ``P*`` dies mid-stripe-leg
    (its serving legs simply STOP — schedules truncated after the center
    slice goes down), the client's first-sync legs ``C*`` abandon the
    ruined sync, and the client then fails over to the promoted standby
    ``T*``: Rejoin with full-stripe replay of the pending delta, then its
    first clean striped sync (``AsyncEAClient.failover``).

    The ``C*`` recvs from the dead primary are timeout-armed: on the real
    wire a dead peer surfaces as ``PeerClosed``/ECONNRESET, which aborts
    the sync attempt exactly like the simulator's timeout abort.
    ``strict=True`` strips that error surfacing — the expected DL101
    starvation it produces is the PROOF the failover path needs transport
    errors to fire, not a crutch hiding a real deadlock."""
    n = max(2, int(num_shards))
    to = not strict
    # the dying primary: Enter handshake completes, every serving leg
    # pushes its center slice, then the process is gone — no delta recv
    sched: dict = {"P0": [recv_any("Enter?"), send("C0", "Enter")]
                   + _stripe_leg_server("C0", True)[:2]}
    for s in range(1, n):
        sched[f"P{s}"] = ([recv(f"C{s}", "Shard?", timeout=True)]
                          + _stripe_leg_server(f"C{s}", True)[:2])
    sched["C0"] = ([send("P0", "Enter?"), recv("P0", "Enter", timeout=to)]
                   + [send(f"C{s}", "go") for s in range(1, n)]
                   + [send("P0", "Center?"),
                      recv("P0", "center_p", timeout=to),
                      send("P0", "delta?"), recv("P0", "delta", timeout=to),
                      send("P0", "delta_p")])
    for s in range(1, n):
        sched[f"C{s}"] = [recv(f"C0", "go"), send(f"P{s}", "Shard?"),
                          send(f"P{s}", "Center?"),
                          recv(f"P{s}", "center_p", timeout=to),
                          send(f"P{s}", "delta?"),
                          recv(f"P{s}", "delta", timeout=to),
                          send(f"P{s}", "delta_p")]
    # the promoted standby: Rejoin + replay on the fresh dedicated
    # channel, then the client's next striped sync — fresh ranks because
    # failover re-dials everything (new conns, new fanned-out legs)
    sched["T0"] = (_rejoin_replay_server("F0", n)
                   + [recv_any("Enter?"), send("F0", "Enter")]
                   + _stripe_leg_server("F0", False))
    for s in range(1, n):
        sched[f"T{s}"] = ([recv(f"F{s}", "Shard?")]
                          + _stripe_leg_server(f"F{s}", False))
    # _announce parses the Rejoin reply (re-dialing the shard endpoints)
    # BEFORE the center streams — hence go-then-center on leg 0
    cf = _rejoin_replay_client("T0", n)
    sched["F0"] = (cf[:2]
                   + [send(f"F{s}", "go") for s in range(1, n)]
                   + cf[2:]
                   + [send("T0", "Enter?"), recv("T0", "Enter")]
                   + _stripe_leg_client("T0"))
    for s in range(1, n):
        sched[f"F{s}"] = ([recv("F0", "go"), send(f"T{s}", "Shard?")]
                          + _stripe_leg_client(f"T{s}"))
    return sched


def async_ea_promote_rejoin_schedule(num_clients: int = 3) -> dict:
    """The rejoin herd after a promotion: every client of the dead
    primary re-dials the promoted standby ``S`` at once, each running a
    Rejoin-with-replay handshake (unsharded: one pending payload).  The
    serial serve loop admits them one at a time; the schedule proves the
    herd drains STRICT — no timeout crutch, any ordering bug is a loud
    DL101/DL104."""
    k = max(1, int(num_clients))
    server: list = []
    for i in range(1, k + 1):
        server += _rejoin_replay_server(f"C{i}", 1)
    sched: dict = {"S": server}
    for i in range(1, k + 1):
        sched[f"C{i}"] = _rejoin_replay_client("S", 1)
    return sched


def async_ea_join_schedule() -> dict:
    """Elastic admission (``AsyncEAClient.join`` / ``_handle_join``): the
    joiner announces ``Join?`` on the broadcast channel, the server
    replies with the assigned cid + ephemeral dedicated port, streams the
    FULL center down the fresh dedicated channel, and the adoption ack
    coming back is the join fence — ``_register_member`` runs only after
    it lands.  Strict: the handshake must drain with no timeout crutch."""
    server = [recv_any("Join?"), send("C", "Join"),
              send("C", "center"), recv("C", "ack")]
    client = [send("S", "Join?"), recv("S", "Join"),
              recv("S", "center"), send("S", "ack")]
    return {"S": server, "C": client}


def async_ea_leave_schedule(num_stripes: int = 1) -> dict:
    """Graceful departure (``AsyncEAClient.leave`` / ``_handle_leave``):
    the leaver announces ``Leave?`` with its last pushed seq, the server
    waits the cid idle, reads the applied-seq ledger and replies with
    what it is still owed; the leaver replays the un-applied stripe
    payloads and the final ack releases it.  Strict — the flush must
    drain without the eviction timeout firing."""
    n = max(1, int(num_stripes))
    server = ([recv_any("Leave?"), send("C", "Leave"),
               recv("C", "Replay")]
              + [recv("C", "replay_p")] * n
              + [send("C", "ack")])
    client = ([send("S", "Leave?"), recv("S", "Leave"),
               send("S", "Replay")]
              + [send("S", "replay_p")] * n
              + [recv("S", "ack")])
    return {"S": server, "C": client}


def async_ea_stale_epoch_schedule() -> dict:
    """The zombie fence: a stale center ``Z`` (paused primary back from
    the dead) answers a client whose epoch is newer with the ``stale``
    refusal and stops; the client drops ``Z`` from its dial list and runs
    a clean Rejoin + packed sync against the promoted center ``S``
    (``_refuse_stale`` / ``StaleCenterError`` -> ``failover``).  Strict —
    the refusal leg must never leave either side mid-stream."""
    zombie = [recv_any("Enter?"), send("C", "stale")]
    promoted = [recv_any("Rejoin?"), send("C", "Rejoin"),
                send("C", "center"), recv("C", "ack"),
                recv_any("Enter?"), send("C", "Enter"),
                recv("C", "Center?"), send("C", "center_p"),
                recv("C", "delta?"), send("C", "delta"),
                recv("C", "delta_p")]
    client = [send("Z", "Enter?"), recv("Z", "stale"),
              send("S", "Rejoin?"), recv("S", "Rejoin"),
              recv("S", "center"), send("S", "ack"),
              send("S", "Enter?"), recv("S", "Enter"),
              send("S", "Center?"), recv("S", "center_p"),
              send("S", "delta?"), recv("S", "delta"),
              send("S", "delta_p")]
    return {"Z": zombie, "S": promoted, "C": client}


# ---------------------------------------------------------------------------
# The simulator.

def check_schedules(schedules: Mapping, *, buffered_sends: bool = True,
                    name: str = "protocol") -> list[Finding]:
    """Execute all ranks' schedules against each other; report DL101 on
    global no-progress (with the wait-for cycle) and DL104 on deliveries
    whose tag differs from what the receiver expects."""
    findings: list[Finding] = []
    pc = {r: 0 for r in schedules}
    chan: dict = {}  # (src, dst) -> deque of tags, buffered mode only

    def cur(r):
        ops = schedules[r]
        return ops[pc[r]] if pc[r] < len(ops) else None

    def deliver(r, op, tag, src):
        if op.tag and tag != op.tag:
            findings.append(Finding(
                "DL104",
                f"rank {r} expected {op.tag!r} from rank {src} but the "
                f"next message is {tag!r}; the peers disagree on message "
                "order and will misparse the stream",
                where=f"{name}/rank {r}"))
        pc[r] += 1

    while True:
        progress = True
        while progress:
            progress = False
            for r in list(schedules):
                op = cur(r)
                if op is None:
                    continue
                if op.kind == "send":
                    if buffered_sends:
                        chan.setdefault((r, op.peer), deque()).append(op.tag)
                        pc[r] += 1
                        progress = True
                    else:
                        peer_op = cur(op.peer)
                        if peer_op is not None and (
                                (peer_op.kind == "recv"
                                 and peer_op.peer == r)
                                or peer_op.kind == "recv_any"):
                            deliver(op.peer, peer_op, op.tag, r)
                            pc[r] += 1
                            progress = True
                elif op.kind == "recv":
                    q = chan.get((op.peer, r))
                    if q:
                        deliver(r, op, q.popleft(), op.peer)
                        progress = True
                elif op.kind == "recv_any":
                    for (src, dst), q in chan.items():
                        if dst == r and q:
                            deliver(r, op, q.popleft(), src)
                            progress = True
                            break

        stuck = {r: cur(r) for r in schedules if cur(r) is not None}
        timed = [r for r, op in stuck.items() if op.timeout]
        if not timed:
            break
        # IO-timeout model: a rank stuck on a timeout-armed op ABORTS its
        # remaining schedule (the AsyncEA server's handshake_timeout fires
        # and the client is evicted — that serving leg abandons the rest
        # of its ops) and the simulation continues; only ranks that can
        # NEVER unblock are a DL101.
        for r in timed:
            pc[r] = len(schedules[r])

    if stuck:
        findings.append(_deadlock_finding(stuck, pc, name))
    return findings


def _deadlock_finding(stuck, pc, name) -> Finding:
    waits = {r: op.peer for r, op in stuck.items()}  # None for recv_any
    cycle = _find_cycle(waits)
    if cycle:
        path = " -> ".join(str(r) for r in cycle + [cycle[0]])
        detail = f"wait-for cycle {path}"
    else:
        detail = ", ".join(
            f"rank {r} blocked at op {pc[r]} ({op.kind} "
            f"{'' if op.peer is None else op.peer} {op.tag!r})"
            for r, op in stuck.items())
    return Finding(
        "DL101",
        f"schedule cannot complete: {detail}; "
        f"{len(stuck)} rank(s) permanently blocked",
        where=name)


def _find_cycle(waits: Mapping):
    for start in waits:
        seen: dict = {}
        r = start
        while r in waits and waits[r] is not None:
            if r in seen:
                cyc = list(seen)[list(seen).index(r):]
                return cyc
            seen[r] = True
            r = waits[r]
    return None


# ---------------------------------------------------------------------------
# Lock audit (AST).

#: Calls that block on the network or another thread.  dict.get / queue
#: get_nowait style accessors are deliberately excluded.
_BLOCKING_CALLS = frozenset({
    "recv_msg", "recv_tensor", "send_msg", "send_tensor",
    "send_tensors", "recv_tensors", "send_packed",
    "accept", "recv_any", "select", "connect",
})


def _lock_name(expr, class_name):
    """A with-item that looks like a lock acquisition, else None."""
    if isinstance(expr, ast.Attribute) and "lock" in expr.attr.lower():
        return (class_name, expr.attr)
    if isinstance(expr, ast.Name) and "lock" in expr.id.lower():
        return (class_name, expr.id)
    return None


class _LockVisitor(ast.NodeVisitor):
    def __init__(self, filename):
        self.filename = filename
        self.class_name = ""
        self.stack: list = []           # locks currently held (lexically)
        self.edges: dict = {}           # (outer, inner) -> first location
        self.blocking: list = []        # (lock, call name, location)

    def visit_ClassDef(self, node):
        prev, self.class_name = self.class_name, node.name
        self.generic_visit(node)
        self.class_name = prev

    def visit_FunctionDef(self, node):
        # A nested def runs on its own thread/later; locks held lexically
        # outside it are not held at its call time.
        prev, self.stack = self.stack, []
        self.generic_visit(node)
        self.stack = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_With(self, node):
        acquired = []
        for item in node.items:
            lock = _lock_name(item.context_expr, self.class_name)
            if lock is not None:
                loc = f"{self.filename}:{node.lineno}"
                for held in self.stack:
                    self.edges.setdefault((held, lock), loc)
                self.stack.append(lock)
                acquired.append(lock)
        self.generic_visit(node)
        for _ in acquired:
            self.stack.pop()

    def visit_Call(self, node):
        if self.stack:
            fn = node.func
            cname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else "")
            if cname in _BLOCKING_CALLS:
                self.blocking.append(
                    (self.stack[-1], cname, f"{self.filename}:{node.lineno}"))
        self.generic_visit(node)


def lock_order_audit(targets: Iterable, *, name: str = "locks") -> list[Finding]:
    """DL102/DL103 audit over modules (or raw source strings).

    All targets contribute to ONE lock-order graph: a cycle that only
    exists across two modules (thread A in one file, thread B in another)
    is still a deadlock.
    """
    edges: dict = {}
    findings: list[Finding] = []
    for t in targets:
        if isinstance(t, str):
            src, fname = t, "<string>"
        else:
            src, fname = inspect.getsource(t), getattr(t, "__name__", "?")
        v = _LockVisitor(fname)
        v.visit(ast.parse(src))
        edges.update({k: loc for k, loc in v.edges.items() if k not in edges})
        for lock, call, loc in v.blocking:
            findings.append(Finding(
                "DL103",
                f"blocking call {call}() while holding lock "
                f"{'.'.join(filter(None, lock))}; a slow or deadlocked peer "
                "stalls every thread contending for this lock",
                where=loc))
    graph: dict = {}
    for (a, b) in edges:
        graph.setdefault(a, set()).add(b)
    cycle = _digraph_cycle(graph)
    if cycle:
        path = " -> ".join(".".join(filter(None, l)) for l in cycle)
        locs = sorted({edges[e] for e in zip(cycle, cycle[1:])
                       if e in edges})
        findings.append(Finding(
            "DL102",
            f"lock acquisition order forms a cycle: {path} "
            f"(acquisition sites: {', '.join(locs)}); two threads taking "
            "the locks in opposite order deadlock",
            where=name))
    return findings


def _digraph_cycle(graph: Mapping):
    """First cycle in a digraph as a node path [a, b, ..., a], else None."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    path: list = []

    def dfs(n):
        color[n] = GREY
        path.append(n)
        for m in graph.get(n, ()):
            if color.get(m, WHITE) == GREY:
                return path[path.index(m):] + [m]
            if color.get(m, WHITE) == WHITE:
                got = dfs(m)
                if got:
                    return got
        path.pop()
        color[n] = BLACK
        return None

    for n in list(graph):
        if color[n] == WHITE:
            got = dfs(n)
            if got:
                return got
    return None


# ---------------------------------------------------------------------------
# Repo-facing entry: lint every protocol the comm layer ships.

def lint_comm_protocols(*, num_nodes: int = 7) -> list[Finding]:
    """Check the real tree/ring/AsyncEA schedules (buffered transport, as
    deployed) and audit the threaded modules' lock usage."""
    findings = []
    findings += check_schedules(tree_allreduce_schedule(num_nodes),
                                name="tree.all_reduce")
    findings += check_schedules(ring_allreduce_schedule(num_nodes),
                                name="ring.all_reduce")
    findings += check_schedules(async_ea_sync_schedule(),
                                name="async_ea.sync")
    findings += check_schedules(async_ea_sync_schedule(packed=True),
                                name="async_ea.sync-packed")
    # sharded center: clean round and rejoin must drain STRICT (no
    # timeout crutch); the mid-stripe death drains only because every
    # server recv is handshake_timeout-armed -> evict
    findings += check_schedules(async_ea_sharded_schedule(4),
                                name="async_ea.sync-sharded")
    findings += check_schedules(async_ea_rejoin_sharded_schedule(4),
                                name="async_ea.rejoin-sharded")
    findings += check_schedules(
        async_ea_sharded_schedule(4, server_timeouts=True, truncate_tail=1),
        name="async_ea.evict-mid-stripe")
    # HA failover (docs/HA.md): primary dying mid-stripe-leg + standby
    # promotion + replay, the post-promotion rejoin herd, and the stale-
    # epoch refusal — the latter two strict by construction
    findings += check_schedules(async_ea_failover_schedule(4),
                                name="async_ea.failover-promote")
    findings += check_schedules(async_ea_promote_rejoin_schedule(3),
                                name="async_ea.promote-rejoin-herd")
    findings += check_schedules(async_ea_stale_epoch_schedule(),
                                name="async_ea.stale-epoch-refusal")
    # elastic membership: join admission and the graceful-leave flush,
    # both strict by construction
    findings += check_schedules(async_ea_join_schedule(),
                                name="async_ea.join")
    findings += check_schedules(async_ea_leave_schedule(2),
                                name="async_ea.leave-flush")
    from distlearn_tpu_torch.comm import ring, transport, tree
    from distlearn_tpu_torch.parallel import async_ea
    findings += lock_order_audit([transport, tree, ring, async_ea],
                                 name="comm-threads")
    return findings
