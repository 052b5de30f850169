"""Explicit-state protocol model checking (rules DL301-DL304) — a copy of
``distlearn_tpu/lint/model.py`` (pure Python: the models describe the
protocols, which the port speaks bit for bit with the JAX package).

``lint/protocol.py`` executes ONE hand-written interleaving per schedule.
This module is the other half: small nondeterministic
process models of the repo's distributed protocols, explored
EXHAUSTIVELY — breadth-first over every interleaving of process steps and
fault actions (rank crash, silent hang, peer FIN, dropped ack, duplicate
delivery via retry) — with safety invariants checked at every reachable
state, in the TLA+/SPIN tradition (Lamport, *Specifying Systems*).

A model is a :class:`ModelSpec`: a hashable initial state, an
``actions(state) -> [(label, next_state)]`` successor function, an
``invariant(state) -> [(rule, message)]`` safety check, and an
``is_terminal(state)`` predicate.  :func:`check_model` runs BFS from the
initial state; because BFS visits states in depth order, the first
violation found is a SHORTEST counterexample, and the parent-pointer map
turns it into a numbered action trace embedded in the finding message.
A reachable state with no enabled action that is not terminal is a
deadlock (DL301).

Shipped models (:func:`builtin_models`):

* ``sync``            — the unsharded AsyncEA handshake
  (``AsyncEAServer.sync_server`` / ``AsyncEAClient.sync_client``) under
  client hang/FIN faults; deadlock-free ONLY because every server recv is
  handshake_timeout-armed (``mutate_sync(server_timeouts=False)`` is the
  seeded DL301).
* ``sharded``         — the striped handshake (``_serve_striped`` legs +
  client fan-out) under the same fault model; proves eviction drains
  every serving leg.
* ``replay``          — rejoin with exactly-once replay
  (``_readmit``/``_recv_replay``): a dropped final ack forces the client
  to re-run the whole rejoin (at-least-once delivery), and only the
  applied-seq ledger keeps the duplicate from double-applying
  (``mutate_replay(ledger=False)`` is the seeded DL303).
* ``failover``        — HA failover with a zombie primary
  (``docs/HA.md``): pause, promote, resume, re-dial; the epoch fence is
  what stops the resumed stale primary from applying a delta
  (``mutate_failover(fence=False)`` is the seeded DL302).
* ``serve``           — the serve scheduler/engine resource accounting
  (``serve/scheduler.py``): admit/tick/finish/cancel/deadline-expire/
  disconnect in every order; every eviction path must return the slot
  AND its pages to the engine (``mutate_serve(finish_on_evict=False)``
  is the seeded DL304).
* ``membership``      — elastic join/leave/rebalance
  (``_handle_join``/``_handle_leave``/``_delta_weight``): a joiner is
  registered only AFTER it adopts the current center (the join fence —
  ``membership_model(join_fence=False)`` is the seeded DL302), a
  graceful leave waits out the leaver's in-flight apply before reading
  the ledger (``leave_flush=False`` races the leave replay against the
  worker and double-applies, the seeded DL303), and every membership
  change renormalizes the capacity weights so the fleet's total weight
  mass is conserved (``renorm=False`` is the seeded DL304).
* ``router``          — the serving-fleet router
  (``serve/router.py``): dispatch/retry/shed/hedge over dying,
  shedding, hot-swapping replicas — deadlock-free only because dead
  replicas' queued requests are resubmitted (``retry=False`` is the
  seeded DL301), no stream splices two center epochs
  (``fence=False`` is the seeded DL302), and execution stays
  at-most-once per replica (``single_dispatch=False`` is the seeded
  DL303).

State spaces are deliberately tiny (1 client, 2 stripes, 2 requests,
small budgets) so the exhaustive sweep stays well under a second of
tier-1 time; the explored state/transition counts are reported through
``LintResult.info`` so a model that silently stopped exploring is
visible in CI output.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Hashable, Iterable, Mapping, Sequence

from distlearn_tpu_torch.lint.core import Finding

__all__ = [
    "ModelSpec", "ModelReport", "check_model", "builtin_models",
    "sync_model", "sharded_model", "replay_model", "failover_model",
    "serve_model", "membership_model", "router_model",
    "backend_sync_model", "lint_models",
]

State = Hashable
Action = "tuple[str, State]"


@dataclass(frozen=True)
class ModelSpec:
    """One checkable protocol model (see module docstring)."""

    name: str
    init: State
    actions: Callable[[State], "list[tuple[str, State]]"]
    invariant: Callable[[State], "list[tuple[str, str]]"]
    is_terminal: Callable[[State], bool]


@dataclass
class ModelReport:
    """Exhaustive-exploration result for one model."""

    name: str
    states: int = 0
    transitions: int = 0
    findings: list[Finding] = field(default_factory=list)

    @property
    def info(self) -> dict:
        return {"states": self.states, "transitions": self.transitions}


def _trace(parents: Mapping, state: State) -> list[str]:
    """Reconstruct the action-label path init -> ``state``."""
    labels: list[str] = []
    while True:
        prev = parents[state]
        if prev is None:
            break
        state, label = prev
        labels.append(label)
    labels.reverse()
    return labels


def _format_trace(labels: Sequence[str]) -> str:
    if not labels:
        return "counterexample: the initial state"
    steps = "; ".join(f"{i}) {lab}" for i, lab in enumerate(labels, 1))
    return f"counterexample ({len(labels)} step(s)): {steps}"


def check_model(spec: ModelSpec, *, max_states: int = 200_000) -> ModelReport:
    """BFS over every reachable state of ``spec``.

    The invariant runs on every state; a state with no enabled action
    that is not terminal is a DL301 deadlock.  Only the FIRST (therefore
    shortest) counterexample per rule id is reported.  ``max_states``
    is a runaway backstop — exceeding it is itself a DL301-severity
    modeling error, never a silent truncation.
    """
    report = ModelReport(spec.name)
    seen: dict = {spec.init: None}      # state -> (parent_state, label)|None
    queue: deque = deque([spec.init])
    reported: set[str] = set()

    def fire(rule: str, message: str, state: State) -> None:
        if rule in reported:
            return
        reported.add(rule)
        report.findings.append(Finding(
            rule, f"{message}; {_format_trace(_trace(seen, state))}",
            where=f"model:{spec.name}"))

    while queue:
        state = queue.popleft()
        for rule, message in spec.invariant(state):
            fire(rule, message, state)
        acts = spec.actions(state)
        if not acts and not spec.is_terminal(state):
            fire("DL301",
                 "model reaches a non-terminal state with no enabled "
                 "action (deadlock)", state)
        for label, nxt in acts:
            report.transitions += 1
            if nxt not in seen:
                if len(seen) >= max_states:
                    fire("DL301",
                         f"state space exceeded the {max_states}-state "
                         "backstop; the model is unbounded (missing "
                         "budget?)", state)
                    report.states = len(seen)
                    return report
                seen[nxt] = (state, label)
                queue.append(nxt)
    report.states = len(seen)
    return report


# ---------------------------------------------------------------------------
# Generic script machinery: processes executing send/recv scripts over
# FIFO per-pair channels, with hang/FIN faults and timeout-armed evicts.
# Backs the ``sync`` and ``sharded`` models; the semantic models
# (replay/failover/serve) are hand-written below.

#: process-group statuses
_RUN, _HUNG, _FIN, _CLOSED = "run", "hung", "fin", "closed"


def _script_model(name: str, scripts: "dict[str, list]",
                  groups: "dict[str, str]", *,
                  crashable: Iterable[str] = (),
                  timeout_ranks: Iterable[str] = (),
                  fault_budget: int = 1) -> ModelSpec:
    """Build a ModelSpec from per-rank ``(kind, peer, tag)`` scripts.

    ``groups`` maps rank -> process (the crash unit: one client process
    owns all its fanned-out legs).  A ``crashable`` process may, once,
    either HANG (silent stop — partition/GC pause; only a timeout can
    unblock a peer reading from it) or FIN (clean close — a peer's recv
    errors immediately, send raises EPIPE).  Ranks in ``timeout_ranks``
    model handshake_timeout-armed recvs: while blocked they may abort.
    An abort is process-wide (``_evict`` closes every conn of the
    client) and marks the process CLOSED, which errors out its peers in
    turn — exactly the drain path the real eviction machinery takes.
    """
    ranks = sorted(scripts)
    procs = sorted(set(groups.values()))
    crashable = frozenset(crashable)
    timeout_ranks = frozenset(timeout_ranks)
    chan_keys = sorted({(r, op[1]) for r in ranks for op in scripts[r]
                        if op[0] == "send"})
    ci = {k: i for i, k in enumerate(chan_keys)}
    ri = {r: i for i, r in enumerate(ranks)}
    pi = {p: i for i, p in enumerate(procs)}

    init = (tuple(0 for _ in ranks),
            tuple(() for _ in chan_keys),
            tuple(_RUN for _ in procs),
            fault_budget)

    def _abort(pcs, status, proc):
        """Process-wide abort: every rank of ``proc`` jumps to script
        end, its conns close."""
        pcs = list(pcs)
        for r in ranks:
            if groups[r] == proc:
                pcs[ri[r]] = len(scripts[r])
        status = list(status)
        status[pi[proc]] = _CLOSED
        return tuple(pcs), tuple(status)

    def actions(state):
        pcs, chans, status, budget = state
        acts = []
        for r in ranks:
            g = groups[r]
            if status[pi[g]] != _RUN or pcs[ri[r]] >= len(scripts[r]):
                continue
            kind, peer, tag = scripts[r][pcs[ri[r]]]
            pg = groups[peer]
            if kind == "send":
                if status[pi[pg]] in (_FIN, _CLOSED):
                    npcs, nstat = _abort(pcs, status, g)
                    acts.append((f"{r}: send {tag!r} to dead {peer} fails "
                                 f"-> {g} aborts",
                                 (npcs, chans, nstat, budget)))
                else:
                    nch = list(chans)
                    nch[ci[(r, peer)]] = chans[ci[(r, peer)]] + (tag,)
                    npcs = list(pcs)
                    npcs[ri[r]] += 1
                    acts.append((f"{r}: send {tag!r} -> {peer}",
                                 (tuple(npcs), tuple(nch), status, budget)))
            else:  # recv
                key = (peer, r)
                q = chans[ci[key]] if key in ci else ()
                if q:
                    nch = list(chans)
                    nch[ci[key]] = q[1:]
                    npcs = list(pcs)
                    npcs[ri[r]] += 1
                    acts.append((f"{r}: recv {q[0]!r} <- {peer}",
                                 (tuple(npcs), tuple(nch), status, budget)))
                elif status[pi[pg]] in (_FIN, _CLOSED):
                    npcs, nstat = _abort(pcs, status, g)
                    acts.append((f"{r}: recv from closed {peer} errors "
                                 f"-> {g} aborts",
                                 (npcs, chans, nstat, budget)))
                elif r in timeout_ranks:
                    npcs, nstat = _abort(pcs, status, g)
                    acts.append((f"{r}: recv {tag!r} times out -> {g} "
                                 "evicts/aborts",
                                 (npcs, chans, nstat, budget)))
                # else: blocked on a live, silent peer — no action for
                # this rank; global no-progress is the DL301 check.
        if budget > 0:
            for p in procs:
                if p in crashable and status[pi[p]] == _RUN:
                    for fault, lab in ((_HUNG, "hangs (partition)"),
                                       (_FIN, "crashes (FIN)")):
                        nstat = list(status)
                        nstat[pi[p]] = fault
                        acts.append((f"fault: {p} {lab}",
                                     (pcs, chans, tuple(nstat), budget - 1)))
        return acts

    def is_terminal(state):
        pcs, _chans, status, _budget = state
        for r in ranks:
            if status[pi[groups[r]]] == _RUN and pcs[ri[r]] < len(scripts[r]):
                return False
        return True

    return ModelSpec(name, init, actions, lambda s: [], is_terminal)


def _snd(peer, tag):
    return ("send", peer, tag)


def _rcv(peer, tag):
    return ("recv", peer, tag)


def sync_model(*, server_timeouts: bool = True) -> ModelSpec:
    """Unsharded packed AsyncEA sync round, one server + one client,
    under client hang/FIN faults (see module docstring)."""
    scripts = {
        "S": [_rcv("C", "Enter?"), _snd("C", "Enter"),
              _rcv("C", "Center?"), _snd("C", "center_p"),
              _rcv("C", "delta?"), _snd("C", "delta"),
              _rcv("C", "delta_p")],
        "C": [_snd("S", "Enter?"), _rcv("S", "Enter"),
              _snd("S", "Center?"), _rcv("S", "center_p"),
              _snd("S", "delta?"), _rcv("S", "delta"),
              _snd("S", "delta_p")],
    }
    return _script_model(
        "sync", scripts, {"S": "server", "C": "client"},
        crashable=("client",),
        timeout_ranks=("S",) if server_timeouts else ())


def sharded_model(*, server_timeouts: bool = True) -> ModelSpec:
    """Striped sync round: dedicated leg S0/C0 plus one shard leg S1/C1
    (the smallest topology exhibiting the fan-out), client faults at any
    point of any leg."""
    scripts = {
        "S0": [_rcv("C0", "Enter?"), _snd("C0", "Enter"),
               _rcv("C0", "Center?"), _snd("C0", "center_p"),
               _rcv("C0", "delta?"), _snd("C0", "delta"),
               _rcv("C0", "delta_p")],
        "S1": [_rcv("C1", "Shard?"),
               _rcv("C1", "Center?"), _snd("C1", "center_p"),
               _rcv("C1", "delta?"), _snd("C1", "delta"),
               _rcv("C1", "delta_p")],
        "C0": [_snd("S0", "Enter?"), _rcv("S0", "Enter"),
               _snd("C1", "go"),
               _snd("S0", "Center?"), _rcv("S0", "center_p"),
               _snd("S0", "delta?"), _rcv("S0", "delta"),
               _snd("S0", "delta_p")],
        "C1": [_rcv("C0", "go"), _snd("S1", "Shard?"),
               _snd("S1", "Center?"), _rcv("S1", "center_p"),
               _snd("S1", "delta?"), _rcv("S1", "delta"),
               _snd("S1", "delta_p")],
    }
    groups = {"S0": "server", "S1": "server",
              "C0": "client", "C1": "client"}
    return _script_model(
        "sharded", scripts, groups, crashable=("client",),
        timeout_ranks=("S0", "S1") if server_timeouts else ())


def backend_sync_model(*, backend: str = "host",
                       host_timeouts: bool = True) -> ModelSpec:
    """One collective round of a :mod:`distlearn_tpu_torch.comm.backend`
    topology under process faults.

    ``backend="host"``: a base-2 TCP tree root with two kid processes —
    each kid sends its up-phase payload and blocks for the down-phase
    result; the root folds both kids then fans the result back (the
    Tree.all_reduce_ex schedule, one message per phase per link).

    ``backend="hybrid"``: two hosts, each a process with a device-stage
    rank (the in-mesh reduce-scatter/all-gather + D2H/H2D staging,
    modeled as in-process messages that cannot time out) and a host-leg
    rank running the one-TCP-leg-per-host reduction.

    ``host_timeouts`` models ``op_timeout``-armed TCP recvs; with it
    mutated off, a hung peer wedges the collective forever — DL301, the
    reference's documented failure mode (SURVEY.md §5)."""
    if backend == "host":
        scripts = {
            "R": [_rcv("K1", "up"), _rcv("K2", "up"),
                  _snd("K1", "down"), _snd("K2", "down")],
            "K1": [_snd("R", "up"), _rcv("R", "down")],
            "K2": [_snd("R", "up"), _rcv("R", "down")],
        }
        groups = {"R": "root", "K1": "kid1", "K2": "kid2"}
        return _script_model(
            f"backend_sync[{backend}]", scripts, groups,
            crashable=("kid2",),
            timeout_ranks=("R", "K1", "K2") if host_timeouts else ())
    if backend == "hybrid":
        scripts = {
            "D0": [_snd("H0", "shards"), _rcv("H0", "reduced")],
            "H0": [_rcv("D0", "shards"), _rcv("H1", "up"),
                   _snd("H1", "down"), _snd("D0", "reduced")],
            "D1": [_snd("H1", "shards"), _rcv("H1", "reduced")],
            "H1": [_rcv("D1", "shards"), _snd("H0", "up"),
                   _rcv("H0", "down"), _snd("D1", "reduced")],
        }
        groups = {"D0": "host0", "H0": "host0",
                  "D1": "host1", "H1": "host1"}
        return _script_model(
            f"backend_sync[{backend}]", scripts, groups,
            crashable=("host1",),
            timeout_ranks=("H0", "H1") if host_timeouts else ())
    raise ValueError(f"unknown backend {backend!r} (host or hybrid)")


# ---------------------------------------------------------------------------
# Exactly-once replay (DL303).

def replay_model(*, ledger: bool = True, stripes: int = 2) -> ModelSpec:
    """Rejoin-with-replay under a lossy final ack.

    The client holds one pending delta (seq 1) striped over ``stripes``
    stripes; the crash that forced the rejoin landed mid-apply, so
    stripe 0 is nondeterministically already in the server's ledger.
    The final ack may be dropped once — the client then re-runs the
    WHOLE rejoin (at-least-once delivery), and the applied-seq ledger
    (``_record_applied`` / the ``need`` computation in ``_readmit``) is
    the only thing preventing the retry from double-applying.
    ``ledger=False`` models dropping the ``_record_applied`` write.

    State: ``(phase, need, ledger[i], applied_count[i], ack_drops)``.
    Invariant DL303: no stripe's applied count ever exceeds 1.
    """
    n = stripes
    SEQ = 1

    # phase: "announce" | ("send", need-tuple) | "await_ack" | "done"
    init = ("announce", (0,) * n, (0,) * n, 1, False)
    # (phase, ledger, applied_counts, ack_drops_left, forked)
    # ``forked`` False until the initial nondeterministic choice of how
    # far the pre-crash apply got (stripe 0 applied or not).

    def actions(state):
        phase, led, cnt, drops, forked = state
        acts = []
        if not forked:
            # the crash that caused this rejoin: the interrupted apply
            # either never recorded stripe 0, or recorded it durably
            acts.append(("pre-crash apply recorded nothing",
                         ("announce", led, cnt, drops, True)))
            led2 = (SEQ,) + led[1:]
            cnt2 = (1,) + cnt[1:]
            acts.append(("pre-crash apply recorded stripe 0",
                         ("announce", led2, cnt2, drops, True)))
            return acts
        if phase == "announce":
            need = tuple(i for i in range(n) if led[i] < SEQ)
            if need:
                acts.append((f"server: Rejoin reply, need stripes "
                             f"{list(need)}",
                             (("send", need), led, cnt, drops, True)))
            else:
                acts.append(("server: Rejoin reply, ledger already has "
                             "seq 1 -> nothing to replay, ack",
                             ("done", led, cnt, drops, True)))
        elif isinstance(phase, tuple) and phase[0] == "send":
            need = phase[1]
            i = need[0]
            ncnt = cnt[:i] + (cnt[i] + 1,) + cnt[i + 1:]
            nled = (led[:i] + (SEQ,) + led[i + 1:]) if ledger else led
            rest = need[1:]
            nphase = ("send", rest) if rest else "await_ack"
            acts.append((f"client: replay stripe {i}; server applies"
                         + ("" if ledger
                            else " (ledger write DROPPED)"),
                         (nphase, nled, ncnt, drops, True)))
        elif phase == "await_ack":
            acts.append(("server: replay ack delivered",
                         ("done", led, cnt, drops, True)))
            if drops > 0:
                acts.append(("fault: replay ack dropped -> client "
                             "retries the whole rejoin",
                             ("announce", led, cnt, drops - 1, True)))
        return acts

    def invariant(state):
        _phase, _led, cnt, _drops, _forked = state
        out = []
        for i, c in enumerate(cnt):
            if c > 1:
                out.append((
                    "DL303",
                    f"stripe {i} of (client, seq {SEQ}) applied {c} times "
                    "— the replay retry was not deduplicated by the "
                    "applied-seq ledger"))
        return out

    return ModelSpec("replay", init, actions, invariant,
                     lambda s: s[0] == "done")


# ---------------------------------------------------------------------------
# HA failover epoch fence (DL302).

def failover_model(*, fence: bool = True) -> ModelSpec:
    """Zombie-primary failover (docs/HA.md).

    Primary P serves epoch 1; standby T promotes to epoch 2 once P goes
    dark.  P may be a ZOMBIE — paused (GC stall, partition), not dead —
    and resume serving later.  A client that has synced with the
    promoted center announces ``epoch=2`` on every dial; the fence
    (``_refuse_stale``/``StaleCenterError``) is what makes the resumed
    stale primary refuse instead of applying a delta the fleet has moved
    past.  ``fence=False`` models deleting that epoch comparison.

    State: ``(seen_epoch, p_status, t_promoted, p_fenced, stale_applied,
    pause_budget, attempts_left)``.  Invariant DL302: ``stale_applied``
    never becomes True.
    """
    P_EPOCH, T_EPOCH = 1, 2
    # p_status: "serving" | "zombie"
    init = (0, "serving", False, False, False, 1, 3)

    def actions(state):
        seen, p, t_prom, p_fenced, stale, pause, tries = state
        acts = []
        if tries > 0:
            if p == "serving" and not p_fenced:
                if seen > P_EPOCH:
                    if fence:
                        acts.append((
                            "client dials P (epoch 1) announcing epoch "
                            f"{seen}; P refuses stale, client drops P "
                            "from its dial list",
                            (seen, p, t_prom, True, stale, pause,
                             tries - 1)))
                    else:
                        acts.append((
                            "client dials P (epoch 1) announcing epoch "
                            f"{seen}; P has NO fence and applies the "
                            "delta", (seen, p, t_prom, p_fenced, True,
                                      pause, tries - 1)))
                else:
                    acts.append((
                        "client syncs with P; delta applied at epoch 1",
                        (P_EPOCH, p, t_prom, p_fenced, stale, pause,
                         tries - 1)))
            if t_prom:
                acts.append((
                    "client fails over to promoted T; delta applied at "
                    "epoch 2", (T_EPOCH, p, t_prom, p_fenced, stale,
                                pause, tries - 1)))
        if pause > 0 and p == "serving":
            acts.append(("fault: P pauses (zombie)",
                         (seen, "zombie", t_prom, p_fenced, stale,
                          pause - 1, tries)))
        if p == "zombie":
            acts.append(("P resumes from the pause, still epoch 1",
                         (seen, "serving", t_prom, p_fenced, stale,
                          pause, tries)))
            if not t_prom:
                acts.append(("standby T misses P's probe twice and "
                             "promotes to epoch 2",
                             (seen, p, True, p_fenced, stale, pause,
                              tries)))
        return acts

    def invariant(state):
        seen, _p, _t, _fenced, stale, _pause, _tries = state
        if stale:
            return [("DL302",
                     "a center whose epoch is behind the client's newest "
                     f"synced epoch ({seen}) applied a delta — the zombie "
                     "primary mutated state the fleet has moved past")]
        return []

    return ModelSpec("failover", init, actions, invariant,
                     lambda s: s[6] == 0)


# ---------------------------------------------------------------------------
# Serve slot/page accounting (DL304).

def serve_model(*, finish_on_evict: bool = True, slots: int = 2,
                pages: int = 4, need: int = 2,
                max_new: int = 2) -> ModelSpec:
    """Scheduler/engine resource conservation under every event order.

    Two requests flow through submit -> admit -> tick* -> finish, with
    the nondeterministic faults the serve loop must absorb: a deadline
    expiring while queued OR running, and a client disconnect
    (``cancel``) at any point.  The scheduler and the engine keep
    SEPARATE books — scheduler ``running: rid -> slot``, engine
    ``busy slots + free pages`` — and every path that removes a running
    request must call ``engine.finish(slot)`` exactly once.
    ``finish_on_evict=False`` models ``_expire``/``cancel`` forgetting
    that call (the classic slot/page leak).

    State: ``(reqs, queue, running, engine_busy, pages_free)`` where
    ``reqs[i]`` is a per-request status and ``running[i]`` the slot+
    emitted-count when decoding.  Invariant DL304: engine busy slots ==
    scheduler-owned slots, and free pages account for exactly the busy
    slots' pages.
    """
    NREQ = 2
    # per-request status: "new" | "queued" | ("run", slot, emitted)
    #                   | "done" | "evicted"
    # state: (reqs, fifo (queued request ids in order),
    #         engine busy (sorted tuple of (slot, pages)), pages_free)
    init = (("new",) * NREQ, (), (), pages)

    def _set(reqs, i, v):
        return reqs[:i] + (v,) + reqs[i + 1:]

    def actions(state):
        reqs, fifo, busy, free = state
        acts = []
        busy_slots = {s for s, _ in busy}
        for i in range(NREQ):
            st = reqs[i]
            if st == "new":
                acts.append((f"client submits r{i}",
                             (_set(reqs, i, "queued"), fifo + (i,), busy,
                              free)))
            elif st == "queued":
                # deadline expiry while queued: dropped from the queue,
                # engine never involved
                acts.append((f"r{i} deadline expires while queued",
                             (_set(reqs, i, "evicted"),
                              tuple(j for j in fifo if j != i), busy,
                              free)))
                # disconnect == cancel wherever it is
                acts.append((f"client of r{i} disconnects (queued)",
                             (_set(reqs, i, "evicted"),
                              tuple(j for j in fifo if j != i), busy,
                              free)))
            elif isinstance(st, tuple):  # running
                slot = st[1]
                for why in ("deadline expires", "client disconnects"):
                    nbusy = busy
                    nfree = free
                    if finish_on_evict:
                        nbusy = tuple(sorted((s, p) for s, p in busy
                                             if s != slot))
                        nfree = free + need
                    acts.append((
                        f"r{i} {why} while decoding -> evict"
                        + ("" if finish_on_evict
                           else " (engine.finish call MISSING)"),
                        (_set(reqs, i, "evicted"), fifo, nbusy, nfree)))
        # scheduler round pieces, each its own interleavable action:
        if fifo:
            head = fifo[0]
            if reqs[head] == "queued" and free >= need:
                slot = min(set(range(slots)) - busy_slots, default=None)
                if slot is not None:
                    acts.append((
                        f"scheduler admits r{head} into slot {slot}",
                        (_set(reqs, head, ("run", slot, 0)), fifo[1:],
                         tuple(sorted(busy + ((slot, need),))),
                         free - need)))
        running = [(i, reqs[i]) for i in range(NREQ)
                   if isinstance(reqs[i], tuple)]
        if running:
            nreqs, nbusy, nfree = reqs, busy, free
            finished = []
            for i, (_tag, slot, emitted) in running:
                if emitted + 1 >= max_new:
                    nreqs = _set(nreqs, i, "done")
                    nbusy = tuple(sorted((s, p) for s, p in nbusy
                                         if s != slot))
                    nfree += need
                    finished.append(i)
                else:
                    nreqs = _set(nreqs, i, ("run", slot, emitted + 1))
            lab = "engine ticks; every active slot emits one token"
            if finished:
                lab += ("; " + ", ".join(f"r{i}" for i in finished)
                        + " complete(s) -> engine.finish")
            acts.append((lab, (nreqs, fifo, nbusy, nfree)))
        return acts

    def invariant(state):
        reqs, _fifo, busy, free = state
        out = []
        owned = {st[1] for st in reqs if isinstance(st, tuple)}
        busy_slots = {s for s, _ in busy}
        orphans = busy_slots - owned
        if orphans:
            held = sum(p for s, p in busy if s in orphans)
            out.append((
                "DL304",
                f"engine slot(s) {sorted(orphans)} still hold {held} "
                "page(s) but no scheduler-tracked request owns them — "
                "an eviction path skipped engine.finish and the pages "
                "leak forever"))
        if owned - busy_slots:
            out.append((
                "DL304",
                f"scheduler tracks request(s) in slot(s) "
                f"{sorted(owned - busy_slots)} the engine considers "
                "free — double-finish or admission bookkeeping bug"))
        if free + sum(p for _s, p in busy) != pages:
            out.append((
                "DL304",
                f"page conservation broken: {free} free + "
                f"{sum(p for _s, p in busy)} held != {pages} total"))
        return out

    def is_terminal(state):
        reqs, _fifo, _busy, _free = state
        return all(st in ("done", "evicted") for st in reqs)

    return ModelSpec("serve", init, actions, invariant, is_terminal)


# ---------------------------------------------------------------------------
# Elastic membership: join fence (DL302), leave flush (DL303), weight
# renormalization (DL304).

def membership_model(*, join_fence: bool = True, leave_flush: bool = True,
                     renorm: bool = True) -> ModelSpec:
    """Elastic join/leave under every interleaving of a member's last
    in-flight delta, a joiner's handshake, and a graceful leave.

    Two participants: founding member M (weight 2 — the whole mass of a
    ``num_nodes=2`` normalization budget) and joiner J.  M may push one
    delta (seq 1) whose server-side apply is IN FLIGHT — the worker
    thread holds it — and may then leave gracefully; the delta may also
    be LOST to a connection cut before the apply lands, which is what
    makes the leave-replay path (``need=[1]``) real.  J joins, adopts
    the center, and pushes a delta of its own.

    The three guards under test, each with a seeded mutation:

    * ``join_fence``  — J is registered as a member (deltas accepted)
      only AFTER it acked adoption of the streamed center
      (``_handle_join`` calls ``_register_member`` after ``_expect(new,
      ACK)``).  ``join_fence=False`` registers J at the Join? receipt,
      so the server can apply a delta from a client that never adopted
      the center — DL302.  Note J's adopted center legitimately going
      stale later (M's delta lands after J adopted) is NOT a violation;
      that is ordinary EASGD staleness.
    * ``leave_flush`` — ``_handle_leave`` calls ``_wait_cid_idle``
      before reading the applied-seq ledger.  ``leave_flush=False``
      reads the ledger while M's apply is still in flight: the ledger
      says seq 1 never landed, the leave replay applies it, and the
      worker's apply lands too — the delta counts twice, DL303.  (The
      ledger is monotonic-max bookkeeping; workers do NOT consult it
      before applying, so the wait is the only guard.)
    * ``renorm``      — every membership change recomputes
      ``_delta_weight`` denominators so live capacity weights sum to
      the fixed budget.  ``renorm=False`` hands J its raw weight
      without renormalizing the fleet (sum 4 != 2) — DL304.

    State: ``(j_phase, j_member, j_base, j_pushed, m_phase, m_seq,
    m_inflight, m_led, m_cnt, center_v, w_m, w_j, stale)``.
    """
    BUDGET = 2  # total weight mass: num_nodes x capacity 1.0

    # j_phase: "out" | "joining" | "member";  j_base: center version J
    # adopted, -1 = never adopted.  m_phase: "idle" | "leaving" |
    # "flush" | "gone".
    init = ("out", False, -1, False, "idle", 0, False, 0, 0, 0,
            BUDGET, 0, False)

    def _renorm_weights(m_alive: bool, j_member: bool) -> "tuple[int, int]":
        live = int(m_alive) + int(j_member)
        share = BUDGET // live if live else 0
        return (share if m_alive else 0, share if j_member else 0)

    def actions(state):
        (jp, jm, jb, jpu, mp, mseq, minf, mled, mcnt, cv,
         wm, wj, stale) = state
        m_alive = mp != "gone"
        acts = []

        # --- joiner J -----------------------------------------------------
        if jp == "out":
            if join_fence:
                acts.append(("J dials Join?; server assigns cid, streams "
                             "center (registration deferred to ACK)",
                             ("joining", jm, jb, jpu, mp, mseq, minf, mled,
                              mcnt, cv, wm, wj, stale)))
            else:
                nwm, nwj = ((wm if m_alive else 0, BUDGET)
                            if not renorm else
                            _renorm_weights(m_alive, True))
                acts.append(("J dials Join?; server REGISTERS J before the "
                             "center adoption ACK (join fence dropped)",
                             ("joining", True, jb, jpu, mp, mseq, minf, mled,
                              mcnt, cv, nwm, nwj, stale)))
        elif jp == "joining":
            if join_fence:
                if renorm:
                    nwm, nwj = _renorm_weights(m_alive, True)
                else:
                    nwm, nwj = (wm if m_alive else 0), BUDGET
                lab = (f"J ACKs center adoption (version {cv}); server "
                       "registers J"
                       + ("" if renorm
                          else " at RAW weight (renormalization dropped)"))
                acts.append((lab,
                             ("member", True, cv, jpu, mp, mseq, minf, mled,
                              mcnt, cv, nwm, nwj, stale)))
            else:
                acts.append((f"J ACKs center adoption (version {cv})",
                             ("member", jm, cv, jpu, mp, mseq, minf, mled,
                              mcnt, cv, wm, wj, stale)))
        if jm and not jpu:
            nstale = stale or jb < 0
            lab = ("server worker applies J's delta"
                   + (" — J NEVER ADOPTED the center" if jb < 0 else
                      f" (J's base: center version {jb})"))
            acts.append((lab,
                         (jp, jm, jb, True, mp, mseq, minf, mled, mcnt,
                          cv + 1, wm, wj, nstale)))

        # --- member M -----------------------------------------------------
        if mp == "idle" and mseq == 0:
            acts.append(("M pushes delta seq 1; server worker now holds "
                         "it in flight",
                         (jp, jm, jb, jpu, mp, 1, True, mled, mcnt, cv,
                          wm, wj, stale)))
        if minf:
            acts.append(("server worker applies M's in-flight delta "
                         "seq 1; ledger records 1",
                         (jp, jm, jb, jpu, mp, mseq, False, 1, mcnt + 1,
                          cv + 1, wm, wj, stale)))
            acts.append(("fault: M's conn cut before the apply — the "
                         "in-flight delta is lost, ledger unchanged",
                         (jp, jm, jb, jpu, mp, mseq, False, mled, mcnt,
                          cv, wm, wj, stale)))
        if mp == "idle":
            acts.append(("M sends Leave? claiming seq "
                         f"{mseq}", (jp, jm, jb, jpu, "leaving", mseq, minf,
                                     mled, mcnt, cv, wm, wj, stale)))
        elif mp == "leaving":
            if not minf or not leave_flush:
                need = mled < mseq
                if need:
                    lab = ("server reads ledger (applied "
                           f"{mled} < claimed {mseq}) -> need=[1]"
                           + ("" if not minf else
                              " while M's apply is STILL IN FLIGHT "
                              "(leave flush dropped)"))
                    acts.append((lab,
                                 (jp, jm, jb, jpu, "flush", mseq, minf,
                                  mled, mcnt, cv, wm, wj, stale)))
                else:
                    nwm, nwj = _renorm_weights(False, jm)
                    acts.append(("server reads ledger (nothing owed), "
                                 "removes M, renormalizes survivors",
                                 (jp, jm, jb, jpu, "gone", mseq, minf,
                                  mled, mcnt, cv, nwm,
                                  nwj if jm else wj, stale)))
            # else: _wait_cid_idle blocks the leave until the worker or
            # the fault clears the in-flight apply (both enabled above).
        elif mp == "flush":
            nwm, nwj = _renorm_weights(False, jm)
            acts.append(("leave replay applies seq 1; server removes M, "
                         "renormalizes survivors",
                         (jp, jm, jb, jpu, "gone", mseq, minf, 1,
                          mcnt + 1, cv + 1, nwm,
                          nwj if jm else wj, stale)))
        return acts

    def invariant(state):
        (jp, jm, jb, jpu, mp, _mseq, _minf, _mled, mcnt, _cv,
         wm, wj, stale) = state
        out = []
        if stale:
            out.append((
                "DL302",
                "the server applied a delta from a joiner that never "
                "adopted the center — the join fence (register only "
                "after the adoption ACK) is missing"))
        if mcnt > 1:
            out.append((
                "DL303",
                f"M's delta seq 1 applied {mcnt} times — the graceful "
                "leave read the applied-seq ledger without waiting out "
                "the in-flight apply, so the leave replay and the "
                "worker both landed it"))
        live = ([wm] if mp != "gone" else []) + ([wj] if jm else [])
        if live and sum(live) != BUDGET:
            out.append((
                "DL304",
                f"live capacity weights sum to {sum(live)}, not the "
                f"fleet budget {BUDGET} — a membership change skipped "
                "the weight renormalization and the elastic average is "
                "biased"))
        return out

    def is_terminal(state):
        (jp, jm, _jb, jpu, mp, _mseq, minf, _mled, _mcnt, _cv,
         _wm, _wj, _stale) = state
        return mp == "gone" and jp == "member" and jpu and not minf

    return ModelSpec("membership", init, actions, invariant, is_terminal)


# ---------------------------------------------------------------------------
# The serving-fleet router (serve/router.py): dispatch, retry-on-death,
# shed, hedge, epoch fence — deadlock-free (DL301), never splicing two
# center epochs into one stream (DL302), at-most-once per replica
# (DL303).

def router_model(*, retry: bool = True, fence: bool = True,
                 single_dispatch: bool = True) -> ModelSpec:
    """Fleet router request lifecycle (``serve/router.py``): one request
    against two replicas A/B, each of which may die at any point, shed a
    dispatch (queue full), or hot-swap its center epoch mid-run
    (``serve.server._maybe_swap``).  The router moves exactly as
    ``Router.generate`` does: dispatch to an untried live replica,
    resubmit only requests that never produced a token, hedge off a slow
    replica by CANCELLING its queued copy first, surface a clean
    terminal when every replica was tried, and fence the stream on the
    'R'-chunk epoch echo.

    The three guards under test, each with a seeded mutation:

    * ``retry``           — a replica that dies holding a
      queued-not-yet-prefilled request triggers resubmission to a
      survivor.  ``retry=False`` leaves the request parked on the dead
      replica forever: once the environment's remaining actions
      exhaust, the state has no successor and is not terminal — DL301.
    * ``fence``           — the first chunk pins the stream's epoch and
      a later chunk with a different value terminates the stream
      (clean ``failed``).  ``fence=False`` delivers it: one completion
      spliced from two model versions — DL302.
    * ``single_dispatch`` — the tried-set plus hedge-cancel keep
      execution at-most-once per replica.  ``single_dispatch=False``
      hedges WITHOUT cancelling and forgets the replica was tried, so
      a later dispatch hands the same replica a second live copy —
      DL303.

    State: ``(phase, owner, first_ep, mixed, ((up, ep, copies, tried)
    per replica))``.
    """
    names = ("A", "B")
    init = ("new", -1, -1, False, ((True, 0, 0, False),
                                   (True, 0, 0, False)))

    def _set(reps, i, **kw):
        up, ep, cp, tr = reps[i]
        rep = (kw.get("up", up), kw.get("ep", ep),
               kw.get("copies", cp), kw.get("tried", tr))
        return tuple(rep if j == i else reps[j] for j in range(2))

    def actions(state):
        phase, owner, first_ep, mixed, reps = state
        if phase in ("done", "failed", "shed"):
            return []
        acts = []
        # environment: replica deaths and hot swaps, in every order
        for i in range(2):
            up, ep, _cp, _tr = reps[i]
            if up:
                acts.append((f"fault: replica {names[i]} dies",
                             (phase, owner, first_ep, mixed,
                              _set(reps, i, up=False))))
                if ep == 0:
                    acts.append((
                        f"replica {names[i]} hot-swaps to epoch 1",
                        (phase, owner, first_ep, mixed,
                         _set(reps, i, ep=1))))
        if phase == "new":
            cand = [i for i in range(2) if reps[i][0] and not reps[i][3]]
            for i in cand:
                acts.append((
                    f"router dispatches to {names[i]}; it ACCEPTS "
                    "(copy queued)",
                    # copies clamp at 2: one over the at-most-once bound
                    # witnesses the violation; an unbounded counter would
                    # make the mutated model's state space infinite
                    ("queued", i, first_ep, mixed,
                     _set(reps, i, copies=min(reps[i][2] + 1, 2),
                          tried=True))))
                acts.append((
                    f"router dispatches to {names[i]}; it SHEDS "
                    "(queue full, retry_after)",
                    ("new", -1, first_ep, mixed,
                     _set(reps, i, tried=True))))
            if not cand:
                acts.append((
                    "router surfaces RouterBusy/ReplicaDead: every "
                    "replica tried or dead",
                    ("shed", -1, first_ep, mixed, reps)))
        elif phase == "queued":
            up, ep, cp, _tr = reps[owner]
            if up:
                acts.append((
                    f"replica {names[owner]} prefills: first chunk pins "
                    f"stream epoch {ep}",
                    ("streaming", owner, ep, mixed, reps)))
                if single_dispatch:
                    if any(reps[j][0] and not reps[j][3]
                           for j in range(2) if j != owner):
                        acts.append((
                            "hedge: router cancels the queued copy on "
                            f"{names[owner]} (conn close) and resubmits",
                            ("new", -1, first_ep, mixed,
                             _set(reps, owner, copies=cp - 1))))
                else:
                    acts.append((
                        "hedge WITHOUT cancel: router forgets it tried "
                        f"{names[owner]}, old copy still queued there "
                        "(single-dispatch guard dropped)",
                        ("new", -1, first_ep, mixed,
                         _set(reps, owner, tried=False))))
            elif retry:
                acts.append((
                    f"router detects {names[owner]} died before the "
                    "first token: resubmits to a survivor",
                    ("new", -1, first_ep, mixed, reps)))
            # retry dropped: no router action — the request wedges on
            # the dead replica (the seeded DL301)
        elif phase == "streaming":
            up, ep, _cp, _tr = reps[owner]
            if up:
                if ep == first_ep:
                    acts.append((
                        f"replica {names[owner]} streams to completion "
                        "(epoch stable)",
                        ("done", owner, first_ep, mixed, reps)))
                elif fence:
                    acts.append((
                        f"chunk carries epoch {ep} != pinned {first_ep}:"
                        " router fences the stream (clean failed chunk)",
                        ("failed", owner, first_ep, mixed, reps)))
                else:
                    acts.append((
                        f"chunk carries epoch {ep} != pinned {first_ep} "
                        "and the router DELIVERS it (fence dropped)",
                        ("done", owner, first_ep, True, reps)))
            else:
                acts.append((
                    f"replica {names[owner]} died mid-stream: router "
                    "returns a clean terminal failed chunk (no resubmit"
                    " — tokens already flowed)",
                    ("failed", owner, first_ep, mixed, reps)))
        return acts

    def invariant(state):
        _phase, _owner, _first_ep, mixed, reps = state
        out = []
        if mixed:
            out.append((
                "DL302",
                "one stream delivered chunks from two center epochs — "
                "the router's fence over the 'R'-chunk epoch echo is "
                "missing and a completion spliced two model versions"))
        for i in range(2):
            if reps[i][2] > 1:
                out.append((
                    "DL303",
                    f"replica {names[i]} holds {reps[i][2]} live copies "
                    "of one request — a resubmission skipped the "
                    "tried-set/hedge-cancel guard, so execution is no "
                    "longer at-most-once per replica"))
        return out

    def is_terminal(state):
        return state[0] in ("done", "failed", "shed")

    return ModelSpec("router", init, actions, invariant, is_terminal)


# ---------------------------------------------------------------------------
# Repo-facing entries.

def builtin_models() -> list[ModelSpec]:
    """The shipped models in their faithful (unmutated) configuration."""
    return [sync_model(), sharded_model(), replay_model(),
            failover_model(), serve_model(), membership_model(),
            router_model(), backend_sync_model(backend="host"),
            backend_sync_model(backend="hybrid")]


def lint_models() -> "list[tuple[ModelReport, ModelSpec]]":
    """Check every builtin model; returns ``(report, spec)`` pairs."""
    return [(check_model(spec), spec) for spec in builtin_models()]
