"""Static lockset race detection (rules DL111/DL112) — counterpart of
``distlearn_tpu/lint/races.py`` over the port's threaded modules
(:func:`core_targets`, :func:`fleet_targets`).  The name lists below are
the JAX package's, whose classes and fields the port keeps, less the
:data:`BENIGN_FIELDS` entries that no access of the port's needs (its
serial server's applied-seq ledger, and the concurrent server's center,
which is one device slab swapped under its locks, and its worker map).

An Eraser-style analysis (Savage et al., SOSP '97) done statically: for
every ``self._field`` access in the audited classes, compute the set of
locks GUARANTEED held on every path from each thread entry point to the
access, then intersect locksets across entry points.  A field written
with an empty write-lockset intersection while another thread can touch
it is DL111 (error); a field whose writes all share a guard that some
cross-thread read skips is DL112 (warning — the torn-read hazard class).
This extends the DL102/DL103 lock-order audit in ``lint/protocol.py``
from *locks* to the *data* they protect.

How locksets are computed
-------------------------
The analysis is per class, purely on the AST (so it accepts raw source
strings — the seeded-mutation tests strip a ``with self._lock:`` from
the real ``async_ea.py`` source and feed the result back in):

* ``with self._lock:`` blocks (any name containing ``lock``, matching
  the DL102 auditor) push a lock lexically; ``with locks[i]:`` pushes
  the striped form ``locks[]``.  A ``try:`` whose ``finally`` calls
  ``X.release()`` is treated as holding ``X`` for its body (the
  ``acquire(blocking=False)`` idiom).
* Intra-class ``self.method()`` calls propagate the caller's held set
  into the callee (BFS over ``(method, lockset)`` states).
* Thread entry points are discovered from ``threading.Thread(target=
  self.m)`` call sites and from nested ``def``s that close over
  ``self`` (the ``_fanout`` leg pattern — a closure may run on another
  thread, and locks held lexically outside it are NOT held when it
  runs).  :data:`THREAD_API` adds the documented cross-thread public
  surface (health probes, signal-handler checkpoints, ``stop``).
* Writes in ``__init__`` and the per-class :data:`SETUP_METHODS`
  (``init_server``/``start``/... — code that runs before the threads
  exist) are initialization, not races (Eraser's virgin state).

Fields in :data:`BENIGN_FIELDS` are excluded with a recorded reason —
each entry cites the in-code documentation of WHY the unlocked access
is deliberate (GIL-atomic latches, torn-view-tolerant telemetry).  The
list is the audit's reviewable artifact: adding to it is a conscious
decision in a diff, not a silent pass.
"""

from __future__ import annotations

import ast
import inspect
from dataclasses import dataclass, field as dc_field
from typing import Iterable

from distlearn_tpu_torch.lint.core import Finding

__all__ = ["lint_races", "analyze_source", "core_targets", "fleet_targets",
           "THREAD_API", "SETUP_METHODS", "BENIGN_FIELDS"]


#: Documented cross-thread public surface per class: methods callable
#: from a thread OTHER than the one(s) the class spawns.
THREAD_API: dict = {
    # concurrent center: telemetry + HA surface is called from the obs
    # export thread, signal handlers, and the operator's main thread
    "AsyncEAServerConcurrent": {
        "checkpoint_now", "adopt_ha_meta", "stop", "test_net",
        "_health", "drained", "syncs_completed", "live_clients",
    },
    # serial center: single-threaded serve loop, but the SIGTERM flush
    # (ha.install_signal_flush) interrupts it with checkpoint_now
    "AsyncEAServer": {"checkpoint_now"},
    "_ShardEndpoint": {"get_conn", "drop", "drop_if", "drop_if_dead",
                       "close"},
    "_DeltaSender": {"submit", "flush", "drain", "close"},
    "ServeServer": {"health", "checkpoint_now", "stop"},
    # obs: metric mutators run on every instrumented thread; sample()
    # runs on the export thread
    "_Counter": {"inc", "sample"},
    "_Gauge": {"inc", "dec", "set", "sample"},
    "_Histogram": {"observe", "sample"},
    "Family": {"labels", "inc", "dec", "set", "observe", "value",
               "sample"},
    "Registry": {"counter", "gauge", "histogram", "snapshot",
                 "render_prometheus", "reset"},
    # -- fleet scope -------------------------------------------------------
    # router: generate() runs on every caller thread; health probes run
    # on the refresher cadence; membership mutators run on the
    # autoscaler's control thread
    "Router": {"generate", "health", "add_replica", "remove_replica",
               "replica_names", "close"},
    # collector: poll() runs on the autoscaler loop; endpoint membership
    # is mutated by operator/actuator threads
    "Collector": {"poll", "add_endpoint", "remove_endpoint"},
    "FleetRegistry": {"ingest", "forget", "sources", "merged", "total",
                      "histogram", "breakdown"},
    # fault plan: the chaos script mutates link state while wrapped
    # connections consult it from every transport thread
    "FaultPlan": {"partition", "heal", "delay", "bandwidth", "cut_after",
                  "fail_dials", "flaky_dials", "connect", "wrap",
                  "dropped_bytes", "decisions"},
}

#: Initialization phase per class: writes here happen before the
#: threads that could race exist (Eraser's virgin->exclusive states).
SETUP_METHODS: dict = {
    "AsyncEAServer": {"init_server", "enable_checkpoint"},
    "AsyncEAServerConcurrent": {"init_server", "enable_checkpoint",
                                "start", "_pin"},
    "AsyncEAClient": {"init_client"},
    "ServeServer": {"start"},
}

#: (class, field) -> reason.  Every entry cites the code's own
#: documentation of why the unlocked access is deliberate.  This list is
#: exactly the set of raw findings on the audited tree — removing an
#: entry must either produce a finding or the entry is stale.
BENIGN_FIELDS: dict = {
    # -- parallel/async_ea.py ----------------------------------------------
    ("AsyncEAServerConcurrent", "_inflight"):
        "_health reads are documented lock-free: 'telemetry tolerates a "
        "torn view' (async_ea.py _health)",
    ("_DeltaSender", "_err"):
        "ordered by the _idle Event, not a lock: _loop writes it only "
        "while _idle is cleared; flush/drain read only after _idle.wait() "
        "(class docstring: failure surfaced at the next flush)",
    ("_DeltaSender", "_idle"):
        "threading.Event is internally synchronized; set/clear/wait are "
        "its API, not raw shared-state mutation",
    # -- serve/server.py ----------------------------------------------------
    ("ServeServer", "_draining"):
        "GIL-atomic one-way bool latch: set by checkpoint_now, polled by "
        "the loop and health(); documented in checkpoint_now",
    ("ServeServer", "_failed"):
        "write-once failure latch published by the dying loop for "
        "health() readers ('record it, flip health'); a str attribute "
        "store is GIL-atomic",
    ("ServeServer", "epoch"):
        "written only by the serve loop's _maybe_swap; health() probes "
        "take GIL-atomic int snapshots — 'a probe racing a swap sees "
        "either epoch, both valid' (server.py epoch docstring)",
    ("ServeServer", "ckpt_step"):
        "same single-writer discipline as epoch: loop-only writes, "
        "GIL-atomic health() reads (server.py epoch docstring)",
    ("ServeServer", "_swap_pending"):
        "loop-only two-phase swap latch; health() reads only its "
        "None-ness for the swap_pending flag — a tuple attribute "
        "store is GIL-atomic (server.py epoch docstring)",
    ("ServeServer", "prefix_cache"):
        "the attribute itself is fixed at __init__ (None or the cache); "
        "the loop's clear() mutates cache internals and health() reads "
        "only the pages_held int — a GIL-atomic snapshot, and "
        "'telemetry tolerates a torn view' like the other gauges",
    # -- obs/core.py --------------------------------------------------------
    ("_Counter", "value"):
        "documented lock-cheap metric path: plain attribute increments "
        "are GIL-atomic and the export sample tolerates a torn view",
    ("_Gauge", "value"):
        "documented lock-cheap metric path: plain attribute increments "
        "are GIL-atomic and the export sample tolerates a torn view",
    ("Family", "_children"):
        "double-checked locking: lock-free fast-path dict read, create + "
        "re-check under the module _lock (labels())",
    ("Registry", "_families"):
        "double-checked locking: lock-free fast-path dict read, create + "
        "re-check under the module _lock (_get())",
    # -- serve/router.py ---------------------------------------------------
    ("Router", "_replicas"):
        "copy-on-write list: membership mutators rebuild and swap the "
        "whole list under _lock, so generate()'s lock-free availability "
        "scan only ever sees a complete list (router.py add_replica)",
}

_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "remove", "discard",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
    "add", "sort",
})


@dataclass
class _Access:
    field: str
    kind: str              # 'r' | 'w'
    locks: frozenset
    line: int


@dataclass
class _Method:
    name: str
    accesses: list = dc_field(default_factory=list)
    calls: list = dc_field(default_factory=list)   # (callee, locks, line)
    is_nested: bool = False


def _norm_lock(expr) -> str | None:
    """Canonical name for a lock-ish with-item / release target."""
    if isinstance(expr, ast.Subscript):
        base = _norm_lock(expr.value)
        return f"{base}[]" if base else None
    name = None
    if isinstance(expr, ast.Attribute):
        name = expr.attr
    elif isinstance(expr, ast.Name):
        name = expr.id
    if name and "lock" in name.lower():
        return name.lstrip("_")
    return None


class _ClassVisitor(ast.NodeVisitor):
    """Collect per-method field accesses, held locksets, intra-class
    calls, and thread entry points for ONE class body."""

    def __init__(self, class_name: str):
        self.class_name = class_name
        self.methods: dict[str, _Method] = {}
        self.entries: set[str] = set()
        self._cur: list[_Method] = []
        self._locks: list[str] = []
        self._outer: list[str] = []

    # -- structure ----------------------------------------------------------
    def visit_FunctionDef(self, node):
        nested = bool(self._cur)
        name = ".".join(self._outer + [node.name]) if nested else node.name
        m = _Method(name, is_nested=nested)
        self.methods[name] = m
        if nested:
            # a closure may run on another thread (_fanout legs); locks
            # held lexically outside it are NOT held when it runs
            self.entries.add(name)
        self._cur.append(m)
        self._outer.append(node.name)
        saved, self._locks = self._locks, []
        for stmt in node.body:
            self.visit(stmt)
        self._locks = saved
        self._outer.pop()
        self._cur.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass                       # no lock/alias tracking inside lambdas

    # -- lock scopes --------------------------------------------------------
    def visit_With(self, node):
        got = []
        for item in node.items:
            lk = _norm_lock(item.context_expr)
            if lk is not None:
                self._locks.append(lk)
                got.append(lk)
        for stmt in node.body:
            self.visit(stmt)
        for _ in got:
            self._locks.pop()

    def visit_Try(self, node):
        # acquire()/try/finally release() idiom: the body holds the lock
        held = []
        for stmt in node.finalbody:
            if (isinstance(stmt, ast.Expr)
                    and isinstance(stmt.value, ast.Call)
                    and isinstance(stmt.value.func, ast.Attribute)
                    and stmt.value.func.attr == "release"):
                lk = _norm_lock(stmt.value.func.value)
                if lk is not None:
                    held.append(lk)
        self._locks.extend(held)
        for stmt in node.body + node.orelse:
            self.visit(stmt)
        for _ in held:
            self._locks.pop()
        for h in node.handlers:
            self.visit(h)
        for stmt in node.finalbody:
            self.visit(stmt)

    # -- accesses -----------------------------------------------------------
    def _record(self, fieldname: str, kind: str, line: int):
        if self._cur:
            self._cur[-1].accesses.append(_Access(
                fieldname, kind, frozenset(self._locks), line))

    @staticmethod
    def _self_attr(node) -> str | None:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def visit_Attribute(self, node):
        fieldname = self._self_attr(node)
        if fieldname is not None:
            kind = "w" if isinstance(node.ctx, (ast.Store, ast.Del)) else "r"
            self._record(fieldname, kind, node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        # self._x[i] = v / del self._x[i]: container mutation -> write
        fieldname = self._self_attr(node.value)
        if fieldname is not None and isinstance(node.ctx,
                                                (ast.Store, ast.Del)):
            self._record(fieldname, "w", node.lineno)
        self.generic_visit(node)

    def visit_Call(self, node):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            # self.m(...) -> intra-class call edge
            callee = self._self_attr(fn)
            if callee is not None and self._cur:
                self._cur[-1].calls.append(
                    (callee, frozenset(self._locks), node.lineno))
            # self._x.append(...) -> container mutation -> write
            if fn.attr in _MUTATORS:
                owner = self._self_attr(fn.value)
                if owner is not None:
                    self._record(owner, "w", node.lineno)
            # threading.Thread(target=self.m) -> thread entry point
            if fn.attr == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        tgt = self._self_attr(kw.value)
                        if tgt is not None:
                            self.entries.add(tgt)
        self.generic_visit(node)


def _effective_accesses(cv: _ClassVisitor, entry: str,
                        setup: set) -> "list[tuple[str, _Access, frozenset]]":
    """All (method, access, path-lockset) reachable from ``entry``,
    propagating guaranteed-held locks through intra-class calls."""
    out = []
    seen: set = set()
    work = [(entry, frozenset())]
    while work:
        mname, held = work.pop()
        if (mname, held) in seen:
            continue
        seen.add((mname, held))
        m = cv.methods.get(mname)
        if m is None:
            continue
        for acc in m.accesses:
            out.append((mname, acc, held | acc.locks))
        for callee, at_site, _line in m.calls:
            if callee in cv.methods and callee != "__init__":
                work.append((callee, held | at_site))
    return out


def _audit_class(cv: _ClassVisitor, modname: str) -> list[Finding]:
    entries = set(cv.entries)
    entries |= {m for m in THREAD_API.get(cv.class_name, ())
                if m in cv.methods}
    setup = {"__init__"} | set(SETUP_METHODS.get(cv.class_name, ()))
    entries -= setup
    if len(entries) < 2:
        return []            # no cross-thread surface to intersect
    # field -> list of (entry, method, access, lockset)
    per_field: dict[str, list] = {}
    for entry in sorted(entries):
        for mname, acc, locks in _effective_accesses(cv, entry, setup):
            if acc.kind == "w" and mname in setup:
                continue     # initialization writes (virgin state)
            per_field.setdefault(acc.field, []).append(
                (entry, mname, acc, locks))
    findings = []
    for fieldname in sorted(per_field):
        if (cv.class_name, fieldname) in BENIGN_FIELDS:
            continue
        accs = per_field[fieldname]
        touched_by = {e for e, _m, _a, _l in accs}
        if len(touched_by) < 2:
            continue         # single thread role: no race surface
        writes = [(e, m, a, l) for e, m, a, l in accs if a.kind == "w"]
        if not writes:
            continue         # read-only after init
        wcommon = frozenset.intersection(*[l for _e, _m, _a, l in writes])
        where = f"{modname}.{cv.class_name}.{fieldname}"

        def _ev(rows, n=3):
            return ", ".join(
                f"{m}:{a.line} [{e}]"
                + (f" holds {{{', '.join(sorted(l))}}}" if l
                   else " holds no lock")
                for e, m, a, l in rows[:n])

        if not wcommon:
            # least-guarded writes first: the offending row must survive
            # the evidence truncation
            writes.sort(key=lambda row: len(row[3]))
            findings.append(Finding(
                "DL111",
                f"field written with NO lock common to all writers while "
                f"{len(touched_by)} thread roles "
                f"({', '.join(sorted(touched_by))}) touch it — "
                f"writes: {_ev(writes)}; "
                f"other accesses: "
                f"{_ev([r for r in accs if r[2].kind == 'r'])}",
                where=where))
            continue
        naked = [(e, m, a, l) for e, m, a, l in accs if not (wcommon & l)]
        if naked:
            findings.append(Finding(
                "DL112",
                f"writes are consistently guarded by "
                f"{{{', '.join(sorted(wcommon))}}} but cross-thread "
                f"access(es) skip the guard (torn-read hazard): "
                f"{_ev(naked)}",
                where=where, severity="warning"))
    return findings


def analyze_source(src: str, modname: str = "<string>") -> list[Finding]:
    """Run the lockset audit over one module's source text."""
    tree = ast.parse(src)
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            cv = _ClassVisitor(node.name)
            for stmt in node.body:
                cv.visit(stmt)
            findings += _audit_class(cv, modname)
    return findings


def core_targets() -> list:
    """The training/HA/serve-core threaded modules of the port (plus the
    obs metric primitives they instrument)."""
    from distlearn_tpu_torch import obs  # noqa: F401  (import side-effects)
    from distlearn_tpu_torch.obs import core as obs_core
    from distlearn_tpu_torch.obs import export as obs_export
    from distlearn_tpu_torch.obs import trace as obs_trace
    from distlearn_tpu_torch.parallel import async_ea, ha
    from distlearn_tpu_torch.serve import scheduler, server
    return [async_ea, ha, server, scheduler,
            obs_core, obs_export, obs_trace]


def fleet_targets() -> list:
    """The fleet scope of the port: the serve router, the obs fleet
    collector, the fault plan, and the autoscaler (a module of the port's
    ``tools`` package, where the JAX package reads its root
    ``tools/autoscaler.py`` off disk)."""
    from distlearn_tpu_torch.comm import faults
    from distlearn_tpu_torch.obs import agg as obs_agg
    from distlearn_tpu_torch.serve import router
    from distlearn_tpu_torch.tools import autoscaler
    return [router, obs_agg, faults, autoscaler]


def lint_races(targets: Iterable | None = None) -> list[Finding]:
    """DL111/DL112 audit.  ``targets``: modules, raw source strings, or
    ``(source, modname)`` pairs; defaults to :func:`core_targets` +
    :func:`fleet_targets` (the full threaded surface)."""
    if targets is None:
        targets = core_targets() + fleet_targets()
    findings: list[Finding] = []
    for t in targets:
        if isinstance(t, tuple):
            src, modname = t
        elif isinstance(t, str):
            src, modname = t, "<string>"
        else:
            src, modname = inspect.getsource(t), t.__name__
        findings += analyze_source(src, modname)
    return findings
