"""Schedule↔code conformance (rule DL310) — counterpart of
``distlearn_tpu/lint/conformance.py`` over the port's sources: the
schedules of the port's ``lint/protocol.py`` against the port's
``parallel/async_ea.py`` and ``obs/trace.py``, and the serve frames
against the port's ``serve/{server,router,client}.py``.

The ``async_ea_*_schedule`` builders in ``lint/protocol.py`` are
hand-written transcriptions of the blocking send/recv sequences in
``parallel/async_ea.py`` — which means they can silently drift from the
code they claim to model, and every DL101/DL104 verdict downstream of a
drifted schedule is a verdict about a protocol nobody runs.  This module
pins the two together:

* **Tag vocabulary** — every send/recv tag a schedule uses must be bound
  in :data:`TAG_BINDINGS` to its origin: a wire-protocol constant in
  ``async_ea.py`` (existence AND value are checked against the module
  source, so renaming ``DELTA_Q`` or changing its string breaks
  conformance, not just the schedules), a reply-dict key (``stale``), a
  tensor/packed stream leg, or a synthetic scheduling marker (``go``).
  An unbound tag — the classic "edited the schedule, not the code"
  mutation — is DL310.
* **Usage evidence** — each bound constant must actually be *used* (a
  ``Load`` beyond its definition) in ``async_ea.py``, and the handshake
  call sites the schedules transcribe must exist: ``_rejoin_handshake``
  sends ``ACK``, ``_replay_exchange`` opens with a ``REPLAY_Q`` dict
  send, ``_refuse_stale`` sends a reply carrying the ``stale`` key.
* **Question order** — ``sync_client`` sends ``Center?`` before
  ``delta?`` (the fetch-then-push EASGD round).  The first-send order is
  extracted from the code's AST and every schedule rank that sends both
  must agree — swapping ``client_order`` in a schedule (or the code) is
  DL310 here before it is a DL104 desync in the simulator.
* **Coverage** — every ``*_Q`` message-type constant the code defines
  must appear in some schedule, except those in
  :data:`KNOWN_UNMODELED` (with a recorded reason), so a NEW message
  type cannot ship without either a schedule or a conscious exemption.
* **Trace-context field** — the optional cross-process trace context
  (the JAX package's docs/OBSERVABILITY.md) rides dict messages under
  ``obs.trace.TRACE_KEY``; its value is pinned to ``"tc"`` (renaming it
  breaks mixed-fleet interop with peers already on the wire) and
  ``async_ea.py`` must show usage evidence — the ``_announce`` stamp
  and the ``_admit`` adoption read the constant, not a literal.

``lint_conformance(schedules=..., source=...)`` accepts overrides so the
seeded-mutation tests can feed in an edited schedule or edited module
source and assert DL310 fires.

Serve-frame field conformance (:func:`lint_serve_frames`) extends the
same discipline to the serving wire: every field the 'J' health-probe
reply, the 'G' generate request, and the 'R' stream chunk carry must be
bound in :data:`SERVE_FRAME_BINDINGS`, and every binding must still
show producer-or-consumer evidence in ``serve/server.py`` /
``serve/router.py`` / ``serve/client.py``.  The check is bidirectional:
a NEW field shipped without a binding is DL310 (undocumented wire
surface), and a binding whose field vanished from the code is DL310
stale (the table would lie to the next reader).
"""

from __future__ import annotations

import ast
import inspect
from typing import Mapping

from distlearn_tpu_torch.lint.core import Finding

__all__ = ["lint_conformance", "lint_serve_frames", "TAG_BINDINGS",
           "KNOWN_UNMODELED", "SERVE_FRAME_BINDINGS"]

#: tag -> (kind, detail).  Kinds:
#:   "const"     — wire constant in async_ea.py; detail = const name;
#:                 value must equal the tag exactly
#:   "const_ci"  — same, but schedules use the wire's lowercase form
#:   "key"       — reply-dict key; detail = the key literal
#:   "stream"    — tensor/packed payload leg, no msg-tag constant
#:   "synthetic" — scheduling marker with no wire message at all
TAG_BINDINGS: dict = {
    "Enter?": ("const", "ENTER_Q"),
    "Enter": ("const", "ENTER"),
    "Center?": ("const", "CENTER_Q"),
    "delta?": ("const", "DELTA_Q"),
    "delta": ("const", "DELTA"),
    "Rejoin?": ("const", "REJOIN_Q"),
    "Rejoin": ("const", "REJOIN"),
    "Shard?": ("const", "SHARD_Q"),
    "Replay": ("const", "REPLAY_Q"),
    "Join?": ("const", "JOIN_Q"),
    "Join": ("const", "JOIN"),
    "Leave?": ("const", "LEAVE_Q"),
    "Leave": ("const", "LEAVE"),
    "ack": ("const_ci", "ACK"),
    "stale": ("key", "stale"),
    "center": ("stream", "per-leaf center tensor leg (send_tensors)"),
    "center_p": ("stream", "packed center frame (send_packed)"),
    "delta_t": ("stream", "per-leaf delta tensor leg"),
    "delta_p": ("stream", "packed delta frame"),
    "replay_p": ("stream", "replay stripe payload frame"),
    "go": ("synthetic", "client-side thread fan-out marker — models the "
                        "stripe-leg spawn order, never hits the wire"),
}

#: ``*_Q`` message types the code defines that no schedule models, each
#: with the reason the gap is deliberate.
KNOWN_UNMODELED: dict = {
    "TEST_Q": "test_net() is a standalone health RPC, not part of any "
              "sync/rejoin/failover round the schedules transcribe",
}

#: (function, constant) send call sites the schedules transcribe.
_CALLSITE_EVIDENCE = (
    ("_rejoin_handshake", "ACK",
     "the rejoin center-stream ack leg (schedules' 'ack' after 'center')"),
    ("_replay_exchange", "REPLAY_Q",
     "the replay announcement (schedules' 'Replay' op)"),
    ("leave", "LEAVE_Q",
     "the graceful-leave announcement (the join/leave schedules' "
     "'Leave?' op)"),
)


class _CodeFacts(ast.NodeVisitor):
    """Module-level constants, per-name Load counts, and per-function
    ``send_msg`` call summaries for one module's AST."""

    def __init__(self):
        self.consts: dict[str, object] = {}
        self.loads: dict[str, int] = {}
        #: attribute-name -> Load count (``obs_trace.TRACE_KEY`` reads
        #: are Attribute nodes, invisible to the Name counter above)
        self.attr_loads: dict[str, int] = {}
        #: function name -> ordered list of send descriptors:
        #:   ("const", NAME) for send_msg(NAME)
        #:   ("keys", frozenset) for send_msg({...literal dict...})
        self.sends: dict[str, list] = {}
        self._func: list[str] = []

    def visit_Assign(self, node):
        if not self._func:
            for t in node.targets:
                if (isinstance(t, ast.Name)
                        and isinstance(node.value, ast.Constant)):
                    self.consts[t.id] = node.value.value
        self.generic_visit(node)

    def visit_FunctionDef(self, node):
        self._func.append(node.name)
        self.sends.setdefault(node.name, [])
        self.generic_visit(node)
        self._func.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.loads[node.id] = self.loads.get(node.id, 0) + 1
        self.generic_visit(node)

    def visit_Attribute(self, node):
        if isinstance(node.ctx, ast.Load):
            self.attr_loads[node.attr] = \
                self.attr_loads.get(node.attr, 0) + 1
        self.generic_visit(node)

    def _record_send(self, desc):
        # credit every enclosing scope: sync_client's wire traffic lives
        # in its _fetch/_push closures, and lexical definition order of
        # those closures matches their call order in the round
        for fname in self._func:
            self.sends[fname].append(desc)

    def visit_Call(self, node):
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "send_msg" and self._func
                and node.args):
            a = node.args[0]
            if isinstance(a, ast.Name):
                self._record_send(("const", a.id))
            elif isinstance(a, ast.Dict):
                keys, qconst = set(), None
                for k, v in zip(a.keys, a.values):
                    if isinstance(k, ast.Constant):
                        keys.add(k.value)
                        if (k.value == "q" and isinstance(v, ast.Name)):
                            qconst = v.id
                if qconst is not None:
                    self._record_send(("const", qconst))
                self._record_send(("keys", frozenset(keys)))
        self.generic_visit(node)


def _schedule_tags(sched: Mapping):
    """Yield (rank, op) for every op in a schedule dict."""
    for rank, ops in sched.items():
        for op in ops:
            yield rank, op


def _default_schedules() -> dict:
    from distlearn_tpu_torch.lint import protocol
    out = {}
    for name in dir(protocol):
        if name.startswith("async_ea_") and name.endswith("_schedule"):
            out[name] = getattr(protocol, name)()
    return out


def lint_conformance(*, schedules: Mapping | None = None,
                     source: str | None = None) -> list[Finding]:
    """DL310 audit: diff every hand-written ``async_ea_*`` schedule
    against the wire constants and call sites in ``async_ea.py``.

    ``schedules`` maps schedule name -> per-rank op dict (default: every
    ``async_ea_*_schedule`` builder at its default arity); ``source``
    overrides the ``async_ea.py`` module source (mutation tests).
    """
    if schedules is None:
        schedules = _default_schedules()
    if source is None:
        from distlearn_tpu_torch.parallel import async_ea
        source = inspect.getsource(async_ea)
    facts = _CodeFacts()
    facts.visit(ast.parse(source))
    findings: list[Finding] = []

    # -- 1. every schedule tag is bound, and const bindings hold ------------
    used_consts: set[str] = set()
    for sname, sched in schedules.items():
        for rank, op in _schedule_tags(sched):
            tag = op.tag
            binding = TAG_BINDINGS.get(tag)
            where = f"{sname}:{rank}"
            if binding is None:
                findings.append(Finding(
                    "DL310",
                    f"schedule op {op.kind}({op.peer!r}, {tag!r}) uses a "
                    f"tag bound to nothing in async_ea.py — the schedule "
                    f"drifted from the code (or the binding table needs "
                    f"a new entry with evidence)", where=where))
                continue
            kind, detail = binding
            if kind in ("const", "const_ci"):
                used_consts.add(detail)
                val = facts.consts.get(detail)
                if val is None:
                    findings.append(Finding(
                        "DL310",
                        f"tag {tag!r} is bound to constant {detail} which "
                        f"async_ea.py no longer defines", where=where))
                elif (str(val).lower() != tag.lower() if kind == "const_ci"
                      else val != tag):
                    findings.append(Finding(
                        "DL310",
                        f"tag {tag!r} is bound to {detail} but the code's "
                        f"value is {val!r} — schedule and wire protocol "
                        f"disagree", where=where))

    # -- 2. bound constants are actually used by the code -------------------
    for const in sorted(used_consts):
        if const in facts.consts and facts.loads.get(const, 0) < 1:
            findings.append(Finding(
                "DL310",
                f"wire constant {const} is defined but never used — the "
                f"schedules model a message the code no longer sends",
                where=f"async_ea.{const}"))

    # -- 3. transcribed call sites exist ------------------------------------
    for func, const, why in _CALLSITE_EVIDENCE:
        sends = facts.sends.get(func)
        if sends is None:
            findings.append(Finding(
                "DL310",
                f"function {func}() (transcribed by the schedules: {why}) "
                f"no longer exists in async_ea.py", where=f"async_ea.{func}"))
        elif ("const", const) not in sends:
            findings.append(Finding(
                "DL310",
                f"{func}() no longer sends {const} — schedules still "
                f"transcribe it ({why})", where=f"async_ea.{func}"))
    if not any("keys" == k and "stale" in keys
               for sends in facts.sends.values()
               for k, keys in sends):
        findings.append(Finding(
            "DL310",
            "no send_msg call carries the 'stale' reply key — the "
            "stale-epoch refusal the zombie-fence schedule models is gone "
            "from the code (_refuse_stale)", where="async_ea._refuse_stale"))

    # -- 4. question order: Center? before delta? ---------------------------
    # sync_client is a thin tau/trace gate around _sync_once, which owns
    # the round's wire traffic — scan both so the split stays honest
    client_sends = [c for fname in ("sync_client", "_sync_once")
                    for k, c in facts.sends.get(fname, ())
                    if k == "const"]
    code_order_ok = ("CENTER_Q" in client_sends and "DELTA_Q" in client_sends
                     and (client_sends.index("CENTER_Q")
                          < client_sends.index("DELTA_Q")))
    if not code_order_ok:
        findings.append(Finding(
            "DL310",
            "sync_client() no longer sends CENTER_Q before DELTA_Q — the "
            "fetch-then-push round order every schedule transcribes",
            where="async_ea.sync_client"))
    for sname, sched in schedules.items():
        for rank, ops in sched.items():
            tags = [op.tag for op in ops if op.kind == "send"]
            if "Center?" in tags and "delta?" in tags:
                if tags.index("Center?") > tags.index("delta?"):
                    findings.append(Finding(
                        "DL310",
                        f"rank sends delta? before Center? but "
                        f"sync_client() fetches the center first — the "
                        f"schedule models a question order the code "
                        f"never executes", where=f"{sname}:{rank}"))

    # -- 5. coverage: every *_Q message type is modeled or exempted ---------
    modeled = {d for t, (k, d) in TAG_BINDINGS.items()
               if k in ("const", "const_ci")}
    for name in sorted(facts.consts):
        if name.endswith("_Q") and name not in modeled \
                and name not in KNOWN_UNMODELED:
            findings.append(Finding(
                "DL310",
                f"message-type constant {name} has no schedule modeling "
                f"it and no KNOWN_UNMODELED exemption — new wire traffic "
                f"must be modeled or consciously exempted",
                where=f"async_ea.{name}"))

    # -- 6. trace-context frame field (docs/OBSERVABILITY.md) ---------------
    # The optional trace context rides dict messages under TRACE_KEY;
    # the documented wire format (and mixed-fleet interop) pins the key
    # to "tc", and async_ea.py must actually stamp/read it — a schedule
    # can't model an optional field, so the binding is evidence-only.
    from distlearn_tpu_torch.obs import trace as _obs_trace
    if _obs_trace.TRACE_KEY != "tc":
        findings.append(Finding(
            "DL310",
            f"obs.trace.TRACE_KEY is {_obs_trace.TRACE_KEY!r} but the "
            f"documented wire format pins 'tc' — peers already in "
            f"flight would silently drop the renamed field",
            where="obs.trace.TRACE_KEY"))
    if facts.attr_loads.get("TRACE_KEY", 0) < 1:
        findings.append(Finding(
            "DL310",
            "async_ea.py never reads obs.trace.TRACE_KEY — the Enter? "
            "announce no longer stamps (and the admit path no longer "
            "adopts) the trace context the wire format documents",
            where="async_ea._announce"))
    return findings


# ---------------------------------------------------------------------------
# Serve-frame field conformance ('J' / 'G' / 'R' wire frames)
# ---------------------------------------------------------------------------

#: frame kind -> {field: what it carries}.  The audited evidence is the
#: union of producer writes and consumer reads across server/router/
#: client; both directions are checked (new-field-unbound AND
#: stale-binding fire DL310).
SERVE_FRAME_BINDINGS: dict = {
    "J": {
        "q": "control request verb ('stats') from router._probe / "
             "client.ping",
        "ok": "reply envelope flag stamped by the server's J handler",
        "serving": "loop-alive flag; router._live gates dispatch on it",
        "failed": "death reason latch; router._live treats it as down",
        "draining": "checkpoint drain latch; router skips draining "
                    "replicas",
        "queue_depth": "admission backlog; router load-balances and "
                       "sheds on it",
        "active": "occupied decode slots; router's least-loaded score",
        "free_pages": "KV pool headroom (capacity telemetry)",
        "cached_pages": "pool pages retained by the prefix cache",
        "epoch": "serving weights epoch; router's fleet epoch view",
        "ckpt_step": "checkpoint step of the serving weights",
        "swap_pending": "two-phase hot-swap in progress",
    },
    "G": {
        "prompt": "token ids to prefill",
        "max_new": "decode budget",
        "rid": "caller-chosen request id (optional)",
        "deadline_s": "per-request deadline (optional)",
        "eos": "early-stop token id (optional)",
        "tc": "cross-process trace context (obs.trace.TRACE_KEY)",
        "temperature": "sampling temperature; 0/absent = exact greedy",
        "top_k": "top-k logit filter width (0 = off)",
        "top_p": "nucleus sampling mass (0 = off)",
        "seed": "per-request sampling key seed (reproducible streams)",
        "speculate": "False opts a greedy stream out of speculative "
                     "decoding",
    },
    "R": {
        "rid": "request id echo (stream demux on shared conns)",
        "tokens": "tokens decoded this scheduling round",
        "done": "terminal-chunk flag",
        "epoch": "serving epoch echo — the hot-swap fence witness",
        "reason": "terminal reason (complete/eos/deadline/...)",
        "error": "rejection/abort message (error chunks only)",
        "queue_depth": "backlog at rejection time (shed hint)",
        "retry_after": "shed backoff hint in seconds",
        "accepted": "speculative draft tokens accepted this round",
        "cached_tokens": "prompt tokens adopted from the prefix cache "
                         "(first chunk only)",
    },
}


def _dict_const_keys(d) -> set:
    """Constant keys of one dict literal (``**spread`` keys are None)."""
    return {k.value for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)}


def _get_key(call) -> str | None:
    """``X.get("field")`` / ``X.get(obs_trace.TRACE_KEY)`` -> field."""
    if not (isinstance(call, ast.Call) and isinstance(call.func,
                                                      ast.Attribute)
            and call.func.attr == "get" and call.args):
        return None
    a = call.args[0]
    if isinstance(a, ast.Constant) and isinstance(a.value, str):
        return a.value
    if isinstance(a, ast.Attribute) and a.attr == "TRACE_KEY":
        return "tc"
    return None


def _sub_key(sub) -> str | None:
    """``X["field"]`` / ``X[obs_trace.TRACE_KEY]`` -> field."""
    s = sub.slice
    if isinstance(s, ast.Constant) and isinstance(s.value, str):
        return s.value
    if isinstance(s, ast.Attribute) and s.attr == "TRACE_KEY":
        return "tc"
    return None


def _send_msg_dict_keys(tree) -> set:
    out: set = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "send_msg" and node.args
                and isinstance(node.args[0], ast.Dict)):
            out |= _dict_const_keys(node.args[0])
    return out


def _health_reply_keys(tree) -> set:
    """Constant keys of the ``health()`` return dict — the payload the
    server's J handler spreads into its reply."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == "health":
            for sub in ast.walk(node):
                if isinstance(sub, ast.Return) and isinstance(sub.value,
                                                              ast.Dict):
                    return _dict_const_keys(sub.value)
    return set()


def _stream_chunk_keys(tree) -> set:
    """Fields of every 'R' chunk a server function builds: dict-literal
    keys plus constant subscript stores, in functions that send_stream."""
    out: set = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        sends = any(isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "send_stream"
                    for n in ast.walk(node))
        if not sends:
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Dict):
                out |= _dict_const_keys(sub)
            elif (isinstance(sub, ast.Subscript)
                    and isinstance(sub.ctx, ast.Store)
                    and isinstance(sub.value, ast.Name)):
                k = _sub_key(sub)
                if k is not None:
                    out.add(k)
    return out


def _g_request_keys(tree) -> set:
    """Fields of the 'G' request ``msg`` dict a caller builds: the
    literal assignment plus the optional-field subscript stores."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == "msg"
                        and isinstance(node.value, ast.Dict)):
                    out |= _dict_const_keys(node.value)
        elif (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Store)
                and isinstance(node.value, ast.Name)
                and node.value.id == "msg"):
            k = _sub_key(node)
            if k is not None:
                out.add(k)
    return out


def _name_field_reads(tree, varname: str) -> set:
    """``X.get("f")`` and ``X["f"]`` loads on the local name ``X``."""
    out: set = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == varname):
            k = _get_key(node)
            if k is not None:
                out.add(k)
        elif (isinstance(node, ast.Subscript)
                and isinstance(node.ctx, ast.Load)
                and isinstance(node.value, ast.Name)
                and node.value.id == varname):
            k = _sub_key(node)
            if k is not None:
                out.add(k)
    return out


def _health_snapshot_reads(tree) -> set:
    """'J'-reply fields the router consumes: ``.get("f")`` where the
    receiver mentions a ``health`` attribute (``(rep.health or
    {}).get(...)``) or is the conventional ``h`` local, plus the
    dict-comprehension sweep ``{k: (r.health or {}).get(k) for k in
    ("queue_depth", ...)}``."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            k = _get_key(node)
            if k is not None:
                recv = node.func.value
                mentions_health = any(
                    isinstance(n, ast.Attribute) and n.attr == "health"
                    for n in ast.walk(recv))
                if mentions_health or (isinstance(recv, ast.Name)
                                       and recv.id == "h"):
                    out.add(k)
        elif isinstance(node, ast.DictComp):
            # value reads X.get(k) with the comprehension variable
            v = node.value
            if (isinstance(v, ast.Call)
                    and isinstance(v.func, ast.Attribute)
                    and v.func.attr == "get" and v.args
                    and isinstance(v.args[0], ast.Name)
                    and node.generators
                    and isinstance(node.generators[0].iter, ast.Tuple)):
                out |= {e.value for e in node.generators[0].iter.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, str)}
    return out


def lint_serve_frames(*, server_source: str | None = None,
                      router_source: str | None = None,
                      client_source: str | None = None) -> list[Finding]:
    """DL310 audit of the serving wire frames ('J'/'G'/'R').

    Collects per-frame field evidence — producer writes in
    ``server.py`` (R chunks, J reply) and ``router.py``/``client.py``
    (G request, J probe), consumer reads on the other side — and diffs
    the union against :data:`SERVE_FRAME_BINDINGS` in BOTH directions.
    Source overrides feed the seeded-mutation tests.
    """
    if server_source is None:
        from distlearn_tpu_torch.serve import server
        server_source = inspect.getsource(server)
    if router_source is None:
        from distlearn_tpu_torch.serve import router
        router_source = inspect.getsource(router)
    if client_source is None:
        from distlearn_tpu_torch.serve import client
        client_source = inspect.getsource(client)
    srv = ast.parse(server_source)
    rtr = ast.parse(router_source)
    cli = ast.parse(client_source)

    evidence = {
        "J": (_send_msg_dict_keys(srv) | _health_reply_keys(srv)
              | _send_msg_dict_keys(rtr) | _send_msg_dict_keys(cli)
              | _health_snapshot_reads(rtr)),
        "G": (_g_request_keys(rtr) | _g_request_keys(cli)
              | _name_field_reads(srv, "msg")),
        "R": (_stream_chunk_keys(srv)
              | _name_field_reads(rtr, "chunk")
              | _name_field_reads(cli, "chunk")),
    }
    findings: list[Finding] = []
    for kind in sorted(SERVE_FRAME_BINDINGS):
        bound = SERVE_FRAME_BINDINGS[kind]
        seen = evidence[kind]
        for fieldname in sorted(seen - set(bound)):
            findings.append(Finding(
                "DL310",
                f"'{kind}' frame field {fieldname!r} appears in the serve "
                "wire code but has no SERVE_FRAME_BINDINGS entry — new "
                "wire surface must be bound (with what it carries) or it "
                "ships undocumented",
                where=f"serve_frames.{kind}.{fieldname}"))
        for fieldname in sorted(set(bound) - seen):
            findings.append(Finding(
                "DL310",
                f"'{kind}' frame binding {fieldname!r} has no remaining "
                "producer or consumer in server/router/client — the "
                "binding table drifted from the wire (remove the entry "
                "or restore the field)",
                where=f"serve_frames.{kind}.{fieldname}"))
    return findings
