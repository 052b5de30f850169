"""Span API — a copy of ``distlearn_tpu/obs/trace.py``: monotonic
start/duration records for the host-side hot paths (handshakes, step
dispatch, rejoin cycles), plus the cross-process trace context those
spans can ride.

A span is one timed region: ``with obs.span("async_ea.handshake",
cid=3):`` or ``@obs.traced("data.load")``.  Completed spans land in an
in-memory ring buffer (bounded; the newest ``ring_size`` survive; ring
evictions are counted in ``obs_spans_dropped_total`` so a truncated
trail reads as truncated, not quiet) and, when a spill path is set, are
appended as JSONL — the machine-readable trail ``tools/diststat.py``
aggregates into p50/p95/p99 tables and ``tools/tracecat.py`` stitches
into per-trace waterfalls.

Trace context (docs/OBSERVABILITY.md "trace-context wire format"): a
compact dict ``{"t": <trace-id hex>, "s": <parent span-id hex>, "f":
0|1}`` carried under the :data:`TRACE_KEY` field of existing JSON wire
messages (the AsyncEA ``Enter?`` announce, the serving 'G' frame).
Each thread keeps a context *stack*: entering :func:`span` under an
active context allocates a fresh span id and pushes it, so nested spans
record ``trace``/``span``/``parent`` fields and multi-process trails
stitch into one tree.  Threads do not inherit the stack — fan-out legs
re-enter the parent's context explicitly with :func:`use_context`.

Propagation is OFF by default (``DISTLEARN_TRACE_PROP``, the shared
``env_truthy`` spelling): with it off no wire message gains the
:data:`TRACE_KEY` field, so frames are bitwise identical to a
pre-trace peer's — mixed fleets interop unchanged.  Local span
*recording* is governed only by the ``DISTLEARN_OBS`` kill switch.

A record carries ``ts`` (epoch seconds at the span's end, as before),
``dur`` (seconds, from the monotonic clock) and ``start`` (epoch seconds
at its start).  ``start`` is on the clock of ``torch.profiler``'s Chrome
trace: a profiler event at trace time ``t`` microseconds happened at
epoch ``t + baseTimeNanoseconds / 1e3`` microseconds, so a span joins a
device trace at ``start * 1e6 - baseTimeNanoseconds / 1e3``.

torch bridge: when torch is already imported (this module never imports
it — obs stays dependency-free) and a torch profiler is recording, each
span also opens a ``torch.profiler.record_function`` range so host spans
line up with device timelines in a captured profile.  With no profiler
recording no range is opened: one costs microseconds even then.

Kill switch: with ``DISTLEARN_OBS=0`` :func:`span` returns a shared
null context manager — no record, no timing calls, no allocation.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import sys
import threading
import time

from distlearn_tpu_torch.obs import core
from distlearn_tpu_torch.utils.flags import env_truthy

#: The JSON-message field the trace context rides under.  The DL310
#: conformance audit (lint/conformance.py) pins the schedules' view of
#: the wire to this constant — rename it here and conformance fires.
TRACE_KEY = "tc"

#: Propagation kill switch (separate from ``DISTLEARN_OBS``): unset or
#: falsy = no wire message carries :data:`TRACE_KEY` (bitwise-legacy
#: frames); truthy = opt in.
PROP_SWITCH = "DISTLEARN_TRACE_PROP"

_ring: collections.deque = collections.deque(maxlen=4096)
_spill_lock = threading.Lock()
_spill_fh = None
_spill_path: str | None = None
_propagate: bool | None = None
_proc: str | None = None
_tls = threading.local()
#: set False to skip the torch.profiler.record_function bridge even when
#: torch is loaded (micro-bench isolation).
bridge_torch = True


def set_ring_size(n: int):
    """Resize the in-memory span ring (keeps the newest records)."""
    global _ring
    _ring = collections.deque(_ring, maxlen=int(n))


def set_spill(path: str | None):
    """Append completed spans to ``path`` as JSONL (``None`` closes).
    A no-op while the kill switch is off — a disabled run creates no
    file."""
    global _spill_fh, _spill_path
    with _spill_lock:
        if _spill_fh is not None:
            _spill_fh.close()
            _spill_fh = None
        _spill_path = None
        if path and core.enabled():
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            _spill_fh = open(path, "a")
            _spill_path = path


def spill_path() -> str | None:
    return _spill_path


def spans() -> list[dict]:
    """Snapshot of the in-memory ring (oldest first)."""
    return list(_ring)


def clear():
    _ring.clear()


def set_process(name: str | None):
    """Stamp every span record this process emits with ``proc: name``
    (``None`` clears).  Multi-trail consumers (``tools/tracecat.py``,
    ``diststat merge``) use it to attribute spans to fleet members even
    when trails are concatenated."""
    global _proc
    _proc = str(name) if name else None


def process_name() -> str | None:
    return _proc


def _dropped_counter():
    # no module-level cache: Registry.reset() (tests) strands live
    # handles, and the get-or-create here is one dict lookup
    return core.REGISTRY.counter(
        "obs_spans_dropped_total",
        "span records evicted from the in-memory ring (ring full); "
        "spilled JSONL is unaffected")


def _record(rec: dict):
    if _proc is not None:
        rec["proc"] = _proc
    if _ring.maxlen is not None and len(_ring) >= _ring.maxlen:
        # the deque evicts its oldest record on this append: the ring
        # view truncates.  Count it — a diststat over the ring (or a
        # trail cut from it) must be able to say "N spans missing".
        _dropped_counter().inc()
    _ring.append(rec)
    if _spill_fh is not None:
        line = json.dumps(rec) + "\n"
        with _spill_lock:
            if _spill_fh is not None:
                _spill_fh.write(line)
                _spill_fh.flush()


# -- trace context -----------------------------------------------------------

def _gen_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def new_trace(sampled: bool = True) -> dict:
    """A fresh root trace context: 64-bit trace id, no parent span yet.
    Enter it with :func:`use_context`; the first :func:`span` under it
    becomes the trace's root span."""
    return {"t": _gen_id(8), "s": "", "f": 1 if sampled else 0}


def valid_context(tc) -> bool:
    """Structural check for a wire-received context — a malformed or
    adversarial ``tc`` field must degrade to "no trace", never raise."""
    if not isinstance(tc, dict):
        return False
    t, s, f = tc.get("t"), tc.get("s", ""), tc.get("f", 1)
    try:
        return (isinstance(t, str) and 0 < len(t) <= 32
                and int(t, 16) >= 0
                and isinstance(s, str) and len(s) <= 32
                and (s == "" or int(s, 16) >= 0)
                and f in (0, 1))
    except ValueError:
        return False


def _stack() -> list:
    st = getattr(_tls, "ctx", None)
    if st is None:
        st = _tls.ctx = []
    return st


def current() -> dict | None:
    """The innermost active context on THIS thread, or ``None``."""
    st = _stack()
    return st[-1] if st else None


def wire_context() -> dict | None:
    """The context to put on an outgoing wire message: current trace id
    with the current span as parent.  ``None`` when no trace is active
    or propagation is disabled — callers simply omit the field then."""
    if not propagate_enabled():
        return None
    cur = current()
    if cur is None:
        return None
    return {"t": cur["t"], "s": cur["s"], "f": 1}


@contextlib.contextmanager
def use_context(tc):
    """Enter a trace context (from :func:`new_trace` or a wire
    message's :data:`TRACE_KEY` field) on this thread.  Invalid,
    ``None``, or unsampled (``f == 0``) contexts are a no-op — the
    block still runs, spans just stay trace-less."""
    if not core.enabled() or not valid_context(tc) or not tc.get("f", 1):
        yield None
        return
    st = _stack()
    st.append({"t": tc["t"], "s": tc.get("s", ""), "f": 1})
    try:
        yield tc
    finally:
        st.pop()


def propagate_enabled() -> bool:
    """Resolved propagation-switch state (cached after the first read);
    implies the obs kill switch is on."""
    global _propagate
    if _propagate is None:
        v = env_truthy(PROP_SWITCH)
        _propagate = False if v is None else v
    return _propagate and core.enabled()


def set_propagate(on: bool | None):
    """Override the propagation switch (tests / tools), or re-read the
    env with ``None``."""
    global _propagate
    _propagate = on


_profiler_on = None       # torch.autograd._profiler_enabled, once loaded


def _profiler_range(name: str):
    """An entered ``record_function`` range named ``name`` while a torch
    profiler records, else ``None``."""
    global _profiler_on
    try:
        if _profiler_on is None:
            if "torch" not in sys.modules:
                return None
            _profiler_on = sys.modules["torch"].autograd._profiler_enabled
        if not _profiler_on():
            return None
        ann = sys.modules["torch"].profiler.record_function(name)
        ann.__enter__()
        return ann
    except Exception:
        return None


class _Span:
    """One timed region; after the block, ``dur`` holds its seconds."""

    __slots__ = ("name", "labels", "dur", "_t0", "_start", "_ann", "_tc")

    def __init__(self, name: str, labels: dict):
        self.name = name
        self.labels = labels
        self.dur = None
        self._ann = None
        self._tc = None

    def __enter__(self):
        st = _stack()
        if st:
            parent = st[-1]
            sid = _gen_id(4)
            self._tc = (parent["t"], sid, parent["s"])
            st.append({"t": parent["t"], "s": sid, "f": 1})
        if bridge_torch:
            self._ann = _profiler_range(self.name)
        self._start = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur = dur = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:
                pass
        rec = {"type": "span", "name": self.name, "ts": time.time(),
               "dur": dur, "start": self._start}
        if self.labels:
            rec["labels"] = self.labels
        if exc_type is not None:
            rec["err"] = exc_type.__name__
        if self._tc is not None:
            _stack().pop()
            t, sid, parent = self._tc
            rec["trace"], rec["span"] = t, sid
            if parent:
                rec["parent"] = parent
        _record(rec)
        return False


class _NullSpan:
    """Shared disabled-path span: no timing, no record, reusable."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def span(name: str, **labels):
    """Context manager timing one region.  Labels become the span's
    ``labels`` dict in the JSONL record; exceptions are recorded as an
    ``err`` field and re-raised.  Under an active trace context the
    record also carries ``trace``/``span``/``parent`` ids and the span
    becomes the context for anything nested in the block."""
    if not core.enabled():
        return NULL_SPAN
    return _Span(name, labels)


def record_span(name: str, dur: float, **labels):
    """Record a span whose duration was measured by the caller.

    For intervals that don't map to one ``with`` block — e.g. a serving
    request's time-to-first-token spans submit → first stream frame
    across scheduler and engine code that never holds both endpoints.
    The record shape matches :class:`_Span` so trail consumers
    (``tools/diststat.py``) need no special case; an active trace
    context stamps it the same way."""
    if not core.enabled():
        return
    ts = time.time()
    rec = {"type": "span", "name": name, "ts": ts, "dur": float(dur),
           "start": ts - float(dur)}
    if labels:
        rec["labels"] = labels
    cur = current()
    if cur is not None:
        rec["trace"], rec["span"] = cur["t"], _gen_id(4)
        if cur["s"]:
            rec["parent"] = cur["s"]
    _record(rec)


def traced(name: str | None = None):
    """Decorator form: ``@traced()`` uses the function's qualname."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapped(*a, **kw):
            with span(label):
                return fn(*a, **kw)

        return wrapped

    return deco
