"""Fault-tolerant serving fleet router — counterpart of
``distlearn_tpu/serve/router.py``: health-routed dispatch over N
:class:`~distlearn_tpu_torch.serve.server.ServeServer` replicas (the
'G', 'R' and 'J' frames are byte-compatible with the JAX package's, so a
router of either package fronts replicas of either).

Shared-nothing by construction: a :class:`Router` is a client-side
library object holding nothing but a dial list and a health cache, so
any number of router instances front the same fleet without
coordination — the HA design (docs/HA.md) applied to serving.  One
request's lifecycle:

1. **Dispatch** — pick the least-loaded live replica
   (``queue_depth + active`` from its '/healthz'-over-'J' snapshot,
   cached ``health_ttl`` seconds), open a fresh connection, send the
   'G' frame.  Streams are sticky: chunks for a request only ever come
   from the replica that admitted it.
2. **Shed** — before dispatch, aggregate queue depth across live
   replicas; at or past ``shed_watermark`` the router refuses with
   :class:`RouterBusy` carrying a ``retry_after`` hint instead of
   letting the request time out in a queue (graceful degradation).
3. **Retry on death** — a replica that dies before producing the
   request's first token (dial failure, FIN/reset, i.e. the request was
   queued-not-yet-prefilled) is safe to retry: the router resubmits to
   a survivor with exponential backoff + full jitter (the
   ``transport.connect`` policy), at most once per replica.  A death
   AFTER tokens flowed cannot be retried without duplicating output —
   the caller gets a clean terminal ``reason="failed"`` result with the
   partial tokens instead of a hang.
4. **Hedge** — a request stuck with no first token for ``hedge_after``
   seconds (deadline-aware: never later than half its own
   ``deadline_s``) behind a sick-but-alive replica is cancelled there
   (closing the connection cancels the queued copy server-side — this
   is what keeps execution at-most-once per replica) and resubmitted to
   the next-best untried replica.
5. **Epoch fence** — every 'R' chunk echoes the replica's center epoch
   (hot weight swap, ``serve.server``).  The first chunk pins the
   stream's epoch; a later chunk with a different value is a fence
   violation and the stream is terminated (``reason="failed"``) rather
   than splicing two model versions into one completion.

The dispatch/retry/shed/fence state machine is the JAX package's, which
model-checks it in ``distlearn_tpu/lint/model.py`` (``router_model``:
deadlock-free, at-most-once per replica, fence holds); this copy keeps
every transition unchanged.
"""

from __future__ import annotations

import random
import threading
import time

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import transport
from distlearn_tpu_torch.comm.errors import PeerClosed
from distlearn_tpu_torch.obs import trace as obs_trace
from distlearn_tpu_torch.serve.client import ReplicaDead, ServeError

#: same decades as the server's TTFT/TPOT buckets — failover and hedge
#: recoveries land in the same 1ms..10s range.
_LAT_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
                1.0, 2.5, 5.0, 10.0)


class RouterBusy(ServeError):
    """Router-level admission control: the fleet's aggregate queue is
    past the watermark (or every replica shed) — retry after
    ``retry_after`` seconds."""


class _Replica:
    """One fleet member: address, cached health, down-backoff state and
    the persistent probe connection (streams use their own)."""

    __slots__ = ("host", "port", "name", "conn", "health", "polled",
                 "down_until", "fails")

    def __init__(self, host: str, port: int):
        self.host, self.port = host, int(port)
        self.name = f"{host}:{port}"
        self.conn = None
        self.health = None          # last snapshot, None when unreachable
        self.polled = 0.0           # clock() of last probe
        self.down_until = 0.0       # no dials/probes before this
        self.fails = 0              # consecutive probe failures

    def score(self):
        """Load for least-loaded dispatch: waiting + decoding."""
        h = self.health or {}
        return int(h.get("queue_depth", 0)) + int(h.get("active", 0))


class Router:
    def __init__(self, replicas, *, shed_watermark: int | None = None,
                 health_ttl: float = 0.25, dial_deadline: float = 2.0,
                 probe_timeout: float = 2.0, retry_interval: float = 0.05,
                 max_interval: float = 2.0, max_attempts: int = 10,
                 hedge_after: float | None = None, export_health: bool = False,
                 clock=time.monotonic, sleep=time.sleep):
        """``replicas`` is a list of ``(host, port)``.  ``hedge_after``
        of ``None`` disables hedging; ``shed_watermark`` of ``None``
        disables router-level shedding (replica-level ``QueueFull``
        still sheds).  ``export_health`` wires :meth:`health` into the
        obs '/healthz' exporter — leave off when a server in the same
        process already owns it."""
        if not replicas:
            raise ValueError("router needs at least one replica")
        self._replicas = [_Replica(h, p) for h, p in replicas]
        if len({r.name for r in self._replicas}) != len(self._replicas):
            raise ValueError("duplicate replica address")
        self.shed_watermark = shed_watermark
        self.health_ttl = float(health_ttl)
        self.dial_deadline = float(dial_deadline)
        self.probe_timeout = float(probe_timeout)
        self.retry_interval = float(retry_interval)
        self.max_interval = float(max_interval)
        self.max_attempts = int(max_attempts)
        self.hedge_after = hedge_after
        self._clock = clock
        self._sleep = sleep
        self._lock = threading.Lock()    # health cache + probe conns
        self._c_dispatch = obs.counter(
            "router_dispatch_total", "requests dispatched, per replica",
            labels=("replica",))
        self._c_retry = obs.counter(
            "router_retries_total",
            "queued-not-prefilled resubmissions, per failed replica",
            labels=("replica",))
        self._c_shed = obs.counter(
            "router_shed_total", "requests shed by router admission control")
        self._c_hedge = obs.counter(
            "router_hedges_total",
            "hedged resubmissions, per replica hedged away from",
            labels=("replica",))
        self._c_fence = obs.counter(
            "router_fence_violations_total",
            "streams terminated for observing two center epochs")
        self._h_failover = obs.histogram(
            "router_failover_seconds",
            "replica death/timeout to first token on a survivor",
            buckets=_LAT_BUCKETS)
        self._h_hedge = obs.histogram(
            "router_hedge_seconds",
            "hedge fire to first token on the hedged replica",
            buckets=_LAT_BUCKETS)
        self._g_live = obs.gauge(
            "router_replicas_live", "replicas serving per last probe")
        self._g_rq = obs.gauge(
            "router_replica_queue_depth", "per-replica queue depth",
            labels=("replica",))
        self._g_up = obs.gauge(
            "router_replica_up", "1 when the replica answered its last probe",
            labels=("replica",))
        if export_health:
            obs.set_health_source(self.health)

    # -- health cache -------------------------------------------------------
    def _probe(self, rep: _Replica, now: float):
        try:
            if rep.conn is None:
                rep.conn = transport.connect(
                    rep.host, rep.port, retries=1,
                    deadline_s=self.dial_deadline)
            rep.conn.send_msg({"q": "stats"})
            rep.health = rep.conn.recv_msg(
                deadline=now + self.probe_timeout)
            rep.fails = 0
            rep.down_until = 0.0
        except (OSError, transport.ProtocolError, ValueError):
            if rep.conn is not None:
                rep.conn.close()
                rep.conn = None
            rep.health = None
            rep.fails += 1
            # full-jitter backoff on the probe, the transport.connect
            # policy: down replicas get cheaper to skip, not hammered.
            cap = min(self.max_interval,
                      self.retry_interval * (2 ** (rep.fails - 1)))
            rep.down_until = now + random.uniform(0.0, cap)
        rep.polled = now

    def _refresh(self, now: float, force: bool = False):
        with self._lock:
            for rep in self._replicas:
                due = force or now - rep.polled >= self.health_ttl
                if due and now >= rep.down_until:
                    self._probe(rep, now)
                self._g_rq.labels(replica=rep.name).set(
                    (rep.health or {}).get("queue_depth", 0))
                self._g_up.labels(replica=rep.name).set(
                    1 if rep.health is not None else 0)
            self._g_live.set(sum(1 for r in self._replicas
                                 if self._live(r, now)))

    @staticmethod
    def _live(rep: _Replica, now: float) -> bool:
        h = rep.health
        return (h is not None and bool(h.get("serving"))
                and not h.get("failed") and not h.get("draining")
                and now >= rep.down_until)

    def _pick(self, tried: set, now: float):
        """Least-loaded live replica not yet tried for this request."""
        with self._lock:
            live = [r for r in self._replicas
                    if r.name not in tried and self._live(r, now)]
            return min(live, key=_Replica.score) if live else None

    def _has_alternative(self, tried: set) -> bool:
        now = self._clock()
        with self._lock:
            return any(r.name not in tried and self._live(r, now)
                       for r in self._replicas)

    # -- fleet introspection ------------------------------------------------
    def health(self) -> dict:
        """Aggregate fleet snapshot (a '/healthz' source: the fleet is
        serving while ANY replica is)."""
        now = self._clock()
        self._refresh(now)
        reps = []
        with self._lock:
            for r in self._replicas:
                reps.append({"replica": r.name,
                             "up": r.health is not None,
                             "live": self._live(r, now),
                             **{k: (r.health or {}).get(k)
                                for k in ("queue_depth", "active",
                                          "draining", "epoch")}})
        live = [r for r in reps if r["live"]]
        return {"serving": bool(live),
                "replicas": reps,
                "live": len(live),
                "queue_depth": sum(r["queue_depth"] or 0 for r in live),
                "active": sum(r["active"] or 0 for r in live),
                "epochs": sorted({r["epoch"] for r in live
                                  if r["epoch"] is not None})}

    # -- dynamic membership (the autoscaler's actuation surface) ------------
    def add_replica(self, host: str, port: int) -> str:
        """Grow the fleet in place: the new member is probed on the next
        refresh and picks up dispatch as soon as it answers live.
        Idempotent on an address already present.  Returns the replica
        name (``host:port``)."""
        rep = _Replica(host, int(port))
        with self._lock:
            if all(r.name != rep.name for r in self._replicas):
                # copy-on-write: generate()'s lock-free availability scan
                # only ever sees a complete list
                self._replicas = self._replicas + [rep]
        return rep.name

    def remove_replica(self, name: str) -> bool:
        """Retire one member by name.  New dispatch stops immediately;
        streams already running against it finish on their own
        connections.  Refuses to empty the fleet (the constructor
        invariant); returns False for an unknown name."""
        with self._lock:
            gone = [r for r in self._replicas if r.name == name]
            if not gone:
                return False
            keep = [r for r in self._replicas if r.name != name]
            if not keep:
                raise ValueError("cannot remove the last replica")
            self._replicas = keep
        for r in gone:
            if r.conn is not None:
                r.conn.close()
        return True

    def replica_names(self) -> list[str]:
        with self._lock:
            return [r.name for r in self._replicas]

    # -- admission control --------------------------------------------------
    def _check_shed(self, now: float):
        if self.shed_watermark is None:
            return
        with self._lock:
            agg = sum(r.score() for r in self._replicas
                      if self._live(r, now))
        if agg >= self.shed_watermark:
            self._c_shed.inc()
            hint = min(5.0, max(0.05, 0.05 * agg))
            raise RouterBusy(
                f"fleet queue depth {agg} at/over watermark "
                f"{self.shed_watermark}", retry_after=hint,
                queue_depth=agg)

    # -- the request path ---------------------------------------------------
    def generate(self, prompt, max_new: int, *, rid: str | None = None,
                 deadline_s: float | None = None, eos: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, speculate: bool = True,
                 timeout: float = 60.0, on_chunk=None) -> dict:
        """Run one request against the fleet.  Returns ``{"rid",
        "tokens", "reason", "epoch", "replica", "accepted",
        "cached_tokens"}``; ``reason`` is ``"failed"`` (with an
        ``"error"`` note and the partial tokens) when the owning replica
        died mid-stream or fenced.  Sampling knobs travel on the 'G'
        frame (``temperature == 0`` is exact greedy; ``seed`` makes a
        sampled stream reproducible); ``speculate=False`` opts a greedy
        stream out of speculative decoding.  Raises
        :class:`RouterBusy` on shed, :class:`ReplicaDead` when every
        replica was tried or attempts ran out, :class:`ServeError` on a
        non-retryable rejection, ``TimeoutError`` past ``timeout``."""
        kw = dict(rid=rid, deadline_s=deadline_s, eos=eos,
                  temperature=temperature, top_k=top_k, top_p=top_p,
                  seed=seed, speculate=speculate, timeout=timeout,
                  on_chunk=on_chunk)
        if not obs_trace.propagate_enabled():
            return self._generate(prompt, max_new, **kw)
        # one trace per request: this root span is the parent the
        # replica's scheduler/engine spans stitch to (the 'G' frame
        # carries the context) along with the failover/hedge spans here
        with obs_trace.use_context(obs_trace.new_trace()), \
                obs.span("router.generate", rid=rid or ""):
            return self._generate(prompt, max_new, **kw)

    def _generate(self, prompt, max_new: int, *, rid, deadline_s, eos,
                  temperature, top_k, top_p, seed, speculate,
                  timeout, on_chunk) -> dict:
        start = self._clock()
        overall = start + float(timeout)
        self._refresh(start)
        self._check_shed(start)
        msg = {"prompt": [int(t) for t in prompt], "max_new": int(max_new)}
        tc = obs_trace.wire_context()
        if tc is not None:
            msg[obs_trace.TRACE_KEY] = tc
        if rid is not None:
            msg["rid"] = rid
        if deadline_s is not None:
            msg["deadline_s"] = float(deadline_s)
        if eos is not None:
            msg["eos"] = int(eos)
        # sampling fields ride only when non-default, so the plain
        # greedy 'G' frame stays byte-identical to the pre-sampling wire
        if temperature:
            msg["temperature"] = float(temperature)
        if top_k:
            msg["top_k"] = int(top_k)
        if top_p:
            msg["top_p"] = float(top_p)
        if seed:
            msg["seed"] = int(seed)
        if not speculate:
            msg["speculate"] = False
        hedge_after = self.hedge_after
        if hedge_after is not None and deadline_s is not None:
            hedge_after = min(hedge_after, 0.5 * float(deadline_s))
        tried: set[str] = set()
        shed_hints: list[float] = []
        failover_t0 = hedge_t0 = None
        waits = 0
        while True:
            now = self._clock()
            if now >= overall:
                raise TimeoutError(f"no replica completed the request "
                                   f"within {timeout}s")
            rep = self._pick(tried, now)
            if rep is None:
                if not any(r.name not in tried for r in self._replicas):
                    if shed_hints:
                        self._c_shed.inc()
                        raise RouterBusy("every replica shed the request",
                                         retry_after=max(shed_hints))
                    raise ReplicaDead(
                        f"all {len(self._replicas)} replicas tried and "
                        "dead — no survivor to resubmit to")
                waits += 1
                if waits > self.max_attempts:
                    raise ReplicaDead(
                        f"no live replica after {waits - 1} waits")
                cap = min(self.max_interval,
                          self.retry_interval * (2 ** (waits - 1)))
                self._sleep(random.uniform(0.0, cap))
                self._refresh(self._clock(), force=True)
                continue
            tried.add(rep.name)
            self._c_dispatch.labels(replica=rep.name).inc()
            hedge_at = (None if hedge_after is None
                        else self._clock() + hedge_after)
            status, payload = self._run_stream(
                rep, msg, rid, overall, hedge_at, on_chunk, tried,
                failover_t0, hedge_t0)
            if status == "done":
                return payload
            if status == "dead":
                # queued-not-yet-prefilled on a dead replica: safe to
                # resubmit — backoff with full jitter, walk survivors.
                self._c_retry.labels(replica=rep.name).inc()
                failover_t0 = failover_t0 or self._clock()
                with self._lock:
                    rep.health = None
                    rep.fails += 1
                    rep.down_until = self._clock() + random.uniform(
                        0.0, min(self.max_interval,
                                 self.retry_interval * (2 ** rep.fails)))
                self._sleep(random.uniform(0.0, min(
                    self.max_interval,
                    self.retry_interval * (2 ** len(tried)))))
                self._refresh(self._clock(), force=True)
                continue
            if status == "hedge":
                self._c_hedge.labels(replica=rep.name).inc()
                hedge_t0 = self._clock()
                continue                # no sleep: hedging chases latency
            if status == "rejected":
                chunk = payload
                if chunk.get("retry_after") is None:
                    # not load: the request itself is bad (too long,
                    # duplicate rid) — every replica would say the same.
                    raise ServeError(chunk.get("error", "rejected"),
                                     queue_depth=chunk.get("queue_depth"))
                shed_hints.append(float(chunk["retry_after"]))
                continue                # shed here; try the next replica
            # "failed" / "fence": tokens already flowed — resubmitting
            # would duplicate output.  Clean terminal instead of a hang.
            tokens, epoch, err = payload
            return {"rid": rid, "tokens": tokens, "reason": "failed",
                    "error": err, "epoch": epoch, "replica": rep.name,
                    "accepted": 0, "cached_tokens": 0}

    def _run_stream(self, rep: _Replica, msg: dict, rid: str | None,
                    overall: float, hedge_at: float | None, on_chunk,
                    tried: set, failover_t0, hedge_t0):
        """One sticky stream against one replica.  Returns
        ``(status, payload)``: ``done``/``dead``/``failed``/``hedge``/
        ``rejected`` (see :meth:`generate`)."""
        try:
            conn = transport.connect(rep.host, rep.port, retries=1,
                                     deadline_s=self.dial_deadline)
        except ConnectionError as e:
            return "dead", e
        tokens: list[int] = []
        epoch = None
        first_seen = False
        accepted = 0            # speculative drafts the replica accepted
        cached = 0              # prompt tokens served from its prefix cache
        try:
            conn.send_gen(msg)
        except OSError as e:
            conn.close()
            return "dead", e
        while True:
            now = self._clock()
            if now >= overall:
                conn.close()            # cancels the server-side copy
                raise TimeoutError(
                    f"stream on {rep.name} exceeded its budget "
                    f"({len(tokens)} token(s) in)")
            deadline = overall
            if not first_seen and hedge_at is not None:
                deadline = min(deadline, hedge_at)
            try:
                kind, chunk = conn.recv_serve(deadline=deadline)
            except TimeoutError:
                if not first_seen and hedge_at is not None:
                    if self._has_alternative(tried):
                        # cancel the queued copy before re-dispatching:
                        # dropping the conn cancels it server-side, so
                        # execution stays at-most-once per replica.
                        conn.close()
                        return "hedge", tokens
                    hedge_at = None     # nobody to hedge to: disarm
                continue
            except (PeerClosed, ConnectionResetError,
                    BrokenPipeError) as e:
                conn.close()
                if first_seen:
                    return "failed", (tokens, epoch,
                                      f"replica died mid-stream: {e!r}")
                return "dead", e
            if kind != "R":
                conn.close()
                raise transport.ProtocolError(
                    f"expected stream chunk, got kind {kind!r}")
            if rid is not None and chunk.get("rid") not in (rid, ""):
                continue
            ep = chunk.get("epoch")
            if ep is not None:
                if epoch is None:
                    epoch = ep
                elif ep != epoch:
                    self._c_fence.inc()
                    conn.close()
                    return "failed", (tokens, epoch,
                                      f"epoch fence: chunk epoch {ep} "
                                      f"after stream pinned {epoch}")
            if chunk.get("error"):
                conn.close()
                return "rejected", chunk
            if chunk.get("accepted"):
                accepted += int(chunk["accepted"])
            if chunk.get("cached_tokens"):
                cached = int(chunk["cached_tokens"])
            got = chunk.get("tokens") or []
            if got:
                if not first_seen:
                    first_seen = True
                    if failover_t0 is not None:
                        d = self._clock() - failover_t0
                        self._h_failover.observe(d)
                        obs.record_span("router.failover", d,
                                        replica=rep.name)
                    if hedge_t0 is not None:
                        d = self._clock() - hedge_t0
                        self._h_hedge.observe(d)
                        obs.record_span("router.hedge", d,
                                        replica=rep.name)
                tokens.extend(int(t) for t in got)
                if on_chunk is not None:
                    on_chunk(got)
            if chunk.get("done"):
                reason = chunk.get("reason", "complete")
                conn.close()
                if reason not in ("complete", "eos"):
                    raise ServeError(f"request ended: {reason}")
                return "done", {"rid": chunk.get("rid"), "tokens": tokens,
                                "reason": reason, "epoch": epoch,
                                "replica": rep.name, "accepted": accepted,
                                "cached_tokens": cached}

    def close(self):
        with self._lock:
            for rep in self._replicas:
                if rep.conn is not None:
                    rep.conn.close()
                    rep.conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
