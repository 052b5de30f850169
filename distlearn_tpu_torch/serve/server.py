"""Decode service front-end: transport loop, telemetry, graceful drain —
a copy of ``distlearn_tpu/serve/server.py`` over the port's engine,
scheduler, transport, obs and checkpoints (the JAX package's
``ha.restore_center`` is the small :func:`restore_center` here).

Wires the three serving layers to the rest of the repo:

* **Wire**: accepts connections on a ``comm.transport.Server`` and
  speaks the serving frames — ``'G'`` in (generate request JSON),
  ``'R'`` out (one token-stream chunk per scheduling round, ``done``
  flag on the last).  A ``'J'`` control frame answers with a stats
  snapshot, so health probes share the port.
* **Telemetry**: ``serve_queue_depth`` / ``serve_active_slots`` gauges,
  ``serve_ttft_seconds`` / ``serve_tpot_seconds`` histograms (with
  matching ``serve.ttft`` / ``serve.tpot`` spans in the JSONL trail for
  ``tools/diststat.py`` percentiles), ``serve_requests_total{outcome}``
  and ``serve_tokens_total`` counters, and a ``/healthz`` source for the
  existing obs export thread.
* **Drain**: :meth:`ServeServer.checkpoint_now` implements the
  ``ha.install_signal_flush`` contract — on SIGTERM the handler stops
  admissions, lets in-flight requests decode to completion (bounded by
  ``drain_timeout``), then lets the signal's prior disposition run.  No
  new flush machinery: serving reuses the HA hook verbatim.
* **Hot swap**: with ``ckpt_dir`` set, a :class:`WeightTailer` tails the
  training center's checkpoint directory (the ``ha.StandbyCenter``
  watch pattern, serving side) and the loop swaps params between ticks
  — epoch-fenced: admissions hold while old-epoch streams drain, then
  the new weights install atomically, so no stream ever observes two
  center epochs.  The serving epoch rides ``/healthz`` and every 'R'
  chunk, which is what ``serve.router`` asserts on.

The request loop runs in ONE thread (foreground ``serve_forever`` or
background ``start``): sockets are select-ed, the scheduler steps, and
events fan out to clients.  Reads never block — frames reassemble
per-connection from whatever bytes are available
(``Conn.recv_serve_nowait``), so a peer that half-sends a frame cannot
head-of-line block the decode loop; ``frame_timeout`` bounds how long a
partial frame may linger before the trickler is dropped.  A client that
disconnects mid-stream is detected on the failed send and its request
cancelled — its slot frees on the next round, never leaking pages.
"""

from __future__ import annotations

import select
import threading
import time
import traceback

import numpy as np

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.comm import transport
from distlearn_tpu_torch.comm.transport import ProtocolError
from distlearn_tpu_torch.obs import trace as obs_trace
from distlearn_tpu_torch.serve.engine import DecodeEngine
from distlearn_tpu_torch.serve.prefix_cache import RadixPrefixCache
from distlearn_tpu_torch.serve.scheduler import QueueFull, Scheduler
from distlearn_tpu_torch.serve.speculate import NGramDrafter
from distlearn_tpu_torch.utils.checkpoint import latest_step, restore_checkpoint
from distlearn_tpu_torch.utils.logging import print_server
from distlearn_tpu_torch.utils.tree import tree_flatten, tree_unflatten

#: TTFT/TPOT buckets (seconds): wider than the wire-latency default —
#: a prefill at batch-1 on CPU lands in the 10ms..1s decades.
_LAT_BUCKETS = (.0005, .001, .0025, .005, .01, .025, .05, .1, .25, .5,
                1.0, 2.5, 5.0, 10.0)


def restore_center(directory: str, like, step: int | None = None):
    """Restore an AsyncEA center checkpoint (``{"center": {"<i>": leaf}}``,
    the layout the training center writes) into the structure of ``like``;
    returns ``(tree, metadata)``."""
    leaves, treedef = tree_flatten(like)
    tree, meta = restore_checkpoint(
        directory, {"center": {str(i): leaf for i, leaf in enumerate(leaves)}},
        step=step)
    return tree_unflatten(treedef, [tree["center"][str(i)]
                                    for i in range(len(leaves))]), meta


def load_weights(directory: str, like, step: int | None = None):
    """``(tree, metadata)`` of a checkpoint in either layout the repo
    writes: params-shaped (``save_checkpoint(dir, step, params)``), else
    the HA center layout (:func:`restore_center`)."""
    try:
        return restore_checkpoint(directory, like, step=step)
    except (KeyError, ValueError):
        return restore_center(directory, like, step=step)


class WeightTailer:
    """Tail a checkpoint directory for new weights to serve — the
    ``ha.StandbyCenter`` watch-probe pattern pointed at serving instead
    of promotion.  :meth:`maybe_load` is polled from the request loop;
    at most one ``latest_step`` stat per ``poll`` seconds, and a load
    only when an unseen step appears.

    Both tree layouts the repo writes are accepted: params-shaped
    checkpoints (``save_checkpoint(dir, step, params)``) and the HA
    center layout ``{"center": {"<i>": leaf}}`` that the training
    center's ``_checkpoint_locked`` produces (tried second, via
    :func:`restore_center`)."""

    def __init__(self, directory: str, like, *, poll: float = 0.25):
        self.directory = str(directory)
        self.like = like
        self.poll = float(poll)
        self._last_step: int | None = None
        self._warned_step: int | None = None
        self._next_poll = 0.0

    def poll_step(self) -> int | None:
        return latest_step(self.directory)

    @property
    def step(self) -> int | None:
        """The step of the last tree :meth:`maybe_load` returned."""
        return self._last_step

    def maybe_load(self, now: float):
        """``(params, meta)`` for an unseen newest step, else ``None``.
        A torn or foreign file is skipped (warned once) and re-tried
        next poll — a checkpoint racing its own rename completes soon."""
        if now < self._next_poll:
            return None
        self._next_poll = now + self.poll
        step = self.poll_step()
        if step is None or step == self._last_step:
            return None
        try:
            tree, meta = self._restore(step)
        except (OSError, KeyError, ValueError) as e:
            if step != self._warned_step:
                self._warned_step = step
                print_server(f"weight tailer: step {step} unreadable, "
                             f"will retry: {e!r}")
            return None
        self._last_step = step
        return tree, meta

    def _restore(self, step: int):
        return load_weights(self.directory, self.like, step)


class ServeServer:
    def __init__(self, engine: DecodeEngine, *, host: str = "127.0.0.1",
                 port: int = 0, max_queue: int = 32,
                 default_max_new: int = 32, frame_timeout: float = 5.0,
                 idle_wait: float = 0.05, drain_timeout: float = 30.0,
                 ckpt_dir: str | None = None, ckpt_poll: float = 0.25,
                 ckpt_like=None, epoch: int | None = None,
                 prefix_cache: bool = False, spec_k: int | None = None,
                 prefill_chunk: int | None = None):
        """``engine`` is a single-rank engine or a tensor-parallel engine's
        leader (its followers run ``engine.follow()``; :meth:`stop` and the
        end of the request loop stop them).

        Raw-speed knobs (all default OFF — the plain serve path stays
        byte-identical): ``prefix_cache`` retains finished prompts' K/V
        pages in a :class:`RadixPrefixCache` so shared-prefix traffic
        prefills only its suffix; ``spec_k`` enables n-gram speculative
        decoding with that many draft tokens per verify; ``prefill_chunk``
        bounds prompt positions prefilled per round while streams decode
        (chunked prefill — long prompts stop stalling TPOT)."""
        if not engine.is_leader:
            raise ValueError("a tensor-parallel engine serves from its "
                             "leader; the other ranks run follow()")
        self.engine = engine
        self.prefix_cache = (RadixPrefixCache(engine.cache)
                             if prefix_cache else None)
        self.sched = Scheduler(
            engine, max_queue=max_queue, prefix_cache=self.prefix_cache,
            drafter=NGramDrafter(k=spec_k) if spec_k else None,
            prefill_chunk=prefill_chunk)
        self.default_max_new = int(default_max_new)
        self.frame_timeout = float(frame_timeout)
        self.idle_wait = float(idle_wait)
        self.drain_timeout = float(drain_timeout)
        self._lst = transport.Server(host, port)
        self.host, self.port = self._lst.host, self._lst.port
        self._conn_of: dict[str, transport.Conn] = {}   # rid -> client conn
        self._t_submit: dict[str, float] = {}           # rid -> perf_counter
        self._tc_of: dict[str, dict] = {}               # rid -> trace ctx
        self._t_last: dict[str, float] = {}             # rid -> last token t
        self._rx_since: dict[transport.Conn, float] = {}  # partial-frame age
        self._failed: str | None = None                 # loop death, if any
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._draining = False
        self._thread: threading.Thread | None = None
        self._g_queue = obs.gauge(
            "serve_queue_depth", "requests waiting for a decode slot")
        self._g_active = obs.gauge(
            "serve_active_slots", "requests currently decoding")
        self._h_ttft = obs.histogram(
            "serve_ttft_seconds",
            "time-to-first-token: 'G' frame decoded to first 'R' sent",
            buckets=_LAT_BUCKETS)
        self._h_tpot = obs.histogram(
            "serve_tpot_seconds",
            "per-output-token latency after the first token",
            buckets=_LAT_BUCKETS)
        self._c_reqs = obs.counter(
            "serve_requests_total", "requests by terminal outcome",
            labels=("outcome",))
        self._c_toks = obs.counter(
            "serve_tokens_total", "tokens streamed to clients")
        #: epoch of the params being served (None until known); bumped
        #: by the tailer from checkpoint metadata ("epoch" key, falling
        #: back to the step for plain params checkpoints).  epoch /
        #: ckpt_step / _swap_pending are written only by the serve loop;
        #: health() readers on other threads take GIL-atomic snapshots
        #: of int/tuple attributes — a probe racing a swap sees either
        #: epoch, both valid ("telemetry tolerates a torn view").
        self.epoch = epoch
        self.ckpt_step: int | None = None
        # the whole tree's shapes (a tp engine holds only its shard)
        self._tailer = (WeightTailer(ckpt_dir,
                                     engine.template if ckpt_like is None
                                     else ckpt_like, poll=ckpt_poll)
                        if ckpt_dir else None)
        self._swap_pending: tuple | None = None   # (params, meta) loaded
        self._c_swaps = obs.counter(
            "serve_weight_swaps_total",
            "hot weight swaps applied between ticks")
        self._g_epoch = obs.gauge(
            "serve_center_epoch", "center epoch of the params being served")
        if epoch is not None:
            self._g_epoch.set(epoch)
        obs.set_health_source(self.health)

    # -- health / introspection --------------------------------------------
    def health(self) -> dict:
        return {"serving": not self._stop.is_set(),
                "failed": self._failed,
                "draining": self._draining,
                "queue_depth": self.sched.queue_depth(),
                "active": self.sched.active_count(),
                "free_pages": self.engine.cache.free_pages(),
                "cached_pages": (self.prefix_cache.pages_held
                                 if self.prefix_cache is not None else 0),
                "epoch": self.epoch,
                "ckpt_step": self.ckpt_step,
                "swap_pending": self._swap_pending is not None}

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServeServer":
        """Run the request loop in a background thread (so the main
        thread stays free for signal handlers — the signal module only
        delivers to the main thread)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        name="serve-loop", daemon=True)
        self._thread.start()
        return self

    def checkpoint_now(self, wait: bool = True):
        """Graceful drain under the ``ha.install_signal_flush`` name:
        the serving analogue of "write one last durable checkpoint" is
        "finish every admitted request".  Stops admissions immediately;
        with ``wait`` blocks until in-flight requests complete (or
        ``drain_timeout`` passes), then stops the loop."""
        self._draining = True
        if wait:
            self._drained.wait(self.drain_timeout)
        self._stop.set()

    def stop(self):
        """Immediate shutdown: stop the loop, close every socket.  Safe
        to call twice and after ``checkpoint_now``."""
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(10.0)
        self._thread = None
        self._stop_followers()
        self._lst.close()
        self._g_queue.set(0)
        self._g_active.set(0)

    def _stop_followers(self):
        """End a tp engine's followers (once: the loop's exit and
        :meth:`stop` both call this); a dead channel is reported, not
        raised."""
        try:
            self.engine.stop()
        except Exception as e:  # noqa: BLE001 — followers already gone
            print_server(f"stopping the engine's followers failed: {e!r}")

    # -- request loop -------------------------------------------------------
    def serve_forever(self):
        try:
            while not self._stop.is_set():
                try:
                    self._poll_io()
                    self._maybe_swap()
                    events = self.sched.step()
                    self._dispatch(events)
                    self._g_queue.set(self.sched.queue_depth())
                    self._g_active.set(self.sched.active_count())
                    if self._draining and self.sched.idle():
                        self._drained.set()
                        break
                except Exception as e:  # noqa: BLE001 — death must be seen
                    # an unexpected scheduler/engine error must not kill
                    # this thread silently while health() keeps saying
                    # serving=True and clients hang to their timeouts:
                    # record it, flip health, fail the clients fast.
                    self._failed = repr(e)
                    print_server("serve loop died:",
                                 traceback.format_exc())
                    self._stop.set()
                    for c in list(self._lst.conns):
                        c.close()
        finally:
            self._stop_followers()
            self._drained.set()
            self._g_queue.set(0)
            self._g_active.set(0)

    def _maybe_swap(self):
        """Epoch-fenced hot weight swap, between ticks.  Two phases: on
        a new checkpoint, raise the admissions hold (queued requests
        wait, nothing new prefills); once the active set drains, install
        the new params and release the hold.  In-flight streams thus
        finish entirely under their admission epoch and every stream
        admitted after the swap runs entirely under the new one — no
        stream ever observes two epochs (the 'R'-chunk echo that
        ``serve.router`` fences on).  The wait is bounded by the longest
        in-flight ``max_new`` budget, never a queue's worth."""
        if self._tailer is None:
            return
        if self._swap_pending is None:
            got = self._tailer.maybe_load(time.monotonic())
            if got is None:
                return
            self._swap_pending = got
            self.sched.hold = True
        if self.sched.active_count():
            return                      # old-epoch streams still decoding
        tree, meta = self._swap_pending
        self._swap_pending = None
        self.sched.hold = False
        try:
            # under tp each follower reads the same checkpoint itself
            self.engine.swap_params(
                tree, source=(self._tailer.directory, self._tailer.step))
        except ValueError as e:
            # layout drift (wrong depth/shape): refuse the swap, keep
            # serving the old weights — availability over freshness (and
            # the prefix cache stays valid: the old params still serve).
            print_server(f"hot swap refused: {e}")
            return
        if self.prefix_cache is not None:
            # every cached K/V page was computed under the outgoing
            # epoch: a new-epoch stream matching one would splice stale
            # attention state into its prefix.  Invalidate before any
            # post-swap admission can run.
            stale = self.prefix_cache.clear()
            if stale:
                print_server(f"prefix cache invalidated across epoch "
                             f"fence ({stale} pages)")
        self.ckpt_step = meta.get("step")
        self.epoch = int(meta.get("epoch", self.ckpt_step or 0))
        self._c_swaps.inc()
        self._g_epoch.set(self.epoch)
        print_server(f"hot-swapped params (step {self.ckpt_step}, "
                     f"epoch {self.epoch})")

    def _poll_io(self):
        self._lst.prune_closed()
        socks = {self._lst.sock: None}
        for c in self._lst.conns:
            socks[c.sock] = c
        # busy (requests decoding) -> poll without blocking between
        # ticks; idle -> sleep in select until a frame or stop.
        wait = 0.0 if not self.sched.idle() else self.idle_wait
        try:
            ready, _, _ = select.select(list(socks), [], [], wait)
        except OSError:      # a peer closed between prune and select
            return
        for sock in ready:
            conn = socks[sock]
            if conn is None:
                try:
                    self._lst.accept(timeout=0.0)
                except (TimeoutError, OSError):
                    pass
                continue
            self._serve_conn(conn)
        self._reap_stalled()

    def _serve_conn(self, conn: transport.Conn):
        """Drain the connection WITHOUT blocking and handle every frame
        that completed: select only proves some bytes arrived, so a
        blocking whole-frame read here would let one half-sent frame
        stall scheduling for every in-flight request (head-of-line
        blocking).  Partial frames stay buffered on the Conn; a peer
        that leaves one buffered longer than ``frame_timeout`` is
        dropped by :meth:`_reap_stalled`."""
        try:
            frames = conn.recv_serve_nowait()
        except (OSError, ProtocolError, ValueError):
            # PeerClosed (clean FIN), a torn frame, a non-serve kind, or
            # undecodable JSON: the stream cannot be resumed.
            self._drop_conn(conn)
            return
        if conn.rx_pending():
            self._rx_since.setdefault(conn, time.monotonic())
        else:
            self._rx_since.pop(conn, None)
        for kind, msg in frames:
            if conn.sock.fileno() < 0:   # dropped handling an earlier frame
                return
            if kind == "J":  # control: health probe / stats over the wire
                try:
                    conn.send_msg({"ok": True, **self.health()})
                except OSError:
                    self._drop_conn(conn)
                    return
            elif kind == "G":
                self._submit(conn, msg)
            else:            # 'R' is server->client only
                self._drop_conn(conn)
                return

    def _reap_stalled(self):
        """Drop connections whose partial frame has been sitting in the
        reassembly buffer longer than ``frame_timeout`` — the trickler
        wedge class the old blocking deadline killed, now enforced
        without letting the trickler block anyone."""
        if not self._rx_since:
            return
        now = time.monotonic()
        for conn in [c for c, t0 in self._rx_since.items()
                     if now - t0 > self.frame_timeout]:
            self._drop_conn(conn)

    def _submit(self, conn: transport.Conn, msg):
        rid = str(msg.get("rid") or "")
        try:
            if self._draining:
                # no retry_after: a draining server never admits again —
                # the client/router should go elsewhere, not wait here.
                raise QueueFull("server draining",
                                queue_depth=self.sched.queue_depth())
            prompt = np.asarray(msg["prompt"], np.int32)
            rid = self.sched.submit(
                prompt, int(msg.get("max_new", self.default_max_new)),
                rid=rid or None,
                deadline_s=msg.get("deadline_s"),
                eos=msg.get("eos"),
                temperature=float(msg.get("temperature", 0.0)),
                top_k=int(msg.get("top_k", 0)),
                top_p=float(msg.get("top_p", 0.0)),
                seed=int(msg.get("seed", 0)),
                speculate=bool(msg.get("speculate", True)))
        except (QueueFull, ValueError, KeyError, TypeError) as e:
            self._c_reqs.labels(outcome="rejected").inc()
            chunk = {"rid": rid, "error": str(e) or type(e).__name__,
                     "done": True, "epoch": self.epoch}
            if isinstance(e, QueueFull):
                chunk["queue_depth"] = (
                    e.queue_depth if e.queue_depth is not None
                    else self.sched.queue_depth())
                if e.retry_after is not None:
                    chunk["retry_after"] = e.retry_after
            try:
                conn.send_stream(chunk)
            except OSError:
                self._drop_conn(conn)
            return
        self._conn_of[rid] = conn
        self._t_submit[rid] = time.perf_counter()
        # optional trace context from the 'G' frame (router/client root
        # span): TTFT/TPOT/queue-wait spans for this rid re-enter it, so
        # the whole request stitches into one cross-process trace.
        # Malformed or absent degrades to untraced, never rejects.
        tc = msg.get(obs_trace.TRACE_KEY)
        if obs_trace.valid_context(tc):
            self._tc_of[rid] = tc

    def _dispatch(self, events):
        # one 'R' frame per request per round: {"rid", "tokens", "epoch",
        # "done"[, "reason"]} — streaming granularity is the tick,
        # matching TTFT.  The epoch echo is the hot-swap fence witness:
        # swaps only happen with zero active streams, so every chunk of
        # one stream carries the same value.
        out: dict[str, dict] = {}
        now = time.perf_counter()
        for ev in events:
            chunk = out.setdefault(ev.rid, {"rid": ev.rid, "tokens": [],
                                            "done": False,
                                            "epoch": self.epoch})
            if ev.kind == "token":
                chunk["tokens"].append(ev.token)
                if ev.accepted is not None:
                    # draft tokens the verify accepted ahead of this one
                    # (speculative decode observability, summed per chunk)
                    chunk["accepted"] = (chunk.get("accepted", 0)
                                         + ev.accepted)
                if ev.cached is not None:
                    # prompt tokens adopted from the prefix cache instead
                    # of prefilled (rides the first chunk only)
                    chunk["cached_tokens"] = ev.cached
                self._c_toks.inc()
                with obs_trace.use_context(self._tc_of.get(ev.rid)):
                    if ev.first:
                        t0 = self._t_submit.get(ev.rid)
                        if t0 is not None:
                            self._h_ttft.observe(now - t0)
                            obs.record_span("serve.ttft", now - t0,
                                            rid=ev.rid)
                        if ev.waited is not None:
                            # queue-wait attribution: how much of TTFT was
                            # spent parked in the admission queue vs
                            # decoding (the critical-path split
                            # tools/tracecat.py reports)
                            obs.record_span("serve.queue_wait", ev.waited,
                                            rid=ev.rid)
                    else:
                        tl = self._t_last.get(ev.rid)
                        if tl is not None:
                            self._h_tpot.observe(now - tl)
                            obs.record_span("serve.tpot", now - tl,
                                            rid=ev.rid)
                self._t_last[ev.rid] = now
            else:
                chunk["done"] = True
                chunk["reason"] = ev.reason
                outcome = ev.reason or "complete"
                self._c_reqs.labels(outcome=outcome).inc()
        for rid, chunk in out.items():
            conn = self._conn_of.get(rid)
            if conn is not None and conn.sock.fileno() >= 0:
                try:
                    conn.send_stream(chunk)
                except OSError:
                    self._drop_conn(conn)
            if chunk["done"]:
                self._forget(rid)

    def _drop_conn(self, conn: transport.Conn):
        """Client went away: cancel every request it owns (queued or
        decoding) so its slot/pages free on the next round."""
        for rid in [r for r, c in self._conn_of.items() if c is conn]:
            if self.sched.cancel(rid):
                self._c_reqs.labels(outcome="cancelled").inc()
            self._forget(rid)
        self._rx_since.pop(conn, None)
        conn.close()

    def _forget(self, rid: str):
        self._conn_of.pop(rid, None)
        self._t_submit.pop(rid, None)
        self._t_last.pop(rid, None)
        self._tc_of.pop(rid, None)
