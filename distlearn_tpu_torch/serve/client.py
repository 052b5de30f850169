"""A copy of ``distlearn_tpu/serve/client.py`` over the port's transport;
it drives a JAX or a port server alike.

Minimal request driver for the serving protocol (client side of
``serve.server``): dial, send one ``'G'`` frame, iterate ``'R'`` chunks
until ``done``.  Used by ``examples/lm_client.py``, ``serve.router``
and the e2e tests; deliberately synchronous — concurrency is the
SERVER's job (continuous batching), a load generator just opens more
connections.

Failure classification is typed so the router and bare clients agree:

* :class:`ReplicaDead` (a ``ConnectionError``) — the replica went away
  under us: the dial exhausted its deadline, or the stream hit a FIN /
  reset mid-request (``transport.PeerClosed`` rewrapped).  Retrying on
  a DIFFERENT replica is the right move; the router does exactly that
  for requests that haven't produced a token yet.
* :class:`ServeError` — the replica is alive and said no (rejection or
  abort).  A shed rejection carries ``retry_after`` + ``queue_depth``;
  :meth:`ServeClient.generate` honors the hint with jittered backoff
  for ``shed_retries`` attempts before surfacing it.
"""

from __future__ import annotations

import random
import time

from distlearn_tpu_torch.comm import transport
from distlearn_tpu_torch.comm.errors import PeerClosed


class ServeError(RuntimeError):
    """Server rejected or aborted the request (``error`` field, or a
    terminal reason other than ``complete``/``eos``).  ``retry_after``
    and ``queue_depth`` carry the shed hint when the rejection was an
    admission-queue overflow (None otherwise)."""

    def __init__(self, msg: str, *, retry_after: float | None = None,
                 queue_depth: int | None = None):
        super().__init__(msg)
        self.retry_after = retry_after
        self.queue_depth = queue_depth


class ReplicaDead(ConnectionError):
    """The serving replica died under us — dial failed or the stream
    was cut (clean FIN or reset) before the terminal chunk."""


class ServeClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 retries: int = 60, deadline_s: float | None = None):
        try:
            self.conn = transport.connect(host, port, retries=retries,
                                          deadline_s=deadline_s)
        except ConnectionError as e:
            raise ReplicaDead(f"dial {host}:{port} failed: {e}") from e

    def ping(self, timeout: float = 5.0) -> dict:
        """Control round-trip ('J' frame): returns the server's health
        snapshot (queue depth, active slots, draining flag, epoch)."""
        try:
            self.conn.send_msg({"q": "stats"})
            return self.conn.recv_msg(deadline=time.monotonic() + timeout)
        except (PeerClosed, ConnectionResetError, BrokenPipeError) as e:
            raise ReplicaDead(f"replica died during ping: {e!r}") from e

    def generate(self, prompt, max_new: int, *, rid: str | None = None,
                 deadline_s: float | None = None, eos: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0, speculate: bool = True,
                 timeout: float = 60.0, on_chunk=None,
                 shed_retries: int = 3) -> dict:
        """Run one request to completion.  Returns
        ``{"rid", "tokens", "reason", "epoch", "accepted",
        "cached_tokens"}``; raises
        :class:`ServeError` on a server-side rejection/abort,
        :class:`ReplicaDead` when the connection dies mid-stream, and
        :class:`TimeoutError` when no chunk lands within ``timeout``.
        ``on_chunk(tokens)`` streams partial output as it arrives.
        ``temperature``/``top_k``/``top_p``/``seed`` select sampled
        decoding (``temperature == 0`` is exact greedy);
        ``speculate=False`` opts a greedy stream out of speculative
        decoding.

        A shed rejection (``retry_after`` in the error chunk) is retried
        on the SAME connection up to ``shed_retries`` times with full
        jitter over a doubling multiple of the hint, then surfaced."""
        msg = {"prompt": [int(t) for t in prompt], "max_new": int(max_new)}
        if rid is not None:
            msg["rid"] = rid
        if deadline_s is not None:
            msg["deadline_s"] = float(deadline_s)
        if eos is not None:
            msg["eos"] = int(eos)
        # non-default only: the plain greedy frame stays byte-identical
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
        for attempt in range(max(0, int(shed_retries)) + 1):
            try:
                return self._stream(msg, rid, timeout, on_chunk)
            except ServeError as e:
                if e.retry_after is None or attempt >= shed_retries:
                    raise
                # full jitter over a doubling multiple of the hint: the
                # shed herd decorrelates instead of re-arriving together.
                time.sleep(random.uniform(
                    0.0, min(30.0, e.retry_after * (2 ** attempt))))
        raise AssertionError("unreachable")  # pragma: no cover

    def _stream(self, msg: dict, rid: str | None, timeout: float,
                on_chunk) -> dict:
        try:
            self.conn.send_gen(msg)
        except (PeerClosed, ConnectionResetError, BrokenPipeError) as e:
            raise ReplicaDead(f"replica died on submit: {e!r}") from e
        tokens: list[int] = []
        epoch = None
        accepted = 0        # speculative drafts the server accepted
        cached = 0          # prompt tokens served from the prefix cache
        while True:
            try:
                kind, chunk = self.conn.recv_serve(
                    deadline=time.monotonic() + timeout)
            except (PeerClosed, ConnectionResetError, BrokenPipeError) as e:
                raise ReplicaDead(
                    f"replica died mid-stream after {len(tokens)} "
                    f"token(s): {e!r}") from e
            if kind != "R":
                raise transport.ProtocolError(
                    f"expected stream chunk, got kind {kind!r}")
            if rid is not None and chunk.get("rid") not in (rid, ""):
                continue      # chunk for another request on a shared conn
            if chunk.get("epoch") is not None:
                epoch = chunk["epoch"]
            if chunk.get("error"):
                raise ServeError(chunk["error"],
                                 retry_after=chunk.get("retry_after"),
                                 queue_depth=chunk.get("queue_depth"))
            if chunk.get("accepted"):
                accepted += int(chunk["accepted"])
            if chunk.get("cached_tokens"):
                cached = int(chunk["cached_tokens"])
            got = chunk.get("tokens") or []
            tokens.extend(int(t) for t in got)
            if got and on_chunk is not None:
                on_chunk(got)
            if chunk.get("done"):
                reason = chunk.get("reason", "complete")
                if reason not in ("complete", "eos"):
                    raise ServeError(f"request ended: {reason}")
                return {"rid": chunk.get("rid"), "tokens": tokens,
                        "reason": reason, "epoch": epoch,
                        "accepted": accepted, "cached_tokens": cached}

    def close(self):
        self.conn.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
