"""Deterministic network fault injection for the host transport — a copy
of ``distlearn_tpu/comm/faults.py`` over the port's transport.

A :class:`FaultPlan` owns a set of named LINKS.  Wrapping a
:class:`~distlearn_tpu_torch.comm.transport.Conn` binds it to a link; every
byte the conn moves then passes through a :class:`_FaultSocket` proxy
that consults the link's state — so tests (and the JAX package's chaos
scenario tool, tools/chaos.py) can express one-way partitions, heals, per-direction
delay and bandwidth, mid-frame cuts, and flaky dials WITHOUT any hook in
the production code paths beyond ``Conn.force_py_io`` (the native C++
IO loops operate on the raw fd and would bypass the proxy).

Fault semantics, chosen so every injected failure maps onto an error
class the stack already survives (docs/HA.md):

* ``partition(link, "send")`` — **blackhole**: sends report success but
  no byte leaves.  The peer's recv then starves and its handshake
  timeout fires, exactly like a one-way network partition.  Pretending
  success (rather than blocking) keeps the sender's own thread alive —
  real one-way partitions don't stall the sender until the TCP window
  fills either.
* ``partition(link, "recv")`` — **hold**: reads park without consuming
  from the kernel buffer, so the byte stream is intact after ``heal``
  and the conn can resume mid-protocol.  A parked read honors the
  socket's effective timeout (``settimeout`` or SO_RCVTIMEO) and raises
  the same ``BlockingIOError``/``socket.timeout`` the kernel would, so
  ``Conn`` translates it into its normal :class:`TimeoutError`.
* ``cut_after(link, n)`` — allow ``n`` more sent bytes, then close the
  real socket and raise ``ConnectionResetError``: a deterministic
  mid-frame cut at an exact byte offset.
* ``delay`` / ``bandwidth`` — per-direction; the send direction rides
  the existing ``Conn.throttle_bps`` pacing machinery, the recv
  direction is paced in the proxy.
* ``fail_dials(link, k)`` / ``flaky_dials(link, p)`` — the next ``k``
  ``plan.connect`` dials on the link fail, or each dial fails with
  seeded probability ``p`` (``random.Random(seed)`` per link, so the
  SAME seed yields the SAME accept/refuse sequence — unit-testable
  determinism).  ``wrap_server`` applies the same budgets to accepts.

Every decision is appended to ``plan.log`` as a ``(link, event)`` pair;
two plans built from the same seed and driven through the same call
sequence produce identical logs (the determinism contract pinned by
tests/test_elastic.py, and across the two packages by
tests/test_torch_faults.py).
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Any

from distlearn_tpu_torch.comm import transport

__all__ = ["FaultPlan", "FaultInjected"]

#: poll period of a held (partitioned) read — coarse enough to be cheap,
#: fine enough that heal() unblocks promptly.
_POLL_S = 0.01


class FaultInjected(ConnectionError):
    """Raised for failures the plan injected (flaky dial, scheduled
    refuse) so tests can tell an injected fault from a real one."""


class _LinkState:
    """Shared fault state of one named link (all conns wrapped under the
    same name see the same state)."""

    def __init__(self, name: str, rng: random.Random):
        self.name = name
        self.rng = rng
        self.send_blocked = False
        self.recv_blocked = False
        self.send_delay_s = 0.0
        self.recv_delay_s = 0.0
        self.recv_bps: float | None = None
        self.cut_after: int | None = None     # sent bytes until the cut
        self.fail_dials = 0                    # scheduled dial failures
        self.flaky_p = 0.0                     # per-dial failure probability
        self.dropped_bytes = 0                 # blackholed send bytes


class _FaultSocket:
    """Socket proxy implementing exactly the surface the pure-Python
    ``Conn`` paths use (``sendmsg``/``recv_into``/``recv``/timeouts),
    consulting the link state before every syscall.  Everything else
    passes through to the real socket."""

    def __init__(self, sock: socket.socket, state: _LinkState,
                 lock: threading.Lock):
        self._sock = sock
        self._state = state
        self._lock = lock
        self._timeout: float | None = None    # effective recv timeout

    # -- plumbing -----------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        return getattr(self._sock, name)

    def fileno(self) -> int:
        return self._sock.fileno()

    def settimeout(self, t):
        self._timeout = t
        self._sock.settimeout(t)

    def gettimeout(self):
        return self._timeout

    def setblocking(self, flag: bool):
        self._timeout = None if flag else 0.0
        self._sock.setblocking(flag)

    def setsockopt(self, level, opt, value):
        # Learn the effective kernel recv timeout Conn.set_timeout packs
        # so a held read times out when the caller expects it to.
        if level == socket.SOL_SOCKET and opt == socket.SO_RCVTIMEO \
                and isinstance(value, (bytes, bytearray)):
            sec, usec = struct.unpack("ll", value)
            t = sec + usec / 1e6
            self._timeout = t if t > 0 else None
        return self._sock.setsockopt(level, opt, value)

    def close(self):
        return self._sock.close()

    # -- send direction -----------------------------------------------------
    def _pre_send(self, nbytes: int) -> int:
        """Returns how many of ``nbytes`` may actually leave; the link
        lock is NOT held across the syscall, only across the decision."""
        st = self._state
        with self._lock:
            delay = st.send_delay_s
            blocked = st.send_blocked
            cut = st.cut_after
        if delay:
            time.sleep(delay)
        if blocked:
            with self._lock:
                st.dropped_bytes += nbytes
            return 0
        if cut is not None:
            allowed = min(nbytes, cut)
            with self._lock:
                st.cut_after = max(0, cut - allowed)
            return allowed
        return nbytes

    def _post_cut(self):
        st = self._state
        with self._lock:
            tripped = st.cut_after is not None and st.cut_after <= 0
        if tripped:
            try:
                self._sock.close()
            except OSError:
                pass
            raise ConnectionResetError(
                f"fault injection: link {st.name!r} cut mid-stream")

    def sendmsg(self, bufs):
        total = sum(b.nbytes if isinstance(b, memoryview) else len(b)
                    for b in bufs)
        allowed = self._pre_send(total)
        if allowed == 0:
            return total            # blackhole: pretend the bytes left
        if allowed < total:
            # ship exactly the allowed prefix, then cut
            flat = b"".join(bytes(b) for b in bufs)[:allowed]
            self._sock.sendall(flat)
            self._post_cut()
            return allowed          # not reached: _post_cut raises
        sent = self._sock.sendmsg(bufs)
        self._post_cut()
        return sent

    def sendall(self, data):
        total = len(data)
        allowed = self._pre_send(total)
        if allowed == 0:
            return None
        self._sock.sendall(data[:allowed] if allowed < total else data)
        self._post_cut()
        return None

    def send(self, data):
        total = len(data)
        allowed = self._pre_send(total)
        if allowed == 0:
            return total
        sent = self._sock.send(data[:allowed] if allowed < total else data)
        self._post_cut()
        return sent

    # -- recv direction -----------------------------------------------------
    def _hold_recv(self):
        """Park while the recv direction is partitioned, honoring the
        effective timeout.  Returns when the link heals; raises the same
        error class the kernel timeout would."""
        st = self._state
        t0 = time.monotonic()
        while True:
            with self._lock:
                if not st.recv_blocked:
                    return
            if self._timeout is not None \
                    and time.monotonic() - t0 >= self._timeout:
                # BlockingIOError is what EVERY pure-Python Conn recv
                # path treats as a kernel timeout (SO_RCVTIMEO -> EAGAIN),
                # including the non-blocking serve drain
                raise BlockingIOError(
                    f"fault injection: link {st.name!r} recv partitioned")
            time.sleep(_POLL_S)

    def _pre_recv(self):
        st = self._state
        with self._lock:
            delay = st.recv_delay_s
        if delay:
            time.sleep(delay)
        self._hold_recv()

    def _pace_recv(self, nbytes: int, t0: float):
        bps = self._state.recv_bps
        if bps:
            left = nbytes / bps - (time.monotonic() - t0)
            if left > 0:
                time.sleep(left)

    def recv_into(self, buf, nbytes=0):
        self._pre_recv()
        t0 = time.monotonic()
        r = self._sock.recv_into(buf, nbytes)
        self._pace_recv(r, t0)
        return r

    def recv(self, bufsize, flags=0):
        self._pre_recv()
        t0 = time.monotonic()
        data = self._sock.recv(bufsize, flags)
        self._pace_recv(len(data), t0)
        return data


class FaultPlan:
    """A seeded, deterministic fault scenario over named links.

    Typical use (tests)::

        plan = FaultPlan(seed=7)
        conn = plan.connect(host, port, link="c1")      # flaky-dial aware
        plan.wrap(conn, "c1")                           # byte-level faults
        plan.partition("c1", "send")                    # one-way blackhole
        ...
        plan.heal("c1")

    All mutators are thread-safe; wrapped conns see changes on their next
    IO operation.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._links: dict[str, _LinkState] = {}
        self._conns: dict[str, list[transport.Conn]] = {}
        self.log: list[tuple[str, str]] = []

    # -- link bookkeeping ---------------------------------------------------
    def _link(self, name: str) -> _LinkState:
        with self._lock:
            st = self._links.get(name)
            if st is None:
                # per-link RNG stream derived from (seed, name): decisions
                # on one link don't perturb another's sequence
                st = _LinkState(name, random.Random(f"{self.seed}:{name}"))
                self._links[name] = st
            return st

    def _note(self, link: str, event: str):
        with self._lock:
            self.log.append((link, event))

    # -- wrapping -----------------------------------------------------------
    def wrap(self, conn: transport.Conn, link: str) -> transport.Conn:
        """Bind ``conn`` to ``link``: force the pure-Python IO path and
        interpose the fault proxy over its socket.  Idempotent per conn."""
        st = self._link(link)
        if isinstance(conn.sock, _FaultSocket):
            return conn
        conn.force_py_io = True
        conn.sock = _FaultSocket(conn.sock, st, self._lock)
        with self._lock:
            self._conns.setdefault(link, []).append(conn)
        self._note(link, "wrap")
        return conn

    def wrap_server(self, server: transport.Server, link: str
                    ) -> transport.Server:
        """Make ``server.accept`` flaky-accept aware: each accepted conn
        consumes the link's dial budgets; a conn the plan refuses is
        closed immediately (the peer sees a reset after connect — the
        'flaky accept' failure mode) and does not count toward ``n``.
        Surviving conns are wrapped onto ``link``."""
        st = self._link(link)
        plan = self
        real_accept = server.accept

        def accept(n: int = 1, timeout: float | None = None):
            out: list[transport.Conn] = []
            deadline = None if timeout is None else time.monotonic() + timeout
            while len(out) < n:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                got = real_accept(n - len(out), left)
                for c in got:
                    if plan._take_dial_failure(st):
                        plan._note(link, "accept_refused")
                        c.close()
                        server.conns.remove(c)
                        continue
                    plan._note(link, "accept")
                    out.append(plan.wrap(c, link))
            return out

        server.accept = accept  # type: ignore[method-assign]
        return server

    # -- dials --------------------------------------------------------------
    def _take_dial_failure(self, st: _LinkState) -> bool:
        with self._lock:
            if st.fail_dials > 0:
                st.fail_dials -= 1
                return True
            if st.flaky_p > 0.0:
                return st.rng.random() < st.flaky_p
        return False

    def connect(self, host: str, port: int, link: str = "default",
                **kw) -> transport.Conn:
        """``transport.connect`` behind the link's dial budgets: a
        scheduled or flaky failure raises :class:`FaultInjected` without
        touching the network; a surviving dial is wrapped onto the
        link."""
        st = self._link(link)
        if self._take_dial_failure(st):
            self._note(link, "dial_refused")
            raise FaultInjected(
                f"fault injection: dial on link {link!r} refused")
        self._note(link, "dial")
        return self.wrap(transport.connect(host, port, **kw), link)

    # -- fault mutators -----------------------------------------------------
    def partition(self, link: str, direction: str = "both"):
        """One-way (or two-way) partition: ``"send"`` blackholes the
        wrapped side's sends, ``"recv"`` holds its reads (stream intact
        for :meth:`heal`)."""
        st = self._link(link)
        with self._lock:
            if direction in ("send", "both"):
                st.send_blocked = True
            if direction in ("recv", "both"):
                st.recv_blocked = True
        self._note(link, f"partition:{direction}")

    def heal(self, link: str):
        """Lift every partition/delay/bandwidth fault on the link (cuts
        are not healable — the socket is gone)."""
        st = self._link(link)
        with self._lock:
            st.send_blocked = st.recv_blocked = False
            st.send_delay_s = st.recv_delay_s = 0.0
            st.recv_bps = None
            conns = list(self._conns.get(link, []))
        for c in conns:
            c.throttle_bps = None
        self._note(link, "heal")

    def delay(self, link: str, seconds: float, direction: str = "both"):
        st = self._link(link)
        with self._lock:
            if direction in ("send", "both"):
                st.send_delay_s = float(seconds)
            if direction in ("recv", "both"):
                st.recv_delay_s = float(seconds)
        self._note(link, f"delay:{direction}:{seconds}")

    def bandwidth(self, link: str, bps: float, direction: str = "both"):
        """Pace the link to ``bps`` bytes/second.  The send direction
        rides ``Conn.throttle_bps`` (the machinery docs/EA_CONVERGENCE.md
        benches with); the recv direction is paced in the proxy."""
        st = self._link(link)
        if direction in ("send", "both"):
            with self._lock:
                conns = list(self._conns.get(link, []))
            for c in conns:
                c.throttle_bps = float(bps)
        if direction in ("recv", "both"):
            with self._lock:
                st.recv_bps = float(bps)
        self._note(link, f"bandwidth:{direction}:{bps}")

    def cut_after(self, link: str, nbytes: int):
        """Deterministic mid-stream cut: the link's sends deliver exactly
        ``nbytes`` more bytes, then the socket closes and the sender sees
        ``ConnectionResetError`` — a frame torn at a known offset."""
        st = self._link(link)
        with self._lock:
            st.cut_after = int(nbytes)
        self._note(link, f"cut_after:{nbytes}")

    def fail_dials(self, link: str, k: int):
        """Schedule the next ``k`` dials/accepts on the link to fail."""
        st = self._link(link)
        with self._lock:
            st.fail_dials += int(k)
        self._note(link, f"fail_dials:{k}")

    def flaky_dials(self, link: str, p: float):
        """Each subsequent dial/accept fails with probability ``p``,
        drawn from the link's seeded RNG stream."""
        st = self._link(link)
        with self._lock:
            st.flaky_p = float(p)
        self._note(link, f"flaky_dials:{p}")

    # -- introspection ------------------------------------------------------
    def dropped_bytes(self, link: str) -> int:
        """Bytes blackholed on the link's send direction so far."""
        return self._link(link).dropped_bytes

    def decisions(self) -> list[tuple[str, str]]:
        """The ordered decision/audit log — two same-seed plans driven
        through the same call sequence produce identical lists."""
        with self._lock:
            return list(self.log)
