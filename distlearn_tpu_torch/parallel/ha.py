"""Center HA: restore/promote helpers around the AsyncEA checkpoints —
counterpart of ``distlearn_tpu/parallel/ha.py``.

``AsyncEAServer.enable_checkpoint`` writes ``ckpt_{step}.npz`` files whose
tree is ``{"center": {"<i>": leaf}}`` (the center's leaves in the wire
layout, by flat index) plus the HA metadata (epoch, per-client applied-seq
ledger, negotiated codecs) — the JAX package's layout, so either package's
standby promotes the other's primary.  This module turns a directory of
those files back into a SERVING center:

* :func:`restore_center` — load the newest (or a given) checkpoint into the
  structure of a template pytree;
* :func:`promote` — restore + ``init_server`` + ``adopt_ha_meta`` on a
  standby server, bumping the center epoch so the dead primary is fenced;
* :class:`StandbyCenter` — the warm-standby loop: tail the checkpoint
  directory, optionally probe the primary, promote on demand;
* :func:`install_signal_flush` — the SIGTERM hook for a final checkpoint.

Clients need none of this: their half is ``AsyncEAClient.failover``.
"""

from __future__ import annotations

import os
import signal
import socket
import time
from typing import Any, Callable

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.models.convert import WireLayout
from distlearn_tpu_torch.parallel.async_ea import (_from_wire, _leaves,
                                                   _rebuild, _to_wire)
from distlearn_tpu_torch.utils.checkpoint import (latest_step,
                                                  restore_checkpoint)
from distlearn_tpu_torch.utils.logging import print_server

PyTree = Any


def restore_center(directory: str, like: PyTree, step: int | None = None,
                   layout: WireLayout | None = None) -> tuple[PyTree, dict]:
    """Restore a center checkpoint into the structure of ``like`` (the
    port's layout; shape and dtype checked leaf by leaf in the wire layout
    ``layout`` the file holds; ``step=None`` -> newest).  Returns
    ``(center pytree of CPU tensors, metadata)``; the metadata carries the
    HA keys for :meth:`AsyncEAServer.adopt_ha_meta`."""
    wire_like = _to_wire(layout, like)
    leaves = [t.detach().cpu() for t in _leaves(wire_like)]
    tree, meta = restore_checkpoint(
        directory, {"center": {str(i): t for i, t in enumerate(leaves)}},
        step=step)
    got = [tree["center"][str(i)] for i in range(len(leaves))]
    return _from_wire(layout, _rebuild(wire_like, got)), meta


def promote(srv, directory: str, like: PyTree,
            step: int | None = None) -> PyTree:
    """Promote ``srv`` (a standby ``AsyncEAServer`` or
    ``AsyncEAServerConcurrent``) to primary: restore the newest center
    checkpoint, seed the server with it on its device and adopt the HA
    metadata — which bumps the epoch past the dead primary's.  Returns the
    restored center pytree (CPU tensors, the port's layout)."""
    with obs.span("async_ea.promote", directory=directory):
        center, meta = restore_center(directory, like, step=step,
                                      layout=srv.layout)
        srv.init_server(center)
        srv.adopt_ha_meta(meta)
    obs.counter("async_ea_failover_promotions_total",
                "standby centers promoted to primary").inc()
    print_server(f"promoted from {directory} "
                 f"(step {meta.get('step')}, epoch {srv.epoch})")
    return center


def tcp_probe(host: str, port: int, timeout: float = 1.0) -> bool:
    """True when something is accepting on (host, port) — the minimal
    is-the-primary-alive probe for :meth:`StandbyCenter.watch`."""
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


class StandbyCenter:
    """The warm-standby loop around a server constructed with
    ``standby=True`` (listeners bound, no clients awaited): tail the
    checkpoint directory the primary writes, and :meth:`promote` when told
    — or when :meth:`watch`'s probe of the primary goes dark."""

    def __init__(self, server, directory: str, like: PyTree):
        self.server = server
        self.directory = directory
        self.like = like
        self.promoted = False

    def poll_step(self) -> int | None:
        """Newest checkpoint step visible right now (None: none yet)."""
        return latest_step(self.directory)

    def wait_for_checkpoint(self, timeout: float | None = None,
                            poll: float = 0.25) -> int:
        """Block until at least one checkpoint exists; returns its step.
        Raises ``TimeoutError`` after ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = self.poll_step()
            if step is not None:
                return step
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"no checkpoint appeared in {self.directory} "
                    f"within {timeout}s")
            time.sleep(poll)

    def promote(self, step: int | None = None) -> PyTree:
        """Restore + take over as the next epoch (see :func:`promote`)."""
        center = promote(self.server, self.directory, self.like, step=step)
        self.promoted = True
        return center

    def watch(self, primary_probe: Callable[[], bool],
              poll: float = 0.5, ckpt_grace: float = 30.0) -> PyTree:
        """Re-probe the primary every ``poll`` seconds and promote after
        two misses in a row.  The first probe waits for a checkpoint (a
        probe during the primary's startup accept would count as a client
        dial); ``ckpt_grace`` bounds the wait for a final checkpoint racing
        in after the primary went dark.  Returns the restored center."""
        self.wait_for_checkpoint()
        misses = 0
        while True:
            if primary_probe():
                misses = 0
            else:
                misses += 1
                if misses >= 2:
                    self.wait_for_checkpoint(timeout=ckpt_grace)
                    return self.promote()
            time.sleep(poll)


def install_signal_flush(srv, signums=(signal.SIGTERM,)) -> None:
    """On each of ``signums``, write one last checkpoint (blocking until it
    is on disk), then deliver the signal's prior disposition: a Python
    handler is chained, the default one re-delivered so exit codes stay
    honest.  Call from the main thread (the signal module's rule)."""
    for signum in signums:
        prev = signal.getsignal(signum)

        def _flush(num, frame, _prev=prev):
            try:
                srv.checkpoint_now(wait=True)
            except Exception as e:  # noqa: BLE001 — dying anyway
                print_server(f"final checkpoint flush failed: {e!r}")
            if callable(_prev):
                _prev(num, frame)
            elif _prev is not signal.SIG_IGN:
                signal.signal(num, signal.SIG_DFL)
                os.kill(os.getpid(), num)

        signal.signal(signum, _flush)
