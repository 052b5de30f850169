"""autoscaler — the obs-driven scaling loop that closes the plane (the
port's copy of the root ``tools/autoscaler.py``, over the port's ``obs``:
the same policy, flags and reports).

telemetry -> fleet aggregation -> SLO evaluation -> scaling action:
every process exports its registry (``obs/export.py``), an
``obs.agg.Collector`` merges the fleet view, an ``obs.agg.SLOEngine``
judges it against declarative objectives, and this loop turns breaches
into capacity:

* **serve replicas** — spawn a new replica process/instance and
  ``Router.add_replica`` it into dispatch on breach; retire the newest
  member after a full cooldown of clean rounds.
* **elastic training clients** — the same loop shape over the
  ``Join?``/``Leave?`` verbs (``AsyncEAClient.join`` / ``.leave``,
  docs/ELASTIC.md): the spawn/retire callables join or gracefully
  leave a fleet member.

The loop itself is actuator-agnostic: :class:`Actuator` wraps a
``spawn() -> handle`` / ``retire(handle)`` pair with min/max bounds, so
the serving and training cases (and tests with fake callables) share
one policy.  Policy: scale UP immediately on any watched SLO breach
(one step per round — additive increase against a p95 objective beats
a thundering spawn), scale DOWN one member per round only after
``cooldown_s`` with every watched rule clean — flash crowds end, but
TTFT must not breach again just because the crowd's tail is still
draining.

Disabled (``enabled=False`` or the ``DISTLEARN_OBS`` kill switch), the
loop takes no action and touches nothing — a fixed fleet runs bitwise
identically with or without the plane (the acceptance criterion the
``fixed_fleet`` tests pin).

Traffic scenarios that exercise this loop end-to-end (Zipf request mix,
diurnal curve, 10x flash crowd): ``python -m distlearn_tpu_torch.tools.chaos
scenario --name zipf_mix|diurnal|flash_crowd``.

Usage as a library (the normal case — see the runbook in
docs/OBSERVABILITY.md):

    collector = obs.Collector(endpoints=[(h, p), ...])
    slo = obs.SLOEngine([{"name": "ttft-p95", "kind": "quantile",
                          "metric": "serve_ttft_seconds",
                          "q": 0.95, "target": 0.25}])
    act = Actuator(spawn=spawn_replica, retire=retire_replica,
                   min_size=1, max_size=6, initial=1)
    Autoscaler(collector, slo, act, cooldown_s=10.0).run(
        interval=1.0, stop=stop_event)

CLI (endpoints polled over HTTP, rules from a JSON file, actions
printed instead of actuated — a dry-run fleet monitor):

    python -m distlearn_tpu_torch.tools.autoscaler --endpoint 127.0.0.1:9100 \
        --endpoint 127.0.0.1:9101 --rules slo.json --interval 2
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from distlearn_tpu_torch import obs
from distlearn_tpu_torch.obs import trace


class Actuator:
    """Bounded spawn/retire surface the scaling loop drives.

    ``spawn()`` returns an opaque handle (a server object, a pid, a
    client id); ``retire(handle)`` tears that member down.  Members
    retire newest-first (LIFO) — the baseline fleet the operator started
    with is the last to go.  A spawn that raises counts as no change;
    bounds are enforced here so a mis-tuned policy cannot runaway-spawn.
    """

    def __init__(self, spawn, retire, *, min_size: int = 1,
                 max_size: int = 8, initial: int = 0):
        if min_size < 0 or max_size < max(min_size, 1):
            raise ValueError(f"bad bounds [{min_size}, {max_size}]")
        self._spawn, self._retire = spawn, retire
        self.min_size, self.max_size = int(min_size), int(max_size)
        #: members this actuator spawned (the pre-existing ``initial``
        #: ones are counted in ``size`` but never retired from here)
        self._handles: list = []
        self._initial = int(initial)

    @property
    def size(self) -> int:
        return self._initial + len(self._handles)

    def scale_up(self) -> bool:
        if self.size >= self.max_size:
            return False
        self._handles.append(self._spawn())
        return True

    def scale_down(self) -> bool:
        if not self._handles or self.size <= self.min_size:
            return False
        self._retire(self._handles.pop())
        return True


class Autoscaler:
    """One control loop over (collector, SLO engine, actuator).

    ``scale_on`` names the SLO rules whose breach triggers scaling
    (``None`` = every rule the engine evaluates).  ``cooldown_s`` is
    the clean time required before any retire — measured from the last
    breach AND the last scaling action, whichever is later, so a fresh
    member gets a full window to absorb load before being judged
    surplus."""

    def __init__(self, collector, slo, actuator: Actuator, *,
                 scale_on=None, cooldown_s: float = 10.0,
                 clock=time.monotonic, enabled: bool = True):
        self.collector, self.slo, self.actuator = collector, slo, actuator
        self.scale_on = None if scale_on is None else set(scale_on)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self.enabled = bool(enabled) and obs.enabled()
        self._last_breach: float | None = None
        self._last_action: float | None = None
        self._c_events = obs.counter(
            "autoscaler_scale_events_total",
            "scaling actions taken, by direction", labels=("direction",))
        self._g_target = obs.gauge(
            "autoscaler_target_size",
            "fleet size after the last control round")

    def step(self, now: float | None = None) -> dict:
        """One control round: poll -> evaluate -> (maybe) act.  Returns
        ``{"action": "up"|"down"|"hold"|"disabled", "size", "breached",
        "events"}`` — the record the scenario harness asserts on."""
        if not self.enabled:
            return {"action": "disabled", "size": self.actuator.size,
                    "breached": [], "events": []}
        now = self._clock() if now is None else now
        fleet = self.collector.poll()
        events = self.slo.evaluate(fleet)
        watched = [e for e in events
                   if self.scale_on is None or e["slo"] in self.scale_on]
        breached = [e["slo"] for e in watched if not e["ok"]]
        action = "hold"
        if breached:
            self._last_breach = now
            if self.actuator.scale_up():
                action = "up"
                self._last_action = now
                self._c_events.labels(direction="up").inc()
                trace.record_span("autoscaler.scale_up", 0.0,
                                  size=self.actuator.size,
                                  slo=",".join(sorted(breached)))
        elif self._cooled(now):
            if self.actuator.scale_down():
                action = "down"
                self._last_action = now
                self._c_events.labels(direction="down").inc()
                trace.record_span("autoscaler.scale_down", 0.0,
                                  size=self.actuator.size)
        self._g_target.set(self.actuator.size)
        return {"action": action, "size": self.actuator.size,
                "breached": breached, "events": events}

    def _cooled(self, now: float) -> bool:
        marks = [t for t in (self._last_breach, self._last_action)
                 if t is not None]
        if not marks:
            # never breached, never acted: nothing to cool down from,
            # but also nothing says the extra capacity is surplus —
            # only shrink once a breach/recovery cycle has happened
            return self.actuator.size > self.actuator.min_size \
                and self._last_breach is not None
        return now - max(marks) >= self.cooldown_s

    def run(self, interval: float, stop: threading.Event,
            on_round=None) -> int:
        """Drive :meth:`step` every ``interval`` seconds until ``stop``
        is set; ``on_round(report)`` observes each round.  Returns the
        number of rounds run."""
        rounds = 0
        while not stop.is_set():
            report = self.step()
            rounds += 1
            if on_round is not None:
                on_round(report)
            stop.wait(interval)
        return rounds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--endpoint", action="append", default=[],
                   metavar="HOST:PORT",
                   help="an obs export endpoint to poll (repeatable)")
    p.add_argument("--trail", action="append", default=[],
                   help="a JSONL trail to ingest (repeatable)")
    p.add_argument("--rules", required=True,
                   help="JSON file: a list of SLO rule dicts "
                        "(docs/OBSERVABILITY.md)")
    p.add_argument("--interval", type=float, default=2.0)
    p.add_argument("--rounds", type=int, default=0,
                   help="stop after N rounds (0 = run until ^C)")
    args = p.parse_args(argv)
    with open(args.rules) as fh:
        rules = json.load(fh)
    endpoints = []
    for ep in args.endpoint:
        host, _, port = ep.rpartition(":")
        endpoints.append((host, int(port)))
    collector = obs.Collector(endpoints=endpoints, trails=args.trail)
    slo = obs.SLOEngine(rules)
    # dry run: the CLI has no spawn authority — it reports the action
    # the policy WOULD take, which is the useful fleet monitor mode
    act = Actuator(spawn=lambda: "dry-run", retire=lambda h: None,
                   min_size=0, max_size=1 << 30)
    scaler = Autoscaler(collector, slo, act)
    n = 0
    try:
        while args.rounds <= 0 or n < args.rounds:
            report = scaler.step()
            n += 1
            print(json.dumps(report))
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
