"""Fleet aggregation + SLO engine — the central half of the
observability plane (a copy of ``distlearn_tpu/obs/agg.py`` over the
port's ``obs.core`` and ``obs.trace``; the snapshot records and the
``/snapshot`` endpoint are the same in both packages, so a collector of
either package polls processes of both).

Every process keeps its own registry (``obs.core``); this module merges
their ``snapshot_record()``s into ONE fleet view and evaluates
declarative service-level objectives against it:

* :class:`FleetRegistry` — latest snapshot per *source* (a process),
  merged on demand: counters and gauges sum across sources,
  fixed-bucket histograms merge bucket-by-bucket.  Histogram merging is
  EXACT if and only if the bucket bounds are identical — mismatched
  bounds raise :class:`MergeError` rather than silently mis-binning
  (the tests hold both directions).  Re-ingesting a
  source REPLACES its contribution (snapshots are cumulative per
  process), so polling twice never double-counts.
* :class:`Collector` — pulls ``/snapshot`` from each process's export
  HTTP endpoint (obs/export.py) and/or tails JSONL trails (the
  ``--obsLog`` files), ingesting into a fleet registry.  A dead
  endpoint is skipped and counted (``obs_agg_poll_failures_total``),
  never fatal — the aggregation plane must outlive any one member.
* :class:`SLOEngine` — declarative rules (docs/OBSERVABILITY.md "SLO
  rule schema"): ``quantile`` (a histogram's estimated p95/p99 against
  a target) and ``burn_rate`` (bad/total ratio over a rolling window
  against an error budget).  Breaches and recoveries are first-class
  obs events: ``slo_ok{slo}`` / ``slo_value{slo}`` gauges,
  ``slo_breaches_total{slo}`` / ``slo_recoveries_total{slo}`` counters,
  and ``slo.breach`` / ``slo.recover`` span records in the trail — so
  ``tools.diststat`` shows them and ``tools.autoscaler`` acts on them.

Everything here is consumer-side: ingesting a snapshot never touches
the process-local registry, and the module stays dependency-free
(stdlib ``urllib`` for the pull).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import urllib.request

from distlearn_tpu_torch.obs import core, trace

__all__ = ["MergeError", "FleetRegistry", "Collector", "SLOEngine",
           "merge_histograms", "estimate_quantile"]


class MergeError(ValueError):
    """Two histogram samples with different bucket bounds cannot be
    merged exactly — refusing beats silently mis-binning."""


def merge_histograms(a: dict, b: dict) -> dict:
    """Merge two histogram samples (``{"sum", "count", "buckets":
    {bound: n}, "inf": n}``) bucket-by-bucket.  Exact when bounds match
    (bucket counts and totals add); raises :class:`MergeError` when
    they don't."""
    ab, bb = list(a.get("buckets", {})), list(b.get("buckets", {}))
    if ab != bb:
        raise MergeError(
            f"histogram bucket bounds differ: {ab!r} vs {bb!r} — "
            "merging would mis-bin; re-bucket at the source instead")
    return {"sum": a.get("sum", 0.0) + b.get("sum", 0.0),
            "count": a.get("count", 0) + b.get("count", 0),
            "buckets": {k: a["buckets"][k] + b["buckets"][k] for k in ab},
            "inf": a.get("inf", 0) + b.get("inf", 0)}


def estimate_quantile(sample: dict, q: float) -> float:
    """Estimate quantile ``q`` (0..1) from a histogram sample by linear
    interpolation inside the target bucket (the Prometheus
    ``histogram_quantile`` rule).  ``nan`` on an empty histogram; the
    highest finite bound when the target lands in +Inf."""
    count = sample.get("count", 0)
    if count <= 0:
        return float("nan")
    bounds = [float(k) for k in sample.get("buckets", {})]
    counts = list(sample.get("buckets", {}).values())
    target = q * count
    cum = 0.0
    for i, (bound, n) in enumerate(zip(bounds, counts)):
        if cum + n >= target and n > 0:
            lo = bounds[i - 1] if i > 0 else 0.0
            frac = (target - cum) / n
            return lo + (bound - lo) * frac
        cum += n
    return bounds[-1] if bounds else float("nan")


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def _matches(labels: dict, match: dict | None) -> bool:
    if not match:
        return True
    labels = labels or {}
    return all(str(labels.get(k)) == str(v) for k, v in match.items())


class FleetRegistry:
    """Latest snapshot per source, merged on demand.  Thread-safe: the
    collector ingests from its poll loop while the SLO engine and the
    autoscaler read."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_source: dict[str, list] = {}
        self._ts: dict[str, float] = {}

    def ingest(self, rec: dict, source: str):
        """Adopt one process's ``snapshot_record()``.  A later ingest
        from the same ``source`` replaces the earlier one — per-process
        snapshots are cumulative, so replace-not-add is what keeps the
        fleet totals exact."""
        if not isinstance(rec, dict) or rec.get("type") != "snapshot":
            raise ValueError(f"not a snapshot record: {rec!r}")
        with self._lock:
            self._by_source[str(source)] = rec.get("metrics", [])
            self._ts[str(source)] = float(rec.get("ts", 0.0))

    def forget(self, source: str):
        """Drop a source's contribution (a retired fleet member)."""
        with self._lock:
            self._by_source.pop(str(source), None)
            self._ts.pop(str(source), None)

    def sources(self) -> dict[str, float]:
        """source -> snapshot timestamp of the current contribution."""
        with self._lock:
            return dict(self._ts)

    # -- merged views --------------------------------------------------------
    def merged(self) -> dict[str, dict]:
        """name -> ``{"kind", "help", "labelnames", "samples": [...]}``
        with every source's samples merged per label set.  Raises
        :class:`MergeError` on kind or histogram-bound skew between
        sources — config skew is an error, not an average."""
        with self._lock:
            items = list(self._by_source.items())
        out: dict[str, dict] = {}
        for _source, metrics in items:
            for fam in metrics:
                name, kind = fam["name"], fam["kind"]
                dst = out.get(name)
                if dst is None:
                    dst = out[name] = {"name": name, "kind": kind,
                                       "help": fam.get("help", ""),
                                       "labelnames":
                                           list(fam.get("labelnames", [])),
                                       "samples": {}}
                elif dst["kind"] != kind:
                    raise MergeError(
                        f"metric {name!r} is a {dst['kind']} on one "
                        f"source and a {kind} on another")
                for s in fam.get("samples", []):
                    key = _label_key(s.get("labels", {}))
                    have = dst["samples"].get(key)
                    if have is None:
                        dst["samples"][key] = dict(s)
                    elif kind == "histogram":
                        merged = merge_histograms(have, s)
                        merged["labels"] = have.get("labels", {})
                        dst["samples"][key] = merged
                    else:
                        have["value"] = have.get("value", 0) + s.get(
                            "value", 0)
        for fam in out.values():
            fam["samples"] = list(fam["samples"].values())
        return out

    def total(self, name: str, match: dict | None = None) -> float:
        """Fleet-wide sum of a counter/gauge over the label sets that
        carry every ``match`` pair (0.0 when absent)."""
        total = 0.0
        fam = self.merged().get(name)
        for s in (fam or {}).get("samples", []):
            if _matches(s.get("labels"), match):
                total += s.get("value", 0)
        return total

    def histogram(self, name: str, match: dict | None = None) -> dict | None:
        """Fleet-merged histogram sample for ``name`` (label sets that
        match fold together), or ``None`` when no source reports it."""
        fam = self.merged().get(name)
        if not fam or fam["kind"] != "histogram":
            return None
        acc = None
        for s in fam["samples"]:
            if not _matches(s.get("labels"), match):
                continue
            acc = dict(s) if acc is None else merge_histograms(acc, s)
        return acc

    def breakdown(self, name: str, match: dict | None = None
                  ) -> dict[str, float]:
        """source -> that process's contribution to ``total(name)`` —
        the per-process column ``diststat merge`` prints."""
        with self._lock:
            items = list(self._by_source.items())
        out: dict[str, float] = {}
        for source, metrics in items:
            v = 0.0
            seen = False
            for fam in metrics:
                if fam["name"] != name:
                    continue
                for s in fam.get("samples", []):
                    if _matches(s.get("labels"), match):
                        if fam["kind"] == "histogram":
                            v += s.get("count", 0)
                        else:
                            v += s.get("value", 0)
                        seen = True
            if seen:
                out[source] = v
        return out


def read_trail_snapshot(path: str) -> dict | None:
    """The LAST snapshot record in one JSONL trail (the cumulative
    registry state), or ``None`` when the trail has none."""
    last = None
    try:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue        # torn tail line of a live run
                if rec.get("type") == "snapshot":
                    last = rec
    except OSError:
        return None
    return last


class Collector:
    """Pull-based fleet ingestion: HTTP ``/snapshot`` endpoints and/or
    JSONL trails into one :class:`FleetRegistry`.

    Endpoint membership is mutated by the actuator/operator thread while
    :meth:`poll` runs on the autoscaler loop, so the source lists are
    guarded by ``_lock``; poll iterates a snapshot taken under it."""

    def __init__(self, endpoints=(), trails=(), *, timeout: float = 2.0,
                 fleet: FleetRegistry | None = None):
        """``endpoints``: ``(host, port)`` pairs or full URLs;
        ``trails``: JSONL paths (source = file basename)."""
        self._lock = threading.Lock()
        self.endpoints = [e if isinstance(e, str)
                          else f"http://{e[0]}:{int(e[1])}"
                          for e in endpoints]
        self.trails = [str(t) for t in trails]
        self.timeout = float(timeout)
        self.fleet = fleet if fleet is not None else FleetRegistry()
        self._c_polls = core.counter(
            "obs_agg_polls_total", "collector poll rounds completed")
        self._c_fail = core.counter(
            "obs_agg_poll_failures_total",
            "per-source ingest failures (endpoint down / trail torn)",
            labels=("source",))

    def add_endpoint(self, host: str, port: int):
        url = f"http://{host}:{int(port)}"
        with self._lock:
            if url not in self.endpoints:
                self.endpoints.append(url)

    def remove_endpoint(self, host: str, port: int):
        url = f"http://{host}:{int(port)}"
        with self._lock:
            if url not in self.endpoints:
                return
            self.endpoints.remove(url)
        # FleetRegistry has its own lock; don't nest it under ours
        self.fleet.forget(url)

    def poll(self) -> FleetRegistry:
        """One ingest round over every endpoint and trail.  Failures
        skip the source (its previous contribution stands) and count —
        the fleet view degrades gracefully while a member restarts."""
        with self._lock:
            endpoints = list(self.endpoints)
            trails = list(self.trails)
        for url in endpoints:
            try:
                with urllib.request.urlopen(url + "/snapshot",
                                            timeout=self.timeout) as resp:
                    rec = json.loads(resp.read().decode())
                self.fleet.ingest(rec, source=url)
            except (OSError, ValueError):
                self._c_fail.labels(source=url).inc()
        for path in trails:
            rec = read_trail_snapshot(path)
            if rec is None:
                self._c_fail.labels(source=os.path.basename(path)).inc()
                continue
            self.fleet.ingest(rec, source=os.path.basename(path))
        self._c_polls.inc()
        return self.fleet


_RULE_KINDS = ("quantile", "burn_rate")


class SLOEngine:
    """Evaluate declarative SLO rules against a fleet registry.

    Rule schema (a list of dicts, validated at construction):

    * ``{"name", "kind": "quantile", "metric", "q", "target"[,
      "match", "window_s"]}`` — estimated quantile ``q`` of histogram
      ``metric`` must be ≤ ``target``.  With ``window_s``, the quantile
      is taken over the trailing window only (bucket-wise difference of
      the cumulative histogram — ``histogram_quantile(rate(...))`` in
      PromQL terms), so a past burst stops breaching once it leaves the
      window; without it, over everything ever observed.
    * ``{"name", "kind": "burn_rate", "total", "bad", "budget",
      "window_s", "max_burn"[, "match_total", "match_bad"]}`` — over
      the trailing ``window_s``, ``(Δbad/Δtotal) / budget`` must be ≤
      ``max_burn`` (the SRE error-budget burn rate; 1.0 = burning
      exactly the budget).

    A rule with no data yet (empty histogram, zero traffic) evaluates
    OK — absence of evidence never pages.
    """

    def __init__(self, rules: list[dict], *, clock=time.time):
        self.rules = []
        for r in rules:
            if not isinstance(r, dict) or not r.get("name"):
                raise ValueError(f"SLO rule needs a name: {r!r}")
            kind = r.get("kind")
            if kind not in _RULE_KINDS:
                raise ValueError(
                    f"SLO rule {r['name']!r}: kind {kind!r} not in "
                    f"{_RULE_KINDS}")
            if kind == "quantile":
                missing = [k for k in ("metric", "q", "target")
                           if k not in r]
            else:
                missing = [k for k in ("total", "bad", "budget",
                                       "window_s", "max_burn")
                           if k not in r]
            if missing:
                raise ValueError(
                    f"SLO rule {r['name']!r} is missing {missing}")
            self.rules.append(dict(r))
        self._clock = clock
        self._ok: dict[str, bool] = {}
        self._hist: dict[str, collections.deque] = {
            r["name"]: collections.deque() for r in self.rules
            if r["kind"] == "burn_rate" or "window_s" in r}
        self._g_ok = core.gauge(
            "slo_ok", "1 while the rule holds, 0 in breach",
            labels=("slo",)) if core.enabled() else core.NULL
        self._g_val = core.gauge(
            "slo_value", "last measured value of the rule's objective",
            labels=("slo",)) if core.enabled() else core.NULL
        self._c_breach = core.counter(
            "slo_breaches_total", "ok -> breach transitions, per rule",
            labels=("slo",)) if core.enabled() else core.NULL
        self._c_recover = core.counter(
            "slo_recoveries_total", "breach -> ok transitions, per rule",
            labels=("slo",)) if core.enabled() else core.NULL

    def _eval_quantile(self, rule: dict, fleet: FleetRegistry,
                       now: float):
        sample = fleet.histogram(rule["metric"], rule.get("match"))
        if sample and "window_s" in rule:
            sample = self._windowed(rule, sample, now)
        if not sample or not sample.get("count"):
            return True, float("nan")
        v = estimate_quantile(sample, float(rule["q"]))
        return (not v > float(rule["target"])), v

    def _windowed(self, rule: dict, sample: dict, now: float) -> dict:
        """Trailing-window view of a cumulative histogram: keep a
        history of merged samples and return current minus the oldest
        one still inside ``window_s``.  A shrinking count (a source
        restarted) resets the history — the current cumulative sample
        IS the window then, same as a Prometheus counter reset."""
        hist = self._hist[rule["name"]]
        if hist and sample["count"] < hist[-1][1]["count"]:
            hist.clear()
        hist.append((now, sample))
        horizon = now - float(rule["window_s"])
        while len(hist) > 1 and hist[1][0] <= horizon:
            hist.popleft()
        base = hist[0][1]
        if base is sample:
            return sample
        try:
            return {"sum": sample["sum"] - base["sum"],
                    "count": sample["count"] - base["count"],
                    "inf": sample["inf"] - base["inf"],
                    "buckets": {k: sample["buckets"][k] - v
                                for k, v in base["buckets"].items()}}
        except KeyError:
            # bucket bounds changed under us (process restart with a
            # different config): fall back to the raw cumulative view
            return sample

    def _eval_burn(self, rule: dict, fleet: FleetRegistry, now: float):
        bad = fleet.total(rule["bad"], rule.get("match_bad"))
        total = fleet.total(rule["total"], rule.get("match_total"))
        hist = self._hist[rule["name"]]
        hist.append((now, bad, total))
        horizon = now - float(rule["window_s"])
        while len(hist) > 1 and hist[1][0] <= horizon:
            hist.popleft()
        t0, bad0, total0 = hist[0]
        dbad, dtotal = bad - bad0, total - total0
        if dtotal <= 0:
            return True, 0.0
        burn = (dbad / dtotal) / float(rule["budget"])
        return (not burn > float(rule["max_burn"])), burn

    def evaluate(self, fleet: FleetRegistry, now: float | None = None
                 ) -> list[dict]:
        """One evaluation round.  Returns one event per rule:
        ``{"slo", "kind", "ok", "value", "target", "changed"}`` —
        ``changed`` marks a breach/recovery TRANSITION, which is what
        increments the counters and lands ``slo.breach`` /
        ``slo.recover`` records in the span trail."""
        now = self._clock() if now is None else now
        events = []
        for rule in self.rules:
            name = rule["name"]
            if rule["kind"] == "quantile":
                ok, value = self._eval_quantile(rule, fleet, now)
                target = float(rule["target"])
            else:
                ok, value = self._eval_burn(rule, fleet, now)
                target = float(rule["max_burn"])
            prev = self._ok.get(name)
            changed = prev is not None and prev != ok
            self._ok[name] = ok
            self._g_ok.labels(slo=name).set(1 if ok else 0)
            if value == value:      # skip NaN (no data yet)
                self._g_val.labels(slo=name).set(value)
            if changed and not ok:
                self._c_breach.labels(slo=name).inc()
                trace.record_span("slo.breach", 0.0, slo=name,
                                  value=value, target=target)
            elif changed and ok:
                self._c_recover.labels(slo=name).inc()
                trace.record_span("slo.recover", 0.0, slo=name,
                                  value=value, target=target)
            elif prev is None and not ok:
                # first evaluation already in breach: still a breach
                # event — the fleet came up violating its objective.
                self._c_breach.labels(slo=name).inc()
                trace.record_span("slo.breach", 0.0, slo=name,
                                  value=value, target=target)
                changed = True
            events.append({"slo": name, "kind": rule["kind"], "ok": ok,
                           "value": value, "target": target,
                           "changed": changed})
        return events

    def breached(self) -> list[str]:
        """Names of the rules currently in breach."""
        return [n for n, ok in self._ok.items() if not ok]
