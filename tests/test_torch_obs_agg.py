"""The port's fleet aggregation and SLO engine
(``distlearn_tpu_torch/obs/agg.py``) against the JAX package's
(``distlearn_tpu/obs/agg.py``): the ``obs/agg.py`` cases of
``tests/test_obsplane.py`` run through both modules (merge and match,
windowed and cumulative quantiles, counter reset, burn rate, rule
validation), the two engines give the same events on one scripted
fleet, and a ``Collector`` of each package polls the other package's
``/snapshot`` endpoint."""

from __future__ import annotations

import json
import os
import time
import types

import pytest

torch = pytest.importorskip("torch")

from distlearn_tpu import obs as jobs  # noqa: E402
from distlearn_tpu.obs import agg as jagg  # noqa: E402
from distlearn_tpu.obs import core as jcore  # noqa: E402
from distlearn_tpu.obs import trace as jtrace  # noqa: E402
from distlearn_tpu_torch import obs as pobs  # noqa: E402
from distlearn_tpu_torch.obs import agg as pagg  # noqa: E402
from distlearn_tpu_torch.obs import core as pcore  # noqa: E402
from distlearn_tpu_torch.obs import trace as ptrace  # noqa: E402

from tests.net_util import reserve_port_window  # noqa: E402

PKGS = {"jax": types.SimpleNamespace(obs=jobs, agg=jagg, core=jcore,
                                     trace=jtrace),
        "port": types.SimpleNamespace(obs=pobs, agg=pagg, core=pcore,
                                      trace=ptrace)}
BOTH = pytest.mark.parametrize("pkg", sorted(PKGS))


@pytest.fixture()
def traced_obs():
    """Obs force-enabled with trace propagation on in both packages, a
    fresh registry and ring, everything restored after."""
    for m in PKGS.values():
        m.core.configure(True)
        m.core.REGISTRY.reset()
        m.trace.clear()
        m.trace.set_spill(None)
        m.trace.set_propagate(True)
    yield
    for m in PKGS.values():
        m.trace.set_propagate(None)
        m.trace.set_spill(None)
        m.trace.clear()
        m.core.REGISTRY.reset()
        m.core.configure(None)


def _snap(reg):
    return {"type": "snapshot", "ts": time.time(),
            "metrics": reg.snapshot()}


def test_port_obs_exports_the_fleet_half():
    for name in ("Collector", "FleetRegistry", "MergeError", "SLOEngine"):
        assert getattr(pobs, name) is getattr(pagg, name)
        assert name in pobs.__all__
    assert "not ported" not in pobs.__doc__


@BOTH
def test_fleet_registry_replace_not_add(traced_obs, pkg):
    m = PKGS[pkg]
    fleet = m.agg.FleetRegistry()
    reg = m.core.Registry()
    c = reg.counter("t_fleet_total")
    c.inc(3)
    fleet.ingest(_snap(reg), source="p0")
    c.inc(4)
    fleet.ingest(_snap(reg), source="p0")
    assert fleet.total("t_fleet_total") == 7
    reg2 = m.core.Registry()
    reg2.counter("t_fleet_total").inc(10)
    fleet.ingest(_snap(reg2), source="p1")
    assert fleet.total("t_fleet_total") == 17
    assert fleet.breakdown("t_fleet_total") == {"p0": 7.0, "p1": 10.0}
    fleet.forget("p1")
    assert fleet.total("t_fleet_total") == 7
    with pytest.raises(ValueError):
        fleet.ingest({"type": "span"}, source="p0")


@BOTH
def test_fleet_registry_merges_histograms_and_matches(traced_obs, pkg):
    m = PKGS[pkg]
    fleet = m.agg.FleetRegistry()
    for src, vals in (("p0", (0.05, 0.2)), ("p1", (0.05, 5.0))):
        reg = m.core.Registry()
        h = reg.histogram("t_fl_seconds", buckets=(0.1, 1.0))
        for v in vals:
            h.observe(v)
        reg.counter("t_out_total", labels=("outcome",)).labels(
            outcome="ok" if src == "p0" else "shed").inc(2)
        fleet.ingest(_snap(reg), source=src)
    merged = fleet.histogram("t_fl_seconds")
    assert merged["count"] == 4 and merged["inf"] == 1
    assert merged["buckets"] == {"0.1": 2, "1.0": 1}
    assert fleet.total("t_out_total", {"outcome": "ok"}) == 2
    assert fleet.total("t_out_total") == 4


def test_merge_error_and_quantiles_match_the_jax_module():
    """Bucket-bound skew raises in both; the estimated quantiles and the
    merged samples of a fleet fed to both registries are equal."""
    a = {"sum": 1.0, "count": 3, "buckets": {"0.1": 1, "1.0": 2}, "inf": 0}
    b = {"sum": 2.5, "count": 4, "buckets": {"0.1": 3, "1.0": 0}, "inf": 1}
    bad = {"sum": 0.0, "count": 0, "buckets": {"0.5": 0}, "inf": 0}
    assert pagg.merge_histograms(a, b) == jagg.merge_histograms(a, b)
    for mod in (pagg, jagg):
        with pytest.raises(mod.MergeError):
            mod.merge_histograms(a, bad)
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        m = pagg.merge_histograms(a, b)
        assert pagg.estimate_quantile(m, q) == jagg.estimate_quantile(m, q)
    assert pagg.estimate_quantile({"count": 0}, 0.5) != \
        pagg.estimate_quantile({"count": 0}, 0.5)       # nan, as JAX's
    regs = []
    for src, vals in (("p0", (0.05, 0.3, 2.0)), ("p1", (0.01,))):
        reg = jcore.Registry()
        h = reg.histogram("t_x_seconds", buckets=(0.1, 1.0),
                          labels=("replica",))
        for v in vals:
            h.labels(replica=src).observe(v)
        reg.gauge("t_depth").set(len(vals))
        regs.append((src, _snap(reg)))
    fleets = [jagg.FleetRegistry(), pagg.FleetRegistry()]
    for f in fleets:
        for src, rec in regs:
            f.ingest(rec, source=src)
    assert fleets[0].merged() == fleets[1].merged()
    assert fleets[0].histogram("t_x_seconds") == \
        fleets[1].histogram("t_x_seconds")
    assert fleets[0].breakdown("t_depth") == fleets[1].breakdown("t_depth")


@BOTH
def test_collector_polls_http_and_trail(traced_obs, tmp_path, pkg):
    """One poll round ingests a live /snapshot endpoint AND a JSONL
    trail; a dead endpoint counts a failure but leaves the rest of the
    fleet view intact."""
    m = PKGS[pkg]
    m.obs.counter("t_live_total").inc(5)
    srv = m.obs.start_http_server(0)
    trail = str(tmp_path / "replica.jsonl")
    reg = m.core.Registry()
    reg.counter("t_live_total").inc(7)
    with open(trail, "w") as fh:
        fh.write(json.dumps({"type": "span", "name": "x", "ts": 0,
                             "dur": 0}) + "\n")
        fh.write(json.dumps(_snap(reg)) + "\n")
    dead = reserve_port_window(1)
    try:
        coll = m.agg.Collector(endpoints=[("127.0.0.1", srv.port),
                                          ("127.0.0.1", dead)],
                               trails=[trail], timeout=0.5)
        fleet = coll.poll()
    finally:
        srv.close()
    assert fleet.total("t_live_total") == 12
    assert set(fleet.sources()) == {f"http://127.0.0.1:{srv.port}",
                                    os.path.basename(trail)}
    assert m.core.REGISTRY._families["obs_agg_polls_total"].value == 1
    fails = {s["labels"]["source"]: s["value"]
             for s in m.core.REGISTRY._families[
                 "obs_agg_poll_failures_total"].sample()}
    assert fails == {f"http://127.0.0.1:{dead}": 1}


@pytest.mark.parametrize("collector,exporter", [("port", "jax"),
                                                ("jax", "port")])
def test_collector_polls_the_other_package(traced_obs, collector, exporter):
    """A port Collector reads a JAX process's /snapshot and the reverse:
    the snapshot records are one schema, and the fleet views agree."""
    exp, col = PKGS[exporter], PKGS[collector]
    exp.obs.counter("t_cross_total", labels=("outcome",)).labels(
        outcome="complete").inc(3)
    h = exp.obs.histogram("t_cross_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 3.0):
        h.observe(v)
    col.obs.counter("t_cross_total", labels=("outcome",)).labels(
        outcome="complete").inc(4)
    srv_e = exp.obs.start_http_server(0)
    srv_c = col.obs.start_http_server(0)
    try:
        coll = col.agg.Collector(endpoints=[("127.0.0.1", srv_e.port),
                                            ("127.0.0.1", srv_c.port)])
        fleet = coll.poll()
        other = PKGS["jax" if collector == "port" else "port"].agg
        ofleet = other.Collector(endpoints=[("127.0.0.1", srv_e.port),
                                            ("127.0.0.1", srv_c.port)]
                                 ).poll()
    finally:
        srv_e.close()
        srv_c.close()
    assert fleet.total("t_cross_total", {"outcome": "complete"}) == 7
    assert fleet.breakdown("t_cross_total") == {
        f"http://127.0.0.1:{srv_e.port}": 3.0,
        f"http://127.0.0.1:{srv_c.port}": 4.0}
    hist = fleet.histogram("t_cross_seconds")
    assert hist["count"] == 3 and hist["inf"] == 1
    assert hist["buckets"] == {"0.1": 1, "1.0": 1}
    assert fleet.total("t_cross_total") == ofleet.total("t_cross_total")
    assert hist == ofleet.histogram("t_cross_seconds")


def _fleet_with_hist(m, observations, *, name="t_slo_seconds",
                     buckets=(0.1, 1.0), source="p0", fleet=None):
    fleet = fleet if fleet is not None else m.agg.FleetRegistry()
    reg = m.core.Registry()
    h = reg.histogram(name, buckets=buckets)
    for v in observations:
        h.observe(v)
    fleet.ingest(_snap(reg), source=source)
    return fleet


@BOTH
def test_slo_windowed_quantile_breaches_then_recovers(traced_obs, pkg):
    """A burst breaches the windowed p50; once the burst leaves the
    trailing window (no new samples), the rule recovers."""
    m = PKGS[pkg]
    slo = m.agg.SLOEngine([{"name": "lat", "kind": "quantile",
                            "metric": "t_slo_seconds", "q": 0.5,
                            "target": 0.1, "window_s": 5.0}])
    reg = m.core.Registry()
    h = reg.histogram("t_slo_seconds", buckets=(0.1, 1.0))
    fleet = m.agg.FleetRegistry()

    fleet.ingest(_snap(reg), source="p0")
    (e,) = slo.evaluate(fleet, now=0.0)
    assert e["ok"] and not e["changed"]         # no data: never pages

    for _ in range(10):
        h.observe(0.9)                          # the burst
    fleet.ingest(_snap(reg), source="p0")
    (e,) = slo.evaluate(fleet, now=2.0)
    assert not e["ok"] and e["changed"] and e["value"] > 0.1
    assert slo.breached() == ["lat"]
    (e,) = slo.evaluate(fleet, now=4.0)         # burst still in window
    assert not e["ok"] and not e["changed"]
    (e,) = slo.evaluate(fleet, now=8.0)         # burst aged out
    assert e["ok"] and e["changed"] and slo.breached() == []
    assert m.core.REGISTRY._families[
        "slo_breaches_total"].labels(slo="lat").value == 1
    assert m.core.REGISTRY._families[
        "slo_recoveries_total"].labels(slo="lat").value == 1
    names = [r["name"] for r in m.trace.spans()]
    assert names.count("slo.breach") == 1
    assert names.count("slo.recover") == 1


@BOTH
def test_slo_windowed_quantile_counter_reset(traced_obs, pkg):
    """A source restart (count shrinks) clears the window history and
    falls back to the fresh cumulative view instead of going negative."""
    m = PKGS[pkg]
    slo = m.agg.SLOEngine([{"name": "lat", "kind": "quantile",
                            "metric": "t_slo_seconds", "q": 0.5,
                            "target": 0.1, "window_s": 5.0}])
    fleet = _fleet_with_hist(m, [0.9] * 8)
    slo.evaluate(fleet, now=0.0)
    assert slo.breached() == ["lat"]
    fleet = _fleet_with_hist(m, [0.05, 0.05, 0.05])     # restarted source
    (e,) = slo.evaluate(fleet, now=1.0)
    assert e["ok"] and 0 < e["value"] <= 0.1


@BOTH
def test_slo_cumulative_quantile_and_burn_rate(traced_obs, pkg):
    """Without window_s the quantile is over everything ever observed;
    the burn-rate rule pages on the windowed bad/total ratio."""
    m = PKGS[pkg]
    slo = m.agg.SLOEngine([
        {"name": "lat", "kind": "quantile", "metric": "t_slo_seconds",
         "q": 0.95, "target": 1.0},
        {"name": "errs", "kind": "burn_rate", "total": "req_total",
         "bad": "bad_total", "budget": 0.1, "window_s": 10.0,
         "max_burn": 1.0},
    ])
    fleet = _fleet_with_hist(m, [0.05] * 20)
    reg = m.core.Registry()
    t, b = reg.counter("req_total"), reg.counter("bad_total")
    t.inc(100)
    b.inc(1)
    fleet.ingest(_snap(reg), source="p1")
    events = {e["slo"]: e for e in slo.evaluate(fleet, now=0.0)}
    assert events["lat"]["ok"] and events["errs"]["ok"]
    t.inc(100)
    b.inc(49)                                   # 49% of the new traffic
    fleet.ingest(_snap(reg), source="p1")
    events = {e["slo"]: e for e in slo.evaluate(fleet, now=5.0)}
    assert not events["errs"]["ok"]
    assert abs(events["errs"]["value"] - 4.9) < 1e-9
    assert events["lat"]["ok"]                  # cumulative p95 unmoved


@BOTH
def test_slo_rule_validation(pkg):
    agg = PKGS[pkg].agg
    with pytest.raises(ValueError):
        agg.SLOEngine([{"kind": "quantile"}])               # no name
    with pytest.raises(ValueError):
        agg.SLOEngine([{"name": "x", "kind": "nope"}])      # bad kind
    with pytest.raises(ValueError):
        agg.SLOEngine([{"name": "x", "kind": "quantile"}])  # missing keys
    with pytest.raises(ValueError):
        agg.SLOEngine([{"name": "x", "kind": "burn_rate",
                        "total": "a", "bad": "b"}])


def test_slo_engines_give_the_same_events(traced_obs):
    """One scripted fleet (a burst, a restart, errors) through both
    engines: every round's events are equal, NaN values included."""
    rules = [{"name": "w", "kind": "quantile", "metric": "t_slo_seconds",
              "q": 0.9, "target": 0.2, "window_s": 3.0},
             {"name": "c", "kind": "quantile", "metric": "t_slo_seconds",
              "q": 0.5, "target": 0.5},
             {"name": "b", "kind": "burn_rate", "total": "req_total",
              "bad": "bad_total", "budget": 0.05, "window_s": 4.0,
              "max_burn": 2.0}]
    engines = [jagg.SLOEngine(rules), pagg.SLOEngine(rules)]
    fleets = [jagg.FleetRegistry(), pagg.FleetRegistry()]
    reg = jcore.Registry()
    h = reg.histogram("t_slo_seconds", buckets=(0.1, 0.5, 1.0))
    t, b = reg.counter("req_total"), reg.counter("bad_total")
    script = [((), 0, 0), ((0.05,) * 5, 10, 0), ((0.8,) * 9, 20, 5),
              ((), 5, 0), ((), 0, 0), ((0.05,) * 3, 30, 1), ((), 0, 0)]
    for rnd, (obs_, dt, db) in enumerate(script):
        for v in obs_:
            h.observe(v)
        t.inc(dt)
        b.inc(db)
        rec = _snap(reg)
        out = []
        for eng, fleet in zip(engines, fleets):
            fleet.ingest(rec, source="p0")
            out.append(json.dumps(eng.evaluate(fleet, now=1.5 * rnd)))
        assert out[0] == out[1], rnd
    assert engines[0].breached() == engines[1].breached()
