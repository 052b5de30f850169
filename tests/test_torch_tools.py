"""The port's tools (``distlearn_tpu_torch/tools/``) against the root
``tools/`` of the JAX package: ``diststat`` and ``tracecat`` give the same
documents and text on a JAX-written trail, a port-written one and a
mixed fleet's (a port ``Router`` over a JAX and a port replica); the
failover, codec, membership and router tables of ``tests/test_ha.py``,
``tests/test_elastic.py`` and ``tests/test_router.py``; the autoscaler
cases of ``tests/test_obsplane.py`` with fake actuators, decision for
decision against the JAX tool's; ``ea_convergence``'s torch gradients
against the JAX tool's numpy ones; ``analyze_trace`` on a synthetic
Chrome trace; ``profile_resnet`` on the CPU; and the port's
``data.load_npz`` on ``tools/make_npz.py``'s output."""

from __future__ import annotations

import contextlib
import gzip
import io
import json
import math
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from distlearn_tpu.obs import core as jcore  # noqa: E402
from distlearn_tpu.obs import export as jexport  # noqa: E402
from distlearn_tpu.obs import trace as jtrace  # noqa: E402
from distlearn_tpu.utils.logging import set_verbose as jset_verbose  # noqa: E402
from distlearn_tpu_torch.obs import core as pcore  # noqa: E402
from distlearn_tpu_torch.obs import export as pexport  # noqa: E402
from distlearn_tpu_torch.obs import trace as ptrace  # noqa: E402
from distlearn_tpu_torch.tools import analyze_trace  # noqa: E402
from distlearn_tpu_torch.tools import autoscaler as pautoscaler  # noqa: E402
from distlearn_tpu_torch.tools import diststat as pdiststat  # noqa: E402
from distlearn_tpu_torch.tools import ea_convergence as pea_conv  # noqa: E402
from distlearn_tpu_torch.tools import tracecat as ptracecat  # noqa: E402
from distlearn_tpu_torch.utils.logging import set_verbose  # noqa: E402

from tests.net_util import reserve_port_window  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import autoscaler as jautoscaler  # noqa: E402
import diststat as jdiststat  # noqa: E402
import ea_convergence as jea_conv  # noqa: E402
import make_npz  # noqa: E402
import tracecat as jtracecat  # noqa: E402

set_verbose(False)
jset_verbose(False)

VOCAB, DIM, DEPTH, HEADS, MAX_LEN = 61, 32, 2, 4, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def traced_obs():
    for core, trace in ((jcore, jtrace), (pcore, ptrace)):
        core.configure(True)
        core.REGISTRY.reset()
        trace.clear()
        trace.set_spill(None)
        trace.set_propagate(True)
    yield
    for core, trace in ((jcore, jtrace), (pcore, ptrace)):
        trace.set_propagate(None)
        trace.set_spill(None)
        trace.set_process(None)
        trace.clear()
        core.REGISTRY.reset()
        core.configure(None)


@pytest.fixture(scope="module")
def jax_params():
    from distlearn_tpu.models.transformer import transformer_lm
    params, _ = transformer_lm(vocab=VOCAB, dim=DIM, depth=DEPTH,
                               heads=HEADS, max_len=MAX_LEN).init(
        jax.random.PRNGKey(0))
    return jax.device_get(params)


@pytest.fixture(scope="module")
def lm_params(jax_params):
    from distlearn_tpu_torch.models.convert import lm_from_jax
    return lm_from_jax(jax_params)


# -- trails written by each package -------------------------------------------

def _ea_params():
    return {"a": np.zeros((64, 3), np.float32),
            "b": np.zeros((7,), np.float32),
            "c": np.zeros((32, 32), np.float32),
            "d": np.zeros((5,), np.float32),
            "e": np.zeros((128,), np.float32)}


def _striped_sync(pkg: str, shards: int = 4, codec: str = "int8"):
    """One serial S-striped AsyncEA sync of the package's roles (an int8
    client by default: the codec families are written too)."""
    if pkg == "port":
        from distlearn_tpu_torch.parallel.async_ea import (AsyncEAClient,
                                                           AsyncEAServer)

        def tree():
            return {k: torch.from_numpy(v)
                    for k, v in _ea_params().items()}
        kw = {"device": "cpu"}
    else:
        from distlearn_tpu.parallel.async_ea import (AsyncEAClient,
                                                     AsyncEAServer)
        tree, kw = _ea_params, {}
    port = reserve_port_window(12)
    out = {}

    def client_fn():
        c = AsyncEAClient("127.0.0.1", port, node=1, tau=1, alpha=0.5,
                          sharded=True, codec=codec, **kw)
        p = c.init_client(tree())
        p = {k: v + 1.0 for k, v in p.items()}
        _, out["synced"] = c.sync_client(p)
        c.close()

    th = threading.Thread(target=client_fn, daemon=True)
    th.start()
    srv = AsyncEAServer("127.0.0.1", port, num_nodes=1, shards=shards, **kw)
    srv.init_server(tree())
    srv.sync_server(tree())
    th.join(timeout=60)
    assert not th.is_alive() and out["synced"]
    srv.close()


def _serve_server(lm_params, **kw):
    from distlearn_tpu_torch.serve import DecodeEngine, ServeServer
    eng = DecodeEngine(lm_params, num_slots=2, max_len=MAX_LEN, page=8,
                       device="cpu")
    return ServeServer(eng, idle_wait=0.01, **kw).start()


def _jax_serve_server(jax_params, **kw):
    from distlearn_tpu.serve import DecodeEngine, ServeServer
    eng = DecodeEngine(jax_params, num_slots=2, max_len=MAX_LEN, page=8)
    return ServeServer(eng, idle_wait=0.01, **kw).start()


@pytest.fixture()
def trails(traced_obs, tmp_path, lm_params, jax_params):
    """Three runs' trails: a JAX AsyncEA sync (JAX-written), a port
    AsyncEA sync (port-written), and a mixed serving fleet (a port Router
    over one JAX and one port replica; the JAX replica spills to its own
    trail, the router and the port replica to theirs)."""
    from distlearn_tpu_torch.serve import Router
    out = {k: str(tmp_path / f"{k}.jsonl")
           for k in ("jax_ea", "port_ea", "fleet_jax", "fleet_port")}
    for pkg, trace, export in (("jax", jtrace, jexport),
                               ("port", ptrace, pexport)):
        path = out[f"{pkg}_ea"]
        trace.set_process(f"{pkg}-ea")
        trace.set_spill(path)
        try:
            _striped_sync(pkg)
        finally:
            trace.set_spill(None)
        export.write_snapshot(path)
    for core in (jcore, pcore):
        core.REGISTRY.reset()
    jtrace.set_process("jax-replica")
    ptrace.set_process("router")
    jtrace.set_spill(out["fleet_jax"])
    ptrace.set_spill(out["fleet_port"])
    jx = _jax_serve_server(jax_params, max_queue=8, epoch=1)
    pt = _serve_server(lm_params, max_queue=8, epoch=1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, VOCAB, size=int(rng.integers(3, 9)))
               .astype(np.int32) for _ in range(6)]
    try:
        with Router([(jx.host, jx.port), (pt.host, pt.port)],
                    health_ttl=0.02, retry_interval=0.01,
                    dial_deadline=1.0) as router:
            got = [router.generate(p, 4, rid=f"m{i}")
                   for i, p in enumerate(prompts[:3])]
            jx.stop()
            got += [router.generate(p, 4, rid=f"n{i}")
                    for i, p in enumerate(prompts[3:])]
    finally:
        jx.stop()
        pt.stop()
        jtrace.set_spill(None)
        ptrace.set_spill(None)
    assert all(r["reason"] == "complete" for r in got)
    jexport.write_snapshot(out["fleet_jax"])
    pexport.write_snapshot(out["fleet_port"])
    out["rids"] = [r["rid"] for r in got]
    return out


def _run_main(main, argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_diststat_and_tracecat_match_the_jax_tools_on_both_packages_trails(
        trails):
    """Every subcommand of diststat (JSON and text) and tracecat over the
    JAX-written, the port-written and the mixed fleet's trails: the
    port's tools print exactly what the JAX tools print."""
    ea = [trails["jax_ea"], trails["port_ea"]]
    fleet = [trails["fleet_jax"], trails["fleet_port"]]
    cases = []
    for paths in ([ea[0]], [ea[1]], ea, fleet, [fleet[1]]):
        for fmt in ("json", "text"):
            cases.append(["summarize", *paths, "--format", fmt])
            cases.append(["merge", *paths, "--format", fmt])
    for fmt in ("json", "text"):
        cases.append(["diff", ea[0], ea[1], "--format", fmt])
    for argv in cases:
        rj, oj = _run_main(jdiststat.main, argv)
        rp, op = _run_main(pdiststat.main, argv)
        assert rj == rp == 0 and oj == op, argv
        if "json" in argv:
            json.loads(op.replace("NaN", "null"))
    for paths in (ea, fleet):
        for argv in (["list", *paths], ["show", *paths],
                     ["show", *paths, "--format", "json"]):
            rj, oj = _run_main(jtracecat.main, argv)
            rp, op = _run_main(ptracecat.main, argv)
            assert rj == rp == 0 and oj == op, argv
    # the codec table read from each package's int8 sync: 4 stripes, one
    # encode and one fused apply each
    for path in ea:
        tab = pdiststat.summarize_run([path])["codec"]["stripes"]
        assert sorted(tab) == ["0", "1", "2", "3"], path
        assert all(r["encodes"] == 1 and r["applies"] == 1
                   for r in tab.values()), (path, tab)


@pytest.mark.parametrize("codec", ["raw", "fp16", "int8"])
def test_codec_table_counts_as_the_jax_package_in_each_codec(
        traced_obs, tmp_path, codec):
    """The codec families mean what the JAX package's mean, whatever the
    client's codec (``wire_encode_seconds``: every lossy encode;
    ``center_apply_seconds``: every lossy payload applied undecoded), so
    a mixed fleet sums one definition: each package's S = 4 sync gives
    the same counts, and a raw sync none."""
    tabs = {}
    for pkg, trace, export in (("jax", jtrace, jexport),
                               ("port", ptrace, pexport)):
        path = str(tmp_path / f"{pkg}.jsonl")
        trace.set_spill(path)
        try:
            _striped_sync(pkg, codec=codec)
        finally:
            trace.set_spill(None)
        export.write_snapshot(path)
        mod = jdiststat if pkg == "jax" else pdiststat
        tabs[pkg] = {k: (r["encodes"], r["applies"]) for k, r in
                     mod.summarize_run([path])["codec"].get(
                         "stripes", {}).items()}
    want = {} if codec == "raw" else {str(i): (1, 1) for i in range(4)}
    assert tabs["port"] == tabs["jax"] == want, tabs


def test_mixed_fleet_requests_are_one_stitched_trace_each(trails):
    """Across the two trails every routed request is one trace rooted at
    the port router's ``router.generate``, with the serving replica's
    TTFT span (JAX or port) hanging off it."""
    spans = ptracecat.load_spans([trails["fleet_jax"],
                                  trails["fleet_port"]])
    traces = ptracecat.group_traces(spans)
    assert len(traces) == len(trails["rids"]) == 6
    procs = set()
    for tid, recs in traces.items():
        roots, _ = ptracecat.build_tree(recs)
        assert [r["name"] for r in roots] == ["router.generate"], tid
        ttft = [r for r in recs if r["name"] == "serve.ttft"]
        assert len(ttft) == 1 and ttft[0]["parent"] == roots[0]["span"]
        procs |= {r.get("proc") for r in ttft}
        assert ptracecat.critical_path(recs)[0]["name"] == "router.generate"
    assert procs == {"jax-replica", "router"}
    doc = pdiststat.merge_runs([trails["fleet_jax"], trails["fleet_port"]])
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        jdiststat.merge_runs([trails["fleet_jax"], trails["fleet_port"]]),
        sort_keys=True)
    assert doc["counters"]["router_dispatch_total"]["total"] >= 6


def test_tracecat_cli_stitches_multiple_trails(tmp_path):
    """list/show over two trails joins spans by trace id, through the
    port's CLI (``python -m distlearn_tpu_torch.tools.tracecat``)."""
    t0 = time.time()
    a, b = str(tmp_path / "router.jsonl"), str(tmp_path / "replica.jsonl")
    with open(a, "w") as fh:
        fh.write(json.dumps({
            "type": "span", "name": "router.generate", "ts": t0 + 0.1,
            "dur": 0.1, "trace": "ab" * 8, "span": "11111111",
            "proc": "router"}) + "\n")
    with open(b, "w") as fh:
        fh.write(json.dumps({
            "type": "span", "name": "serve.ttft", "ts": t0 + 0.08,
            "dur": 0.06, "trace": "ab" * 8, "span": "22222222",
            "parent": "11111111", "proc": "replica"}) + "\n")
    mod = [sys.executable, "-m", "distlearn_tpu_torch.tools.tracecat"]
    out = subprocess.run(mod + ["list", a, b], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert "ab" * 8 in out.stdout and "2" in out.stdout
    out = subprocess.run(mod + ["show", a, b, "--format", "json"],
                         capture_output=True, text=True, check=True,
                         cwd=ROOT)
    doc = json.loads(out.stdout)
    assert doc["summary"]["trace"] == "ab" * 8
    assert doc["summary"]["spans"] == 2
    assert doc["critical_path"] == ["11111111", "22222222"]
    assert sorted(doc["summary"]["procs"]) == ["replica", "router"]


# -- diststat: the JAX tool's own cases and the fleet tables -------------------

def _fixture_run(path, syncs=3, base_dur=0.010):
    """tests/test_tools.py's structurally complete run: spans (one
    errored), two snapshots (the LAST counts), counters with and without
    labels, a gauge, a histogram, a torn tail line."""
    recs = []
    for i in range(syncs):
        recs.append({"type": "span", "name": "async_ea.handshake",
                     "ts": 1000.0 + i, "dur": base_dur * (i + 1),
                     "labels": {"cid": 1}})
    recs.append({"type": "span", "name": "async_ea.handshake",
                 "ts": 1000.5, "dur": 0.5, "err": "TimeoutError"})

    def mk(n):
        return {"type": "snapshot", "ts": 2000.0 + n, "metrics": [
            {"name": "async_ea_syncs_total", "kind": "counter", "help": "",
             "labelnames": [], "samples": [{"labels": {}, "value": n}]},
            {"name": "transport_bytes_sent_total", "kind": "counter",
             "help": "", "labelnames": ["conn"],
             "samples": [{"labels": {"conn": "0"}, "value": 100 * n},
                         {"labels": {"conn": "1"}, "value": 50 * n}]},
            {"name": "async_ea_inflight", "kind": "gauge", "help": "",
             "labelnames": [], "samples": [{"labels": {}, "value": 0}]},
            {"name": "transport_frame_recv_seconds", "kind": "histogram",
             "help": "", "labelnames": [],
             "samples": [{"labels": {}, "sum": 0.25 * n, "count": 5 * n,
                          "buckets": {"0.001": 2 * n, "1.0": 3 * n},
                          "inf": 0}]}]}
    recs.append(mk(1))
    recs.append(mk(syncs))
    with open(path, "w") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
        fh.write("{torn line\n")


def test_diststat_summarize(tmp_path, capsys):
    log = str(tmp_path / "run.jsonl")
    _fixture_run(log, syncs=3)
    assert pdiststat.main(["summarize", log, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    hs = doc["spans"]["async_ea.handshake"]
    assert hs["count"] == 4 and hs["errors"] == 1
    assert abs(hs["p50"] - 0.030) < 1e-9
    assert abs(hs["p95"] - 0.5) < 1e-9
    assert doc["counter_totals"]["async_ea_syncs_total"] == 3
    assert doc["counter_totals"]["transport_bytes_sent_total"] == 450
    assert doc["counters"]['transport_bytes_sent_total{conn="0"}'] == 300
    assert doc["gauges"]["async_ea_inflight"] == 0
    assert doc["histograms"]["transport_frame_recv_seconds"]["count"] == 15
    assert pdiststat.main(["summarize", log]) == 0
    out = capsys.readouterr().out
    assert "async_ea.handshake" in out and "p95" in out


def test_diststat_summarize_merges_files_and_diffs(tmp_path, capsys):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _fixture_run(a, syncs=2, base_dur=0.010)
    _fixture_run(b, syncs=3, base_dur=0.020)
    doc = pdiststat.summarize_run([a, b])
    assert doc["spans"]["async_ea.handshake"]["count"] == 7
    assert doc["counter_totals"]["async_ea_syncs_total"] == 5
    assert pdiststat.main(["diff", a, b, "--format", "json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["counters"]["async_ea_syncs_total"] == \
        {"a": 2, "b": 3, "delta": 1}
    assert doc["spans"]["async_ea.handshake"]["count"] == {"a": 3, "b": 4}
    assert pdiststat.main([]) == 2
    assert pdiststat.main(["summarize", str(tmp_path / "none.jsonl")]) == 2


def _counter(name, value, labels=None, labelnames=()):
    return {"name": name, "kind": "counter", "help": "",
            "labelnames": list(labelnames),
            "samples": [{"labels": labels or {}, "value": value}]}


def _histogram(name, rows, labelnames=("shard",)):
    return {"name": name, "kind": "histogram", "help": "",
            "labelnames": list(labelnames),
            "samples": [{"labels": lb, "sum": s, "count": c}
                        for lb, s, c in rows]}


def _write(tmp_path, recs) -> str:
    log = tmp_path / "run.jsonl"
    log.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return str(log)


def _tables(path):
    doc = pdiststat.summarize_run([path])
    assert json.dumps(doc, sort_keys=True) == json.dumps(
        jdiststat.summarize_run([path]), sort_keys=True)
    return doc


def test_diststat_failover_table(tmp_path):
    """tests/test_ha.py's failover oracle through the port's diststat."""
    log = _write(tmp_path, [
        {"type": "span", "name": "async_ea.promote", "ts": 1.0, "dur": 0.2},
        {"type": "span", "name": "async_ea.failover", "ts": 1.1,
         "dur": 0.5},
        {"type": "span", "name": "async_ea.failover", "ts": 1.2,
         "dur": 0.1},
        {"type": "snapshot", "ts": 2.0, "metrics": [
            _counter("async_ea_evictions_total", 3),
            _counter("async_ea_rejoins_total", 3),
            _counter("async_ea_failover_redials_total", 4),
            _counter("async_ea_failover_promotions_total", 1),
            _counter("center_ckpt_saves_total", 7),
            {"name": "async_ea_failover_replays_total", "kind": "counter",
             "help": "", "labelnames": ["outcome"],
             "samples": [{"labels": {"outcome": "replayed"}, "value": 2},
                         {"labels": {"outcome": "clean"}, "value": 1}]},
        ]},
    ])
    tab = _tables(log)["failover"]
    assert tab["evictions"] == 3 and tab["rejoins"] == 3
    assert tab["redials"] == 4 and tab["promotions"] == 1
    assert tab["ckpt_saves"] == 7
    assert tab["replays"] == {"clean": 1, "replayed": 2}
    assert tab["latency"]["async_ea.promote"]["count"] == 1
    assert tab["latency"]["async_ea.failover"]["p50"] == pytest.approx(0.1)
    empty = _write(tmp_path, [{"type": "snapshot", "ts": 1.0, "metrics": [
        _counter("async_ea_syncs_total", 5)]}])
    assert _tables(empty)["failover"] == {}
    assert _tables(empty)["codec"] == {}
    assert _tables(empty)["membership"] == {}


def test_diststat_codec_table(tmp_path):
    """tests/test_ha.py's codec oracle through the port's diststat."""
    log = _write(tmp_path, [{"type": "snapshot", "ts": 2.0, "metrics": [
        _histogram("wire_encode_seconds",
                   [({"shard": "0"}, 0.4, 4), ({"shard": "1"}, 0.2, 2),
                    ({"shard": "all"}, 0.9, 3)]),
        _histogram("center_apply_seconds",
                   [({"shard": "0"}, 0.08, 4), ({"shard": "all"}, 0.3, 3)]),
        {"name": "wire_zero_copy_total", "kind": "counter", "help": "",
         "labelnames": ["result"],
         "samples": [{"labels": {"result": "hit"}, "value": 9},
                     {"labels": {"result": "miss"}, "value": 1}]},
    ]}])
    tab = _tables(log)["codec"]
    st = tab["stripes"]
    assert list(st) == ["0", "1", "all"]
    assert st["0"]["encodes"] == 4
    assert st["0"]["encode_mean"] == pytest.approx(0.1)
    assert st["0"]["applies"] == 4
    assert st["0"]["apply_mean"] == pytest.approx(0.02)
    assert st["1"]["encodes"] == 2 and st["1"]["applies"] == 0
    assert math.isnan(st["1"]["apply_mean"])
    assert st["all"]["encode_mean"] == pytest.approx(0.3)
    assert tab["zero_copy"] == {"hit": 9, "miss": 1, "hit_ratio": 0.9}


def _fam(name, value, kind="counter", labels=None, labelnames=()):
    return {"name": name, "kind": kind, "help": "",
            "labelnames": list(labelnames),
            "samples": [{"labels": labels or {}, "value": value}]}


def test_diststat_membership_table(tmp_path):
    """tests/test_elastic.py's membership oracle."""
    log = _write(tmp_path, [
        {"type": "span", "name": "async_ea.join", "ts": 1.0, "dur": 0.2},
        {"type": "span", "name": "async_ea.leave", "ts": 1.5, "dur": 0.1},
        {"type": "snapshot", "ts": 2.0, "metrics": [
            _fam("async_ea_membership_joins_total", 2),
            _fam("async_ea_membership_join_failures_total", 1),
            {"name": "async_ea_membership_leaves_total", "kind": "counter",
             "help": "", "labelnames": ["outcome"],
             "samples": [{"labels": {"outcome": "flushed"}, "value": 1},
                         {"labels": {"outcome": "clean"}, "value": 1}]},
            _fam("async_ea_membership_size", 2, kind="gauge"),
            _fam("async_ea_adaptive_tau", 9, kind="gauge",
                 labels={"cid": "1"}, labelnames=["cid"]),
        ]},
    ])
    tab = _tables(log)["membership"]
    assert tab["joins"] == 2 and tab["join_failures"] == 1
    assert tab["leaves"] == {"clean": 1, "flushed": 1}
    assert tab["fleet_size"] == 2
    assert tab["adaptive_tau"] == {"1": 9}
    assert tab["latency"]["async_ea.join"]["count"] == 1


def test_diststat_router_table(tmp_path):
    """tests/test_router.py's router oracle."""
    log = _write(tmp_path, [
        {"type": "span", "name": "router.failover", "ts": 1.0, "dur": 0.3},
        {"type": "span", "name": "router.failover", "ts": 1.4, "dur": 0.1},
        {"type": "span", "name": "router.hedge", "ts": 1.6, "dur": 0.2},
        {"type": "snapshot", "ts": 2.0, "metrics": [
            {"name": "router_dispatch_total", "kind": "counter",
             "help": "", "labelnames": ["replica"],
             "samples": [{"labels": {"replica": "r0"}, "value": 5},
                         {"labels": {"replica": "r1"}, "value": 3}]},
            _fam("router_retries_total", 2, labels={"replica": "r0"},
                 labelnames=["replica"]),
            _fam("router_shed_total", 4),
            _fam("router_hedges_total", 1, labels={"replica": "r1"},
                 labelnames=["replica"]),
        ]},
    ])
    tab = _tables(log)["router"]
    assert tab["dispatch"] == {"r0": 5, "r1": 3}
    assert tab["retries"] == 2 and tab["sheds"] == 4
    assert tab["hedges"] == 1
    assert "fence_violations" not in tab
    assert tab["latency"]["failover"]["count"] == 2
    assert tab["latency"]["failover"]["p50"] == pytest.approx(0.1)
    assert tab["latency"]["hedge"]["count"] == 1
    empty = _write(tmp_path, [{"type": "snapshot", "ts": 1.0, "metrics": [
        _fam("serve_requests_total", 5, labels={"outcome": "complete"},
             labelnames=["outcome"])]}])
    assert _tables(empty)["router"] == {}


# -- autoscaler -----------------------------------------------------------------

class _ScriptedPlane:
    """tests/test_obsplane.py's collector+SLO pair scripted per round."""

    def __init__(self, agg, script):
        self.script = list(script)
        self.fleet = agg.FleetRegistry()

    def poll(self):
        return self.fleet

    def evaluate(self, fleet):
        bad = self.script.pop(0) if self.script else []
        return [{"slo": n, "kind": "quantile", "ok": n not in bad,
                 "value": 1.0, "target": 0.1, "changed": False}
                for n in ("ttft", "ignored")]


def _scale_run(mod, agg, core, script, clocks, *, initial, min_size,
               max_size, cooldown_s):
    clk = {"t": 0.0}
    spawned, retired = [], []
    act = mod.Actuator(
        spawn=lambda: spawned.append(len(spawned)) or len(spawned),
        retire=retired.append, min_size=min_size, max_size=max_size,
        initial=initial)
    plane = _ScriptedPlane(agg, script)
    scaler = mod.Autoscaler(plane, plane, act, scale_on={"ttft"},
                            cooldown_s=cooldown_s, clock=lambda: clk["t"])
    reports = []
    for t in clocks:
        clk["t"] = t
        reports.append(scaler.step())
    fam = core.REGISTRY._families
    events = {d: fam["autoscaler_scale_events_total"].labels(
        direction=d).value for d in ("up", "down")} \
        if "autoscaler_scale_events_total" in fam else {}
    return reports, retired, act.size, events


@pytest.mark.parametrize("case", ["breach_then_cooldown", "unwatched"])
def test_autoscaler_decisions_match_the_jax_tool(traced_obs, case):
    """The scripted planes of tests/test_obsplane.py through both
    autoscalers: every round's report, the retire order, the final size
    and the scale-event counters are equal."""
    from distlearn_tpu.obs import agg as jagg
    from distlearn_tpu_torch.obs import agg as pagg
    if case == "breach_then_cooldown":
        kw = dict(script=[["ttft"]] * 3 + [[]] * 5,
                  clocks=[0.0, 1.0, 2.0, 5.0, 13.0, 14.0, 24.0, 40.0],
                  initial=1, min_size=1, max_size=3, cooldown_s=10.0)
    else:
        kw = dict(script=[["ignored"], [], []], clocks=[0.0, 100.0, 101.0],
                  initial=2, min_size=1, max_size=3, cooldown_s=0.1)
    got = _scale_run(pautoscaler, pagg, pcore, **kw)
    want = _scale_run(jautoscaler, jagg, jcore, **kw)
    assert got == want
    reports, retired, size, events = got
    if case == "breach_then_cooldown":
        assert [r["action"] for r in reports] == \
            ["up", "up", "hold", "hold", "down", "hold", "down", "hold"]
        assert retired == [2, 1] and size == 1
        assert events == {"up": 2, "down": 2}
        names = [r["name"] for r in ptrace.spans()]
        assert names.count("autoscaler.scale_up") == 2
        assert names.count("autoscaler.scale_down") == 2
    else:
        assert all(r["action"] == "hold" for r in reports) and size == 2
    with pytest.raises(ValueError):
        pautoscaler.Actuator(spawn=lambda: 1, retire=lambda h: None,
                             min_size=3, max_size=2)


def test_fixed_fleet_unaffected_when_autoscaler_disabled(traced_obs,
                                                         lm_params,
                                                         jax_params):
    """A disabled port autoscaler never polls, evaluates or touches the
    router; the port fleet decodes JAX's greedy streams."""
    from distlearn_tpu.models.transformer import greedy_generate
    from distlearn_tpu_torch.serve import Router

    class _Untouchable:
        def __getattr__(self, name):
            raise AssertionError(f"disabled autoscaler used .{name}")

    act = pautoscaler.Actuator(
        spawn=lambda: (_ for _ in ()).throw(AssertionError("spawned")),
        retire=lambda h: (_ for _ in ()).throw(AssertionError("retired")),
        min_size=1, max_size=4, initial=1)
    scaler = pautoscaler.Autoscaler(_Untouchable(), _Untouchable(), act,
                                    enabled=False)
    prompts = [np.array([3, 1, 4], np.int32), np.array([2, 7], np.int32)]
    refs = [np.asarray(greedy_generate(jax_params, p[None], 4))[0].tolist()
            for p in prompts]
    srv = _serve_server(lm_params)
    try:
        with Router([(srv.host, srv.port)], health_ttl=0.02,
                    retry_interval=0.01, dial_deadline=1.0) as router:
            for i, p in enumerate(prompts):
                assert scaler.step() == {"action": "disabled", "size": 1,
                                         "breached": [], "events": []}
                assert router.generate(p, 4, rid=f"q{i}")["tokens"] == \
                    refs[i]
            assert len(router.replica_names()) == 1
    finally:
        srv.stop()
    pcore.configure(False)
    try:
        s2 = pautoscaler.Autoscaler(_Untouchable(), _Untouchable(), act,
                                    enabled=True)
        assert s2.step()["action"] == "disabled"
    finally:
        pcore.configure(True)


def test_autoscaler_cli_dry_run_matches_the_jax_tool(tmp_path):
    """The CLI monitor, rules from JSON and a trail as the fleet: the
    port's reports equal the JAX tool's, round for round."""
    trail = str(tmp_path / "p0.jsonl")
    reg = pcore.Registry()
    h = reg.histogram("serve_ttft_seconds", buckets=(0.025, 0.1, 1.0))
    for _ in range(10):
        h.observe(0.9)
    with open(trail, "w") as fh:
        fh.write(json.dumps({"type": "snapshot", "ts": time.time(),
                             "metrics": reg.snapshot()}) + "\n")
    rules = str(tmp_path / "slo.json")
    with open(rules, "w") as fh:
        json.dump([{"name": "ttft-p95", "kind": "quantile",
                    "metric": "serve_ttft_seconds", "q": 0.95,
                    "target": 0.05}], fh)
    args = ["--trail", trail, "--rules", rules, "--interval", "0",
            "--rounds", "2"]
    env = {**os.environ, "DISTLEARN_OBS": "1", "JAX_PLATFORMS": "cpu"}
    outs = [subprocess.run(cmd + args, capture_output=True, text=True,
                           check=True, env=env, cwd=ROOT).stdout
            for cmd in ([sys.executable, "-m",
                         "distlearn_tpu_torch.tools.autoscaler"],
                        [sys.executable,
                         os.path.join(ROOT, "tools", "autoscaler.py")])]
    reports = [[json.loads(ln) for ln in o.splitlines() if ln]
               for o in outs]
    assert reports[0] == reports[1]
    assert len(reports[0]) == 2
    assert reports[0][0]["action"] == "up"
    assert reports[0][0]["breached"] == ["ttft-p95"]


# -- ea_convergence -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_ea_convergence_gradients_match_the_jax_tool(seed):
    """The torch MLP's loss and hand-written gradients against the JAX
    tool's numpy ones, on the same init and batch, within 1e-6."""
    side, hidden, batch = 16, 256, 64
    xs, ys = jea_conv.synthetic_hard(512, (side, side, 1), 4, seed=seed,
                                     label_noise=0.05)
    xs = xs.reshape(len(xs), -1)
    idx = np.random.RandomState(100 + seed).randint(0, len(xs), batch)
    pj = jea_conv.init_mlp(side * side, hidden, 4, seed=7)
    pp = pea_conv.init_mlp(side * side, hidden, 4, seed=7, device="cpu")
    for k in pj:
        np.testing.assert_array_equal(pp[k].numpy(), pj[k])
    lj, gj = jea_conv.mlp_loss_grads(pj, xs[idx], ys[idx])
    lp, gp = pea_conv.mlp_loss_grads(
        pp, torch.from_numpy(xs[idx]),
        torch.from_numpy(ys[idx].astype(np.int64)))
    assert abs(float(lp) - lj) <= 1e-6
    for k in gj:
        assert gp[k].dtype == torch.float32
        np.testing.assert_allclose(gp[k].numpy(), gj[k], rtol=0, atol=1e-6)


def test_ea_convergence_tool_runs_on_the_cpu(tmp_path):
    """The harness end to end, as tests/test_tools.py runs the JAX tool
    (2 ranks, 1.5-s budget, throttled links), with ``--device cpu``."""
    r = subprocess.run(
        [sys.executable, "-m", "distlearn_tpu_torch.tools.ea_convergence",
         "--ranks", "2", "--budget", "1.5", "--linkMBs", "50", "--out",
         str(tmp_path), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-800:]
    assert "sgd" in r.stdout and "ea_tau16" in r.stdout
    files = os.listdir(tmp_path)
    assert any(f.startswith("sgd") for f in files), files
    assert any(f.startswith("ea_tau") for f in files), files
    for line in r.stdout.splitlines():
        if "final_loss=" in line:
            assert math.isfinite(float(line.split("final_loss=")[1]
                                       .split()[0]))


def test_ea_convergence_ea_rounds_count_every_rank():
    """``run_algo`` reports each rank's elastic rounds (flush rounds
    included): every rank ran at least one, and SGD reports none."""
    import socket
    from contextlib import closing

    def port():
        with closing(socket.socket()) as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    res = pea_conv.run_algo("ea", 2, 0.3, port(), None, tau=2, alpha=0.3,
                            hidden=32, device="cpu")
    assert len(res) == 2 and all(r[2] >= 1 for r in res)
    assert all(math.isfinite(r[1]) for r in res)
    res = pea_conv.run_algo("sgd", 2, 0.2, port(), None, hidden=32,
                            device="cpu")
    assert all(r[2] == 0 for r in res)


# -- analyze_trace and profile_resnet -------------------------------------------

def _chrome_trace(path, gz=False):
    ev = [{"ph": "M", "name": "process_name", "pid": 0,
           "args": {"name": "python"}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 0,
           "tid": 1, "ts": 0, "dur": 500.0},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "pid": 0, "tid": 1, "ts": 1, "dur": 5.0}]
    kernels = [("sm90_xmma_gemm_f32f32_tf32f32", 400.0),
               ("void cudnn::conv2d_grouped_direct_kernel", 100.0),
               ("sgd_chunk", 20.0), ("sgd_chunk", 20.0),
               ("flash_fwd_mma<64>", 60.0), ("flash_bwd_dkv_mma<64>", 80.0),
               ("flash_bwd_dq", 40.0), ("quant_ef_leaves", 5.0),
               ("amax_leaves", 5.0), ("dequant_add_leaves", 10.0),
               ("elastic_vec4", 10.0),
               ("void at::native::vectorized_elementwise_kernel<4>", 150.0),
               ("void at::native::reduce_kernel<512, 1>", 100.0)]
    for i, (name, dur) in enumerate(kernels):
        ev.append({"ph": "X", "cat": "kernel", "name": name, "pid": 1,
                   "tid": 7, "ts": 10 * i, "dur": dur})
    ev.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
               "pid": 1, "tid": 8, "ts": 0, "dur": 0.0})
    opener = gzip.open if gz else open
    with opener(path, "wt") as fh:
        json.dump({"traceEvents": ev}, fh)
    return sum(d for _, d in kernels), len(kernels) + 1


@pytest.mark.parametrize("gz", [False, True])
def test_analyze_trace_groups_device_kernels(tmp_path, gz):
    path = str(tmp_path / ("t.json.gz" if gz else "trace.json"))
    total, n = _chrome_trace(path, gz)
    kernels = analyze_trace.load_kernels(analyze_trace.find_trace(
        str(tmp_path)))
    assert len(kernels) == n                # host ops and runtime left out
    doc = analyze_trace.attribute(kernels)
    assert doc["total_us"] == pytest.approx(total)
    cls = doc["classes"]
    assert cls["gemm/convolution"]["us"] == pytest.approx(500.0)
    assert cls["B1 fused_sgd"] == {"us": 40.0, "share": 40.0 / total,
                                   "launches": 2}
    assert cls["B2 fused_elastic"]["launches"] == 1
    assert cls["B3 quantize_ef"]["launches"] == 2
    assert cls["B4 dequant_add"]["launches"] == 1
    for c in ("B5a flash forward", "B5b flash dK/dV", "B5c flash dQ"):
        assert cls[c]["launches"] == 1
    assert cls["elementwise/reduce"]["us"] == pytest.approx(250.0)
    assert cls["copy"]["launches"] == 1
    assert sum(r["share"] for r in cls.values()) == pytest.approx(1.0)
    assert list(cls)[0] == "gemm/convolution"       # largest first
    assert doc["names"][0][0] == "sm90_xmma_gemm_f32f32_tf32f32"
    assert analyze_trace.classify("flash_fwd") == "B5a flash forward"
    rc, out = _run_main(analyze_trace.main, [str(tmp_path), "--top", "3"])
    assert rc == 0 and "B1 fused_sgd" in out and "top 3 kernels" in out
    assert f"({n} launches)" in out


def test_analyze_trace_without_kernels_exits(tmp_path):
    with open(tmp_path / "trace.json", "w") as fh:
        json.dump({"traceEvents": [{"ph": "X", "cat": "cpu_op",
                                    "name": "aten::mm", "dur": 3.0}]}, fh)
    with pytest.raises(SystemExit):
        analyze_trace.main([str(tmp_path)])


def test_profile_resnet_on_the_cpu(tmp_path):
    """``profile_resnet --device cpu`` at batch 2: a float32 ResNet-50
    fused SGD step profiled through the settled ``utils/profiling.trace``
    window; the Chrome trace holds the step's host ops (no kernels on the
    CPU, so analyze_trace has nothing to attribute)."""
    r = subprocess.run(
        [sys.executable, "-m", "distlearn_tpu_torch.tools.profile_resnet",
         str(tmp_path), "--batch", "2", "--steps", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-800:]
    assert "float32 compute on cpu" in r.stdout
    with open(tmp_path / "trace.json") as fh:
        ev = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in ev}
    assert any("convolution" in n for n in names)
    assert analyze_trace.load_kernels(str(tmp_path / "trace.json")) == []


# -- make_npz's output through both packages' load_npz ---------------------------

def test_load_npz_matches_the_jax_package_on_make_npz_output(tmp_path):
    from distlearn_tpu.data import load_npz as jload
    from distlearn_tpu_torch.data import load_npz as pload
    rng = np.random.RandomState(1)
    d = tmp_path / "cifar-10-batches-py"
    d.mkdir()
    for i in range(1, 6):
        data = rng.randint(0, 256, (3, 3 * 32 * 32)).astype(np.uint8)
        with open(d / f"data_batch_{i}", "wb") as fh:
            pickle.dump({b"data": data,
                         b"labels": rng.randint(0, 10, 3).tolist()}, fh)
    with open(d / "test_batch", "wb") as fh:
        pickle.dump({b"data": data, b"labels": [1, 2, 3]}, fh)
    out = str(tmp_path / "cifar10.npz")
    assert make_npz.main(["cifar10", str(tmp_path), "-o", out]) == 0
    for path in (out, str(tmp_path / "cifar10_test.npz")):
        xj, yj, nj = jload(path)
        xp, yp, np_ = pload(path)
        assert nj == np_ and xp.dtype == xj.dtype and yp.dtype == yj.dtype
        np.testing.assert_array_equal(xp, xj)
        np.testing.assert_array_equal(yp, yj)


# -- the settled profiler window (utils/profiling.py) ----------------------------

def test_profiling_trace_settles_inside_the_window(monkeypatch, tmp_path):
    """``utils/profiling.trace`` (what profile_resnet and ``examples/lm.py
    --profile`` open) synchronizes and pauses ``SETTLE_S`` with the
    profiler already recording, before the block runs, as every profile
    of ``chip_smoke.py`` opens (``settled_profile``)."""
    from distlearn_tpu_torch.utils import profiling
    seen = []

    def sleep(s):
        seen.append(("sleep", s, torch.autograd.profiler._is_profiler_enabled))

    def sync():
        seen.append(("sync", None,
                     torch.autograd.profiler._is_profiler_enabled))

    monkeypatch.setattr(profiling.time, "sleep", sleep)
    from torch.profiler import ProfilerActivity
    with profiling.settled_profile([ProfilerActivity.CPU], sync) as prof:
        seen.append(("body", None,
                     torch.autograd.profiler._is_profiler_enabled))
        torch.ones(4).sum()
    assert seen == [("sync", None, True),
                    ("sleep", profiling.SETTLE_S, True),
                    ("body", None, True)]
    assert profiling.SETTLE_S == 0.05
    assert any(e.key == "aten::sum" for e in prof.key_averages())
    seen.clear()
    with profiling.trace(str(tmp_path), device="cpu"):
        seen.append(("body", None,
                     torch.autograd.profiler._is_profiler_enabled))
    assert seen == [("sleep", profiling.SETTLE_S, True),
                    ("body", None, True)]
    assert (tmp_path / "trace.json").exists()
