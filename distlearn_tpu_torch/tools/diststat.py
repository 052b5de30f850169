"""diststat — aggregate a distlearn obs JSONL run into latency tables,
or diff two runs (the port's copy of the root ``tools/diststat.py``: the
same subcommands, flags, tables and report keys; ``merge`` goes through
the port's ``obs.agg``).  The trails of both packages share one record
schema, so either tool reads either package's trails.

The obs subsystem (distlearn_tpu_torch/obs/) spills span records and registry
snapshots to JSONL; this tool turns that trail into the numbers
docs/PERF.md used to recompute by hand:

    python -m distlearn_tpu_torch.tools.diststat summarize run.jsonl [more.jsonl ...]
    python -m distlearn_tpu_torch.tools.diststat summarize run.jsonl --format json
    python -m distlearn_tpu_torch.tools.diststat diff before.jsonl after.jsonl
    python -m distlearn_tpu_torch.tools.diststat merge center.jsonl client-*.jsonl

``summarize`` reports per-span-name count/p50/p95/p99/total (exact —
computed from the individual span durations, not histogram buckets),
final counter values (per label set and summed per name), gauges, and
histogram summaries.  Multiple files merge: spans concatenate, counters
sum across files (one file per process is the normal layout — server
and each client spill separately).  Serving runs additionally get the
derived serving/router tables and the raw-speed table (radix
prefix-cache hit rate and retained pages, speculative-decode accepted
tokens per tick, chunked-prefill dispatch mix — docs/SERVING.md).
``diff`` subtracts run A's counter totals and span quantiles from
run B's.

``merge`` is the FLEET view (one trail per process): counters and span
quantiles fleet-wide with a per-process breakdown column, histogram
merges through ``obs.agg`` (the same math the live Collector runs),
the SLO table (rule state, breach/recovery counts), the autoscaler
table (target size, scale events by direction), per-process obs health
(``obs_spans_dropped_total`` — nonzero means the 4096-entry span ring
wrapped and this report undercounts), and the chronological fleet
event log (``slo.breach`` / ``slo.recover`` / ``autoscaler.scale_*``).

Record schema: docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _percentile(xs: list[float], q: float) -> float:
    """Nearest-rank percentile on a sorted copy (small-n friendly)."""
    if not xs:
        return float("nan")
    xs = sorted(xs)
    k = max(0, min(len(xs) - 1, int(round(q / 100.0 * (len(xs) - 1)))))
    return xs[k]


def _label_key(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"'
                          for k, v in sorted(labels.items())) + "}"


def load_run(paths: list[str]) -> dict:
    """Parse one run (1+ JSONL files) into ``{"spans": {...},
    "counters": {...}, "counter_totals": {...}, "gauges": {...},
    "histograms": {...}, "records": n}``."""
    spans: dict[str, list[float]] = {}
    span_errs: dict[str, int] = {}
    counters: dict[str, float] = {}
    counter_totals: dict[str, float] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, dict] = {}
    nrec = 0
    for path in paths:
        last_snap = None
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue          # torn tail line of a live run
                nrec += 1
                if rec.get("type") == "span":
                    spans.setdefault(rec["name"], []).append(
                        float(rec["dur"]))
                    if rec.get("err"):
                        span_errs[rec["name"]] = \
                            span_errs.get(rec["name"], 0) + 1
                elif rec.get("type") == "snapshot":
                    last_snap = rec
        if last_snap is None:
            continue
        for fam in last_snap.get("metrics", []):
            name, kind = fam["name"], fam["kind"]
            for s in fam.get("samples", []):
                key = name + _label_key(s.get("labels", {}))
                if kind == "counter":
                    counters[key] = counters.get(key, 0) + s["value"]
                    counter_totals[name] = \
                        counter_totals.get(name, 0) + s["value"]
                elif kind == "gauge":
                    gauges[key] = s["value"]
                elif kind == "histogram":
                    h = hists.setdefault(key, {"sum": 0.0, "count": 0})
                    h["sum"] += s["sum"]
                    h["count"] += s["count"]
    return {"records": nrec, "spans": spans, "span_errs": span_errs,
            "counters": counters, "counter_totals": counter_totals,
            "gauges": gauges, "histograms": hists}


_WIRE_FAMS = {"wire_packed_frames_total": "frames",
              "wire_packed_bytes_total": "wire_bytes",
              "wire_logical_bytes_total": "logical_bytes"}


def wire_table(counters: dict) -> dict:
    """Derive the packed-wire table from the wire_* counter families:
    per codec, frame count, wire bytes, logical (pre-encoding) bytes, and
    the compression ratio logical/wire.  Empty when the run never sent a
    packed frame."""
    tab: dict[str, dict] = {}
    for key, v in counters.items():
        for fam, col in _WIRE_FAMS.items():
            prefix = fam + '{codec="'
            if key.startswith(prefix) and key.endswith('"}'):
                codec = key[len(prefix):-2]
                row = tab.setdefault(codec, {c: 0.0 for c in
                                             _WIRE_FAMS.values()})
                row[col] += v
    for row in tab.values():
        row["ratio"] = (row["logical_bytes"] / row["wire_bytes"]
                        if row["wire_bytes"] else float("nan"))
    return dict(sorted(tab.items()))


_SHARD_SYNCS = "async_ea_shard_syncs_total"
_SHARD_BYTES = "async_ea_shard_wire_bytes_total"
_SHARD_APPLY = "async_ea_shard_apply_seconds"


def _shard_label(key: str, fam: str) -> str | None:
    prefix = fam + '{shard="'
    if key.startswith(prefix) and key.endswith('"}'):
        return key[len(prefix):-2]
    return None


def shard_table(counters: dict, histograms: dict) -> dict:
    """Derive the sharded parameter-server balance table from the
    async_ea_shard_* families: per shard, stripe legs served, wire bytes
    moved (center down + delta up) and the per-stripe apply latency.
    Empty when the run never served a sharded sync — the whole table is
    the load-balance check for wire.plan_stripes (byte counts should be
    near-equal across rows; leg counts exactly equal unless a client
    died mid-sync)."""
    tab: dict[str, dict] = {}

    def row(shard):
        return tab.setdefault(shard, {
            "legs": 0.0, "wire_bytes": 0.0, "applies": 0,
            "apply_mean": float("nan")})

    for key, v in counters.items():
        s = _shard_label(key, _SHARD_SYNCS)
        if s is not None:
            row(s)["legs"] += v
        s = _shard_label(key, _SHARD_BYTES)
        if s is not None:
            row(s)["wire_bytes"] += v
    for key, h in histograms.items():
        s = _shard_label(key, _SHARD_APPLY)
        if s is not None:
            r = row(s)
            r["applies"] += h["count"]
            r["apply_mean"] = (h["sum"] / h["count"] if h["count"]
                               else float("nan"))
    return dict(sorted(tab.items(), key=lambda kv: (len(kv[0]), kv[0])))


_ENCODE_HIST = "wire_encode_seconds"
_APPLY_HIST = "center_apply_seconds"
_ZC_FAM = "wire_zero_copy_total"


def codec_table(counters: dict, histograms: dict) -> dict:
    """Derive the fused wire-codec table: per stripe ('all' = whole-tree),
    the client-side encode (quantize + error-feedback) and server-side
    apply (dequantize + elastic add) histograms, plus the zero-copy
    staging hit ratio from ``wire_zero_copy_total`` (hit = one contiguous
    frame-buffer iovec per send, miss = per-leaf gather; only client
    delta-up sends stage, so a healthy EASGD fleet sits near 0.5 —
    docs/OBSERVABILITY.md).  Empty when the run never took the fused
    path — so the table doubles as the is-the-fast-path-actually-on
    check for production runs."""
    stripes: dict[str, dict] = {}

    def row(shard):
        return stripes.setdefault(shard, {
            "encodes": 0, "encode_mean": float("nan"),
            "applies": 0, "apply_mean": float("nan")})

    for key, h in histograms.items():
        s = _shard_label(key, _ENCODE_HIST)
        if s is not None and h["count"]:
            r = row(s)
            r["encodes"] += h["count"]
            r["encode_mean"] = h["sum"] / h["count"]
        s = _shard_label(key, _APPLY_HIST)
        if s is not None and h["count"]:
            r = row(s)
            r["applies"] += h["count"]
            r["apply_mean"] = h["sum"] / h["count"]
    out: dict = {}
    if stripes:
        out["stripes"] = dict(sorted(stripes.items(),
                                     key=lambda kv: (len(kv[0]), kv[0])))
    hit = counters.get(_ZC_FAM + '{result="hit"}', 0.0)
    miss = counters.get(_ZC_FAM + '{result="miss"}', 0.0)
    if hit or miss:
        out["zero_copy"] = {"hit": hit, "miss": miss,
                            "hit_ratio": hit / (hit + miss)}
    return out


_FAILOVER_COUNTERS = {
    "async_ea_evictions_total": "evictions",
    "async_ea_rejoins_total": "rejoins",
    "async_ea_failover_redials_total": "redials",
    "async_ea_failover_promotions_total": "promotions",
    "async_ea_failover_stale_refusals_total": "stale_refusals",
    "center_ckpt_saves_total": "ckpt_saves",
    "center_ckpt_restores_total": "ckpt_restores",
}
_REPLAYS_FAM = "async_ea_failover_replays_total"
_FAILOVER_SPANS = ("async_ea.promote", "async_ea.failover")


def failover_table(counter_totals: dict, counters: dict,
                   spans: dict) -> dict:
    """Derive the HA/failover table (docs/HA.md): eviction/rejoin/re-dial
    counts, promotions and checkpoint traffic, replay outcomes, and the
    promotion + client-failover latency quantiles from their spans.
    Empty when the run had no failover activity at all."""
    tab: dict = {}
    for fam, col in _FAILOVER_COUNTERS.items():
        v = counter_totals.get(fam, 0)
        if v:
            tab[col] = v
    replays = {}
    prefix = _REPLAYS_FAM + '{outcome="'
    for key, v in counters.items():
        if key.startswith(prefix) and key.endswith('"}'):
            replays[key[len(prefix):-2]] = v
    if replays:
        tab["replays"] = dict(sorted(replays.items()))
    lat = {}
    for name in _FAILOVER_SPANS:
        durs = spans.get(name)
        if durs:
            lat[name] = {"count": len(durs),
                         "p50": _percentile(durs, 50),
                         "p99": _percentile(durs, 99)}
    if lat:
        tab["latency"] = lat
    return tab


_MEMBER_COUNTERS = {
    "async_ea_membership_joins_total": "joins",
    "async_ea_membership_join_failures_total": "join_failures",
}
_LEAVES_FAM = "async_ea_membership_leaves_total"
_TAU_GAUGE = "async_ea_adaptive_tau"
_MEMBER_SPANS = ("async_ea.join", "async_ea.leave")


def membership_table(counter_totals: dict, counters: dict, gauges: dict,
                     spans: dict) -> dict:
    """Derive the elastic-membership table (docs/ELASTIC.md): Join?
    admissions and refusals, Leave? departures by pending-delta outcome
    (``flushed`` / ``clean`` / ``dropped``), the final live fleet size,
    each client's straggler-adapted effective τ, and the join/leave
    handshake latency quantiles.  Empty when the run's fleet was fixed —
    so a populated table is itself the proof the server ran elastic."""
    tab: dict = {}
    for fam, col in _MEMBER_COUNTERS.items():
        v = counter_totals.get(fam, 0)
        if v:
            tab[col] = v
    leaves = {}
    prefix = _LEAVES_FAM + '{outcome="'
    for key, v in counters.items():
        if key.startswith(prefix) and key.endswith('"}'):
            leaves[key[len(prefix):-2]] = v
    if leaves:
        tab["leaves"] = dict(sorted(leaves.items()))
    size = gauges.get("async_ea_membership_size")
    if size is not None and (tab or size):
        tab["fleet_size"] = size
    tau, tprefix = {}, _TAU_GAUGE + '{cid="'
    for key, v in gauges.items():
        if key.startswith(tprefix) and key.endswith('"}'):
            tau[key[len(tprefix):-2]] = v
    if tau:
        tab["adaptive_tau"] = dict(sorted(tau.items(),
                                          key=lambda kv: (len(kv[0]), kv[0])))
    lat = {}
    for name in _MEMBER_SPANS:
        durs = spans.get(name)
        if durs:
            lat[name] = {"count": len(durs),
                         "p50": _percentile(durs, 50),
                         "p99": _percentile(durs, 99)}
    if lat:
        tab["latency"] = lat
    return tab


_SERVE_SPANS = {"serve.ttft": "ttft", "serve.tpot": "tpot",
                "serve.prefill": "prefill", "serve.tick": "tick"}
_SERVE_OUTCOMES = 'serve_requests_total{outcome="'


def serving_table(counter_totals: dict, counters: dict, spans: dict) -> dict:
    """Derive the serving table (docs/SERVING.md): request counts by
    terminal outcome, tokens streamed, and TTFT / per-token (TPOT) /
    prefill / tick latency quantiles from the span trail — exact values
    from individual spans, not histogram buckets.  Empty when the run
    served nothing."""
    tab: dict = {}
    outcomes = {}
    for key, v in counters.items():
        if key.startswith(_SERVE_OUTCOMES) and key.endswith('"}'):
            outcomes[key[len(_SERVE_OUTCOMES):-2]] = v
    if outcomes:
        tab["requests"] = dict(sorted(outcomes.items()))
    toks = counter_totals.get("serve_tokens_total", 0)
    if toks:
        tab["tokens"] = toks
    lat = {}
    for name, col in _SERVE_SPANS.items():
        durs = spans.get(name)
        if durs:
            lat[col] = {"count": len(durs),
                        "p50": _percentile(durs, 50),
                        "p95": _percentile(durs, 95),
                        "p99": _percentile(durs, 99)}
    if lat:
        tab["latency"] = lat
    return tab


_ROUTER_TOTALS = {
    "router_retries_total": "retries",
    "router_hedges_total": "hedges",
    "router_shed_total": "sheds",
    "router_fence_violations_total": "fence_violations",
}
_ROUTER_DISPATCH = 'router_dispatch_total{replica="'
_ROUTER_SPANS = {"router.failover": "failover", "router.hedge": "hedge"}


def router_table(counter_totals: dict, counters: dict, spans: dict) -> dict:
    """Derive the fleet-router table (docs/SERVING.md): per-replica
    dispatch counts, death resubmissions, hedges, sheds and epoch-fence
    violations, plus the failover/hedge recovery latency quantiles
    (replica death or hedge fire to first token on the survivor).
    Empty when the run had no router in front of it."""
    tab: dict = {}
    dispatch = {}
    for key, v in counters.items():
        if key.startswith(_ROUTER_DISPATCH) and key.endswith('"}'):
            dispatch[key[len(_ROUTER_DISPATCH):-2]] = v
    if dispatch:
        tab["dispatch"] = dict(sorted(dispatch.items()))
    for fam, col in _ROUTER_TOTALS.items():
        v = counter_totals.get(fam, 0)
        if v:
            tab[col] = v
    lat = {}
    for name, col in _ROUTER_SPANS.items():
        durs = spans.get(name)
        if durs:
            lat[col] = {"count": len(durs),
                        "p50": _percentile(durs, 50),
                        "p99": _percentile(durs, 99)}
    if lat:
        tab["latency"] = lat
    return tab


_PREFIX_CACHE_FAMS = {
    "serve_prefix_cache_hits_total": "hits",
    "serve_prefix_cache_misses_total": "misses",
    "serve_prefix_cache_evictions_total": "evictions",
}
_SPEC_SPANS = {"serve.prefill_chunk": "prefill_chunk",
               "serve.verify": "verify"}


def raw_speed_table(counter_totals: dict, gauges: dict,
                    histograms: dict, spans: dict) -> dict:
    """Derive the serving raw-speed table (docs/SERVING.md): radix
    prefix-cache hit/miss/eviction counts with the hit rate and pages
    still retained, the speculative-decode acceptance rate (mean tokens
    emitted per slot per verify tick — 1.0 is plain-tick throughput,
    anything above is the speculation win), and the chunked-prefill /
    verify dispatch latencies.  Empty when neither the cache nor the
    drafter ever ran."""
    tab: dict = {}
    cache = {col: counter_totals[fam]
             for fam, col in _PREFIX_CACHE_FAMS.items()
             if counter_totals.get(fam)}
    if cache:
        looked = cache.get("hits", 0) + cache.get("misses", 0)
        if looked:
            cache["hit_rate"] = cache.get("hits", 0) / looked
        pages = gauges.get("serve_prefix_cache_pages")
        if pages is not None:
            cache["pages_retained"] = pages
        tab["prefix_cache"] = cache
    acc = histograms.get("serve_spec_accepted_tokens")
    if acc and acc["count"]:
        tab["speculation"] = {
            "verify_slot_ticks": acc["count"],
            "tokens_emitted": acc["sum"],
            "accepted_tokens_per_tick": acc["sum"] / acc["count"],
            "verify_dispatches": counter_totals.get(
                "serve_engine_verifies_total", 0),
        }
    chunks = counter_totals.get("serve_engine_prefill_chunks_total", 0)
    if chunks:
        tab["prefill_chunks"] = chunks
    lat = {}
    for name, col in _SPEC_SPANS.items():
        durs = spans.get(name)
        if durs:
            lat[col] = {"count": len(durs),
                        "p50": _percentile(durs, 50),
                        "p99": _percentile(durs, 99)}
    if lat:
        tab["latency"] = lat
    return tab


_SYNC_FAMS = {"sync_rounds_total": "rounds",
              "sync_host_leg_bytes_total": "host_leg_bytes",
              "sync_logical_bytes_total": "logical_bytes"}
_SYNC_SECONDS = "sync_seconds"


def _backend_label(key: str, fam: str) -> str | None:
    prefix = fam + '{backend="'
    if key.startswith(prefix) and key.endswith('"}'):
        return key[len(prefix):-2]
    return None


def sync_table(counters: dict, histograms: dict) -> dict:
    """Derive the per-backend collective-sync table from the sync_*
    families emitted by :mod:`distlearn_tpu_torch.comm.backend`: rounds run,
    host-leg (TCP) bytes vs logical (reduced-value) bytes — their ratio
    is the hierarchical win; for HybridBackend host_leg/round should be
    ~1/L of HostBackend's at L local devices — and the mean round wall
    time with the implied syncs/s.  Empty when no backend ever synced."""
    tab: dict[str, dict] = {}

    def row(backend):
        return tab.setdefault(backend, {
            "rounds": 0.0, "host_leg_bytes": 0.0, "logical_bytes": 0.0})

    for key, v in counters.items():
        for fam, col in _SYNC_FAMS.items():
            b = _backend_label(key, fam)
            if b is not None:
                row(b)[col] += v
    for key, h in histograms.items():
        b = _backend_label(key, _SYNC_SECONDS)
        if b is not None and h["count"]:
            r = row(b)
            r["sync_mean"] = h["sum"] / h["count"]
            r["syncs_per_s"] = (h["count"] / h["sum"] if h["sum"]
                                else float("inf"))
    for r in tab.values():
        r["host_bytes_per_round"] = (r["host_leg_bytes"] / r["rounds"]
                                     if r["rounds"] else float("nan"))
        r["host_reduction"] = (r["logical_bytes"] / r["host_leg_bytes"]
                               if r["host_leg_bytes"] else float("inf"))
    return dict(sorted(tab.items()))


def summarize_run(paths: list[str]) -> dict:
    run = load_run(paths)
    span_tab = {}
    for name, durs in sorted(run["spans"].items()):
        span_tab[name] = {
            "count": len(durs),
            "errors": run["span_errs"].get(name, 0),
            "p50": _percentile(durs, 50),
            "p95": _percentile(durs, 95),
            "p99": _percentile(durs, 99),
            "total": sum(durs),
        }
    hist_tab = {}
    for key, h in sorted(run["histograms"].items()):
        mean = h["sum"] / h["count"] if h["count"] else float("nan")
        hist_tab[key] = {"count": h["count"], "sum": h["sum"], "mean": mean}
    return {"records": run["records"], "spans": span_tab,
            "counters": dict(sorted(run["counters"].items())),
            "counter_totals": dict(sorted(run["counter_totals"].items())),
            "gauges": dict(sorted(run["gauges"].items())),
            "histograms": hist_tab,
            "wire": wire_table(run["counters"]),
            "codec": codec_table(run["counters"], run["histograms"]),
            "shards": shard_table(run["counters"], run["histograms"]),
            "failover": failover_table(run["counter_totals"],
                                       run["counters"], run["spans"]),
            "membership": membership_table(run["counter_totals"],
                                           run["counters"], run["gauges"],
                                           run["spans"]),
            "serving": serving_table(run["counter_totals"],
                                     run["counters"], run["spans"]),
            "router": router_table(run["counter_totals"],
                                   run["counters"], run["spans"]),
            "raw_speed": raw_speed_table(run["counter_totals"],
                                         run["gauges"],
                                         run["histograms"],
                                         run["spans"]),
            "sync": sync_table(run["counters"], run["histograms"])}


def diff_runs(a_paths: list[str], b_paths: list[str]) -> dict:
    a, b = summarize_run(a_paths), summarize_run(b_paths)
    counters = {}
    for name in sorted(set(a["counter_totals"]) | set(b["counter_totals"])):
        av = a["counter_totals"].get(name, 0)
        bv = b["counter_totals"].get(name, 0)
        counters[name] = {"a": av, "b": bv, "delta": bv - av}
    spans = {}
    for name in sorted(set(a["spans"]) | set(b["spans"])):
        sa = a["spans"].get(name, {})
        sb = b["spans"].get(name, {})
        spans[name] = {
            "count": {"a": sa.get("count", 0), "b": sb.get("count", 0)},
            "p50_delta": sb.get("p50", float("nan"))
            - sa.get("p50", float("nan")),
            "p95_delta": sb.get("p95", float("nan"))
            - sa.get("p95", float("nan")),
        }
    wire = {}
    wa, wb = a.get("wire", {}), b.get("wire", {})
    for codec in sorted(set(wa) | set(wb)):
        ra = wa.get(codec, {})
        rb = wb.get(codec, {})
        wire[codec] = {
            "frames": {"a": ra.get("frames", 0), "b": rb.get("frames", 0)},
            "wire_bytes": {"a": ra.get("wire_bytes", 0),
                           "b": rb.get("wire_bytes", 0),
                           "delta": rb.get("wire_bytes", 0)
                           - ra.get("wire_bytes", 0)},
            "ratio": {"a": ra.get("ratio", float("nan")),
                      "b": rb.get("ratio", float("nan"))},
        }
    return {"counters": counters, "spans": spans, "wire": wire}


_EVENT_SPANS = ("slo.breach", "slo.recover",
                "autoscaler.scale_up", "autoscaler.scale_down")


def _load_trail(path: str) -> tuple[list[dict], dict | None]:
    """(span records, last snapshot record) of one trail — the raw
    records, unlike :func:`load_run`'s digested durations, because the
    fleet view needs timestamps and labels for the event log."""
    spans: list[dict] = []
    last = None
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue          # torn tail line of a live run
            if rec.get("type") == "span":
                spans.append(rec)
            elif rec.get("type") == "snapshot":
                last = rec
    return spans, last


def _by_label(fam: dict | None, label: str) -> dict:
    out: dict = {}
    for s in (fam or {}).get("samples", []):
        v = (s.get("labels") or {}).get(label)
        if v is not None:
            out[v] = out.get(v, 0) + s.get("value", 0)
    return out


def merge_runs(paths: list[str]) -> dict:
    """Fleet view over one trail per process: merged counters/spans/
    histograms with per-process breakdowns, the SLO and autoscaler
    tables, per-process obs health, and the chronological event log.
    Merging runs through ``obs.agg.FleetRegistry`` — the same math the
    live Collector applies, so this offline report and the in-flight
    SLO engine can never disagree about fleet totals."""
    from distlearn_tpu_torch.obs import agg
    fleet = agg.FleetRegistry()
    sources: list[str] = []
    span_by_src: dict[str, list[dict]] = {}
    events: list[dict] = []
    for path in paths:
        src = os.path.basename(path)
        if src in span_by_src:          # two processes, one basename
            src = path
        sources.append(src)
        spans, snap = _load_trail(path)
        span_by_src[src] = spans
        if snap is not None:
            fleet.ingest(snap, source=src)
        for rec in spans:
            if rec.get("name") in _EVENT_SPANS:
                events.append({"ts": rec.get("ts", 0.0),
                               "event": rec["name"], "src": src,
                               **(rec.get("labels") or {})})
    events.sort(key=lambda e: e["ts"])
    merged = fleet.merged()

    counters: dict[str, dict] = {}
    gauges: dict[str, dict] = {}
    hists: dict[str, dict] = {}
    for name, fam in sorted(merged.items()):
        by = fleet.breakdown(name)
        if fam["kind"] == "counter":
            counters[name] = {"total": sum(by.values()), "by": by}
        elif fam["kind"] == "gauge":
            gauges[name] = {"by": by}
        else:
            # a family can be registered but never observed — no samples
            h = fleet.histogram(name) or {"count": 0, "sum": 0.0}
            hists[name] = {
                "count": h["count"],
                "mean": h["sum"] / h["count"] if h["count"]
                else float("nan"),
                "by": by}

    span_tab: dict[str, dict] = {}
    durs_by_name: dict[str, list[float]] = {}
    for src, recs in span_by_src.items():
        for rec in recs:
            name = rec.get("name", "?")
            durs_by_name.setdefault(name, []).append(
                float(rec.get("dur", 0.0)))
            row = span_tab.setdefault(name, {"count": 0, "by": {}})
            row["count"] += 1
            row["by"][src] = row["by"].get(src, 0) + 1
    for name, row in span_tab.items():
        durs = durs_by_name[name]
        row.update(p50=_percentile(durs, 50), p95=_percentile(durs, 95),
                   p99=_percentile(durs, 99), total=sum(durs))

    slo_tab: dict[str, dict] = {}
    ok = _by_label(merged.get("slo_ok"), "slo")
    val = _by_label(merged.get("slo_value"), "slo")
    breaches = _by_label(merged.get("slo_breaches_total"), "slo")
    recoveries = _by_label(merged.get("slo_recoveries_total"), "slo")
    for rule in sorted(set(ok) | set(breaches) | set(recoveries)):
        slo_tab[rule] = {"ok": bool(ok.get(rule, 1)),
                         "value": val.get(rule, float("nan")),
                         "breaches": breaches.get(rule, 0),
                         "recoveries": recoveries.get(rule, 0)}

    scaler_tab: dict = {}
    scale_events = _by_label(
        merged.get("autoscaler_scale_events_total"), "direction")
    if scale_events or "autoscaler_target_size" in gauges:
        scaler_tab = {"events": scale_events,
                      "target_size": max(
                          gauges.get("autoscaler_target_size",
                                     {}).get("by", {}).values(),
                          default=float("nan"))}

    health: dict[str, dict] = {}
    dropped = fleet.breakdown("obs_spans_dropped_total")
    failures = fleet.breakdown("obs_agg_poll_failures_total")
    for src in sources:
        row = {}
        if src in dropped:
            row["spans_dropped"] = dropped[src]
        if src in failures:
            row["poll_failures"] = failures[src]
        if row:
            health[src] = row

    return {"sources": sources, "counters": counters, "gauges": gauges,
            "histograms": hists, "spans": span_tab, "slo": slo_tab,
            "autoscaler": scaler_tab, "obs_health": health,
            "events": events}


def _fmt_by(by: dict) -> str:
    return " ".join(f"{src}={v:g}" for src, v in sorted(by.items()))


def _print_merge(doc: dict):
    print(f"fleet of {len(doc['sources'])}: "
          + ", ".join(doc["sources"]) + "\n")
    if doc["spans"]:
        print(f"{'span':<32} {'count':>7} {'p50':>10} {'p95':>10} "
              f"{'p99':>10}  per-process")
        for name, row in sorted(doc["spans"].items()):
            print(f"{name:<32} {row['count']:>7} "
                  f"{_fmt_s(row['p50']):>10} {_fmt_s(row['p95']):>10} "
                  f"{_fmt_s(row['p99']):>10}  {_fmt_by(row['by'])}")
        print()
    if doc["counters"]:
        print(f"{'counter':<40} {'fleet':>10}  per-process")
        for name, row in doc["counters"].items():
            print(f"{name:<40} {row['total']:>10g}  "
                  f"{_fmt_by(row['by'])}")
        print()
    if doc["histograms"]:
        print(f"{'histogram':<40} {'count':>8} {'mean':>10}  per-process")
        for name, row in doc["histograms"].items():
            print(f"{name:<40} {row['count']:>8g} "
                  f"{_fmt_s(row['mean']):>10}  {_fmt_by(row['by'])}")
        print()
    if doc["slo"]:
        print(f"{'slo rule':<24} {'state':>8} {'value':>10} "
              f"{'breaches':>9} {'recoveries':>11}")
        for rule, row in doc["slo"].items():
            state = "ok" if row["ok"] else "BREACH"
            print(f"{rule:<24} {state:>8} {row['value']:>10.4g} "
                  f"{row['breaches']:>9g} {row['recoveries']:>11g}")
        print()
    if doc["autoscaler"]:
        a = doc["autoscaler"]
        ev = " ".join(f"{d}={v:g}"
                      for d, v in sorted(a["events"].items()))
        print(f"autoscaler: target_size={a['target_size']:g} "
              f"events[{ev}]")
        print()
    for src, row in doc["obs_health"].items():
        if row.get("spans_dropped"):
            print(f"WARNING: {src} dropped {row['spans_dropped']:g} span "
                  "records (ring wrapped) — span tables undercount")
        if row.get("poll_failures"):
            print(f"WARNING: {src} had {row['poll_failures']:g} collector "
                  "poll failures — fleet totals may lag")
    if doc["events"]:
        print("fleet events:")
        t0 = doc["events"][0]["ts"]
        for e in doc["events"]:
            extra = " ".join(f"{k}={v}" for k, v in sorted(e.items())
                             if k not in ("ts", "event", "src"))
            print(f"  +{e['ts'] - t0:8.3f}s  {e['event']:<22} {extra}  "
                  f"[{e['src']}]")


def _fmt_s(v: float) -> str:
    if v != v:
        return "nan"
    if abs(v) >= 1.0:
        return f"{v:.3f}s"
    if abs(v) >= 1e-3:
        return f"{v * 1e3:.2f}ms"
    return f"{v * 1e6:.1f}us"


def _print_summary(doc: dict):
    dropped = doc["counter_totals"].get("obs_spans_dropped_total", 0)
    if dropped:
        print(f"WARNING: the span ring dropped {dropped:g} records "
              "(trail truncated) — span tables undercount\n")
    if doc["spans"]:
        print(f"{'span':<40} {'count':>7} {'p50':>10} {'p95':>10} "
              f"{'p99':>10} {'total':>10} {'err':>5}")
        for name, row in doc["spans"].items():
            print(f"{name:<40} {row['count']:>7} {_fmt_s(row['p50']):>10} "
                  f"{_fmt_s(row['p95']):>10} {_fmt_s(row['p99']):>10} "
                  f"{_fmt_s(row['total']):>10} {row['errors']:>5}")
        print()
    if doc["counters"]:
        print("counters:")
        for key, v in doc["counters"].items():
            print(f"  {key} = {v:g}")
        for name, v in doc["counter_totals"].items():
            if name + "{" in "".join(doc["counters"]):
                print(f"  {name} (sum over labels) = {v:g}")
        print()
    if doc["gauges"]:
        print("gauges:")
        for key, v in doc["gauges"].items():
            print(f"  {key} = {v:g}")
        print()
    if doc["histograms"]:
        print("histograms:")
        for key, row in doc["histograms"].items():
            print(f"  {key}: count={row['count']} "
                  f"mean={_fmt_s(row['mean'])} sum={_fmt_s(row['sum'])}")
        print()
    if doc.get("wire"):
        print(f"{'packed wire':<12} {'frames':>8} {'wire bytes':>14} "
              f"{'logical bytes':>14} {'ratio':>7}")
        for codec, row in doc["wire"].items():
            print(f"{codec:<12} {row['frames']:>8g} "
                  f"{row['wire_bytes']:>14g} {row['logical_bytes']:>14g} "
                  f"{row['ratio']:>7.2f}")
        print()
    if doc.get("codec"):
        cd = doc["codec"]
        if cd.get("stripes"):
            print(f"{'codec stripe':<12} {'encodes':>9} {'encode mean':>13} "
                  f"{'applies':>9} {'apply mean':>12}")
            for shard, row in cd["stripes"].items():
                print(f"{shard:<12} {row['encodes']:>9g} "
                      f"{_fmt_s(row['encode_mean']):>13} "
                      f"{row['applies']:>9g} "
                      f"{_fmt_s(row['apply_mean']):>12}")
        if cd.get("zero_copy"):
            z = cd["zero_copy"]
            print(f"zero-copy frames: hit={z['hit']:g} miss={z['miss']:g} "
                  f"hit_ratio={z['hit_ratio']:.2f}")
        print()
    if doc.get("shards"):
        print(f"{'shard':<8} {'legs':>8} {'wire bytes':>14} "
              f"{'applies':>9} {'apply mean':>12}")
        for shard, row in doc["shards"].items():
            print(f"{shard:<8} {row['legs']:>8g} "
                  f"{row['wire_bytes']:>14g} {row['applies']:>9g} "
                  f"{_fmt_s(row['apply_mean']):>12}")
        print()
    if doc.get("sync"):
        print(f"{'sync backend':<14} {'rounds':>7} {'host bytes':>13} "
              f"{'logical bytes':>14} {'host/round':>12} {'reduc':>7} "
              f"{'mean':>10} {'syncs/s':>9}")
        for backend, row in doc["sync"].items():
            sps = row.get("syncs_per_s", float("nan"))
            print(f"{backend:<14} {row['rounds']:>7g} "
                  f"{row['host_leg_bytes']:>13g} "
                  f"{row['logical_bytes']:>14g} "
                  f"{row['host_bytes_per_round']:>12g} "
                  f"{row['host_reduction']:>7.1f} "
                  f"{_fmt_s(row.get('sync_mean', float('nan'))):>10} "
                  f"{sps:>9.1f}")
        print()
    if doc.get("failover"):
        fo = doc["failover"]
        print("failover:")
        for col in ("evictions", "rejoins", "redials", "promotions",
                    "stale_refusals", "ckpt_saves", "ckpt_restores"):
            if col in fo:
                print(f"  {col} = {fo[col]:g}")
        for outcome, v in fo.get("replays", {}).items():
            print(f"  replays[{outcome}] = {v:g}")
        for name, row in fo.get("latency", {}).items():
            print(f"  {name}: count={row['count']} "
                  f"p50={_fmt_s(row['p50'])} p99={_fmt_s(row['p99'])}")
        print()
    if doc.get("membership"):
        mb = doc["membership"]
        print("membership:")
        for col in ("joins", "join_failures", "fleet_size"):
            if col in mb:
                print(f"  {col} = {mb[col]:g}")
        for outcome, v in mb.get("leaves", {}).items():
            print(f"  leaves[{outcome}] = {v:g}")
        for cid, v in mb.get("adaptive_tau", {}).items():
            print(f"  adaptive_tau[cid={cid}] = {v:g}")
        for name, row in mb.get("latency", {}).items():
            print(f"  {name}: count={row['count']} "
                  f"p50={_fmt_s(row['p50'])} p99={_fmt_s(row['p99'])}")
        print()
    if doc.get("serving"):
        sv = doc["serving"]
        print("serving:")
        for outcome, v in sv.get("requests", {}).items():
            print(f"  requests[{outcome}] = {v:g}")
        if "tokens" in sv:
            print(f"  tokens = {sv['tokens']:g}")
        if sv.get("latency"):
            print(f"  {'':<8} {'count':>7} {'p50':>10} {'p95':>10} "
                  f"{'p99':>10}")
            for col in ("ttft", "tpot", "prefill", "tick"):
                row = sv["latency"].get(col)
                if row:
                    print(f"  {col:<8} {row['count']:>7} "
                          f"{_fmt_s(row['p50']):>10} "
                          f"{_fmt_s(row['p95']):>10} "
                          f"{_fmt_s(row['p99']):>10}")
        print()
    if doc.get("router"):
        rt = doc["router"]
        print("router:")
        for replica, v in rt.get("dispatch", {}).items():
            print(f"  dispatch[{replica}] = {v:g}")
        for col in ("retries", "hedges", "sheds", "fence_violations"):
            if col in rt:
                print(f"  {col} = {rt[col]:g}")
        for name, row in rt.get("latency", {}).items():
            print(f"  {name}: count={row['count']} "
                  f"p50={_fmt_s(row['p50'])} p99={_fmt_s(row['p99'])}")
        print()
    if doc.get("raw_speed"):
        rs = doc["raw_speed"]
        print("raw speed (prefix cache / speculation):")
        pc = rs.get("prefix_cache")
        if pc:
            for col in ("hits", "misses", "evictions", "pages_retained"):
                if col in pc:
                    print(f"  cache {col} = {pc[col]:g}")
            if "hit_rate" in pc:
                print(f"  cache hit_rate = {pc['hit_rate']:.2f}")
        sp = rs.get("speculation")
        if sp:
            print(f"  spec accepted_tokens_per_tick = "
                  f"{sp['accepted_tokens_per_tick']:.2f} "
                  f"(over {sp['verify_slot_ticks']:g} slot-ticks, "
                  f"{sp['verify_dispatches']:g} verify dispatches)")
        if "prefill_chunks" in rs:
            print(f"  prefill_chunks = {rs['prefill_chunks']:g}")
        for name, row in rs.get("latency", {}).items():
            print(f"  {name}: count={row['count']} "
                  f"p50={_fmt_s(row['p50'])} p99={_fmt_s(row['p99'])}")


def _print_diff(doc: dict):
    if doc["counters"]:
        print(f"{'counter':<44} {'a':>12} {'b':>12} {'delta':>12}")
        for name, row in doc["counters"].items():
            print(f"{name:<44} {row['a']:>12g} {row['b']:>12g} "
                  f"{row['delta']:>+12g}")
        print()
    if doc["spans"]:
        print(f"{'span':<40} {'count a/b':>12} {'dp50':>10} {'dp95':>10}")
        for name, row in doc["spans"].items():
            cnt = f"{row['count']['a']}/{row['count']['b']}"
            print(f"{name:<40} {cnt:>12} {_fmt_s(row['p50_delta']):>10} "
                  f"{_fmt_s(row['p95_delta']):>10}")
        print()
    if doc.get("wire"):
        print(f"{'packed wire':<12} {'frames a/b':>12} "
              f"{'dwire bytes':>14} {'ratio a/b':>14}")
        for codec, row in doc["wire"].items():
            cnt = f"{row['frames']['a']:g}/{row['frames']['b']:g}"
            ratio = f"{row['ratio']['a']:.2f}/{row['ratio']['b']:.2f}"
            print(f"{codec:<12} {cnt:>12} "
                  f"{row['wire_bytes']['delta']:>+14g} {ratio:>14}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="diststat", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd")
    ps = sub.add_parser("summarize", help="aggregate one run's JSONL trail")
    ps.add_argument("paths", nargs="+")
    ps.add_argument("--format", choices=("text", "json"), default="text")
    pd = sub.add_parser("diff", help="counter/latency deltas of two runs")
    pd.add_argument("a")
    pd.add_argument("b")
    pd.add_argument("--format", choices=("text", "json"), default="text")
    pm = sub.add_parser("merge", help="fleet view: one trail per "
                                      "process, per-process breakdowns")
    pm.add_argument("paths", nargs="+")
    pm.add_argument("--format", choices=("text", "json"), default="text")
    args = p.parse_args(argv)
    if args.cmd is None:
        p.print_usage(sys.stderr)
        return 2
    try:
        if args.cmd == "summarize":
            doc = summarize_run(args.paths)
        elif args.cmd == "merge":
            doc = merge_runs(args.paths)
        else:
            doc = diff_runs([args.a], [args.b])
    except OSError as e:
        print(f"diststat: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(doc, indent=2, sort_keys=True))
    elif args.cmd == "summarize":
        _print_summary(doc)
    elif args.cmd == "merge":
        _print_merge(doc)
    else:
        _print_diff(doc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
