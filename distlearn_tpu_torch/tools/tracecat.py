"""tracecat — stitch multi-process obs trails into per-trace waterfalls.

With ``DISTLEARN_TRACE_PROP`` on, every process participating in one
logical operation (an AsyncEA sync, a serve request) emits span records
carrying the same ``trace`` id into its own JSONL trail
(distlearn_tpu_torch/obs/trace.py).  This tool joins those trails back into
one tree per trace:

    python -m distlearn_tpu_torch.tools.tracecat list  client.jsonl center.jsonl ...
    python -m distlearn_tpu_torch.tools.tracecat show  *.jsonl --trace <id16>
    python -m distlearn_tpu_torch.tools.tracecat show  *.jsonl            # newest trace
    python -m distlearn_tpu_torch.tools.tracecat show  *.jsonl --format json

``list`` prints one line per trace (id, root span, span count, total
wall time, processes involved).  ``show`` renders the waterfall — spans
indented by parentage, one bar per span over the trace's wall-clock
window — plus the critical-path attribution: which leg/queue-wait
dominated the trace end-to-end, and the per-span-name share of the
root's duration.

Span records carry end timestamps (``ts`` at exit) and ``dur``; starts
are reconstructed as ``ts - dur``.  Trails from one machine share a
clock; cross-machine skew shifts bars but never breaks parentage.

Record schema: docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_spans(paths: list[str]) -> list[dict]:
    """All traced span records (``type == "span"`` with a ``trace`` id)
    from the given JSONL trails.  Untraced spans and snapshot records
    are skipped; torn tail lines of live runs are tolerated.  Each
    record gains ``_src`` (the file it came from) for per-process
    attribution when the emitter set no ``proc``."""
    out = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("type") == "span" and rec.get("trace"):
                    rec["_src"] = path
                    out.append(rec)
    return out


def group_traces(spans: list[dict]) -> dict[str, list[dict]]:
    """trace id -> its spans, each trace's spans sorted by start time."""
    by: dict[str, list[dict]] = {}
    for rec in spans:
        by.setdefault(rec["trace"], []).append(rec)
    for recs in by.values():
        recs.sort(key=_start)
    return by


def _start(rec: dict) -> float:
    return float(rec["ts"]) - float(rec["dur"])


def _proc(rec: dict) -> str:
    return rec.get("proc") or rec.get("_src", "?")


def build_tree(recs: list[dict]) -> tuple[list[dict], dict[str, list]]:
    """``(roots, children)`` of one trace: spans with no ``parent`` (or
    a parent missing from the trails — a truncated ring) are roots;
    ``children`` maps span id -> child records sorted by start."""
    by_id = {r["span"]: r for r in recs if r.get("span")}
    children: dict[str, list] = {}
    roots = []
    for r in recs:
        p = r.get("parent")
        if p and p in by_id:
            children.setdefault(p, []).append(r)
        else:
            roots.append(r)
    for v in children.values():
        v.sort(key=_start)
    roots.sort(key=_start)
    return roots, children


def critical_path(recs: list[dict]) -> list[dict]:
    """Root-to-leaf chain that determined the trace's end time: from
    each span, follow the child that FINISHED last — the leg everything
    else waited for.  (Fan-out legs run concurrently; the last to end
    gates the parent, so this is the chain to shorten first.)"""
    roots, children = build_tree(recs)
    if not roots:
        return []
    node = max(roots, key=lambda r: float(r["ts"]))
    path = [node]
    while children.get(node.get("span")):
        node = max(children[node["span"]], key=lambda r: float(r["ts"]))
        path.append(node)
    return path


def attribution(recs: list[dict]) -> list[dict]:
    """Per span-name totals for one trace: count, summed duration, and
    share of the trace's wall window — the "which leg dominated" table.
    Shares can exceed 1.0 summed: concurrent legs overlap."""
    t0 = min(_start(r) for r in recs)
    t1 = max(float(r["ts"]) for r in recs)
    wall = max(t1 - t0, 1e-12)
    by: dict[str, dict] = {}
    for r in recs:
        row = by.setdefault(r["name"], {"name": r["name"], "count": 0,
                                        "total": 0.0})
        row["count"] += 1
        row["total"] += float(r["dur"])
    for row in by.values():
        row["share"] = row["total"] / wall
    return sorted(by.values(), key=lambda r: -r["total"])


def trace_summary(tid: str, recs: list[dict]) -> dict:
    t0 = min(_start(r) for r in recs)
    t1 = max(float(r["ts"]) for r in recs)
    roots, _ = build_tree(recs)
    return {"trace": tid, "spans": len(recs),
            "root": roots[0]["name"] if roots else "?",
            "start": t0, "wall": t1 - t0,
            "procs": sorted({_proc(r) for r in recs})}


_BAR_W = 40


def waterfall(recs: list[dict]) -> list[str]:
    """Text waterfall for one trace: depth-first in start order, one
    ``[###]`` bar per span positioned on the trace's wall window."""
    t0 = min(_start(r) for r in recs)
    t1 = max(float(r["ts"]) for r in recs)
    wall = max(t1 - t0, 1e-12)
    roots, children = build_tree(recs)
    width = max((len(r["name"]) + 2 * _depth_of(r, recs)
                 for r in recs), default=10)
    lines = []

    def emit(rec, depth):
        lo = int(round((_start(rec) - t0) / wall * _BAR_W))
        hi = int(round((float(rec["ts"]) - t0) / wall * _BAR_W))
        hi = max(hi, lo + 1)
        bar = " " * lo + "#" * (hi - lo) + " " * (_BAR_W - hi)
        label = "  " * depth + rec["name"]
        lines.append(f"  {label:<{width}} |{bar}| "
                     f"{float(rec['dur']) * 1e3:9.3f} ms  {_proc(rec)}")
        for ch in children.get(rec.get("span", ""), []):
            emit(ch, depth + 1)

    for r in roots:
        emit(r, 0)
    return lines


def _depth_of(rec: dict, recs: list[dict]) -> int:
    by_id = {r["span"]: r for r in recs if r.get("span")}
    d, p = 0, rec.get("parent")
    while p and p in by_id and d < 64:
        d += 1
        p = by_id[p].get("parent")
    return d


def render_trace(tid: str, recs: list[dict]) -> str:
    s = trace_summary(tid, recs)
    out = [f"trace {tid} — {s['spans']} spans, "
           f"{s['wall'] * 1e3:.3f} ms wall, procs: {', '.join(s['procs'])}",
           ""]
    out += waterfall(recs)
    cp = critical_path(recs)
    out += ["", "  critical path (the chain the trace waited on):"]
    out += [f"    {r['name']}  {float(r['dur']) * 1e3:9.3f} ms  "
            f"[{_proc(r)}]" for r in cp]
    out += ["", f"  {'span name':<28} {'count':>5} {'total ms':>10} "
                f"{'share':>7}"]
    out += [f"  {row['name']:<28} {row['count']:>5} "
            f"{row['total'] * 1e3:>10.3f} {row['share']:>6.1%}"
            for row in attribution(recs)]
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    pl = sub.add_parser("list", help="one line per trace across trails")
    pl.add_argument("paths", nargs="+")
    pl.add_argument("--format", choices=("text", "json"), default="text")
    ps = sub.add_parser("show", help="waterfall + critical path of one "
                                     "trace")
    ps.add_argument("paths", nargs="+")
    ps.add_argument("--trace", help="trace id (default: newest trace)")
    ps.add_argument("--format", choices=("text", "json"), default="text")
    args = p.parse_args(argv)

    traces = group_traces(load_spans(args.paths))
    if not traces:
        print("no traced spans found (is DISTLEARN_TRACE_PROP on?)",
              file=sys.stderr)
        return 1
    if args.cmd == "list":
        rows = sorted((trace_summary(t, rs) for t, rs in traces.items()),
                      key=lambda s: s["start"])
        if args.format == "json":
            print(json.dumps(rows, indent=2))
        else:
            for s in rows:
                print(f"{s['trace']}  {s['root']:<20} {s['spans']:>4} "
                      f"spans  {s['wall'] * 1e3:9.3f} ms  "
                      f"{len(s['procs'])} procs")
        return 0
    tid = args.trace
    if tid is None:
        tid = max(traces, key=lambda t: trace_summary(t, traces[t])["start"])
    if tid not in traces:
        print(f"trace {tid!r} not found in these trails", file=sys.stderr)
        return 1
    if args.format == "json":
        cp = critical_path(traces[tid])
        print(json.dumps({"summary": trace_summary(tid, traces[tid]),
                          "spans": traces[tid],
                          "critical_path": [r["span"] for r in cp],
                          "attribution": attribution(traces[tid])},
                         indent=2))
    else:
        print(render_trace(tid, traces[tid]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
