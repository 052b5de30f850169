"""The port's own spans and collective counts, read for the per-layer
metrics of a ``--trace 1`` run and joined to its profiled window's device
trace on one clock.

The port records, unless ``DISTLEARN_OBS=0``, one trace a step: the root
span ``train.step{step="sgd"}``, whose duration is the observation of
``train_step_dispatch_seconds`` (``dispatch_ms``), with its phases as
children (``train.forward``, ``train.backward``, ``train.grad_sum``,
``train.update``); and a span ``data.gather`` for each batch its device
dataset gathers, which the feed takes before the step.  They stay in its
in-memory ring (``distlearn_tpu_torch.obs.trace``, newest 4096 records).
The readers run after the profiled window, in the run's process, so the
ring ends with the profiled window's ``trace.steps`` steps, and the
measured window's ``run.steps`` steps come just before them.  A ring that
lost records the window needs fails the run.

A span record's ``start`` is epoch seconds.  The profiler's Chrome trace
counts microseconds from ``baseTimeNanoseconds``, a base that stays fixed
for the process (a multiple of 7,889,238 s, the same in every session),
which :func:`profiler_base_us` reads from an empty profile's export; a
span's start on the trace's clock is ``start * 1e6 - base_us``.

The profiled window's spans are added to the trace's host rows when
first read, so :func:`portbench.trace.breakdown` names the step's phase or
the feed where the card sat idle, in a run whose cell lists one of the
readers of this module; the counts of kernel-launch rows and kernel rows
are logged beside them (a dropped kernel record reads as idle).
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import tempfile
from dataclasses import dataclass, field

from portbench import trace

ROOT = "train.step"
PHASES = ("train.forward", "train.backward", "train.grad_sum",
          "train.update")
GATHER = "data.gather"
#: the step whose spans are read, the label of ``harness.DISPATCH``
STEP = "sgd"
#: runtime rows that launch one kernel each
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
#: device rows that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")
_ATTR = "_program_spans"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Steps:
    """The run's step roots and feed spans, split into the measured
    window's and the profiled window's; ``children`` maps a trace id to
    its root's child spans."""
    window: list
    profiled: list
    children: dict
    gathers_window: list = field(default_factory=list)
    gathers_profiled: list = field(default_factory=list)
    base_us: float | None = None


def ring() -> tuple[list[dict], int]:
    """The port's span records (oldest first) and the count of records its
    ring evicted."""
    from distlearn_tpu_torch.obs import trace as obs_trace
    dropped = sum(counter("obs_spans_dropped_total").values())
    return obs_trace.spans(), int(dropped)


def counter(name: str) -> dict[str, float]:
    """``{site: value}`` of the port's counter ``name`` (one ``""`` entry
    for a counter without labels), empty where it has none."""
    from distlearn_tpu_torch.obs import REGISTRY
    for fam in REGISTRY.snapshot():
        if fam["name"] == name:
            return {s["labels"].get("site", ""): s["value"]
                    for s in fam["samples"]}
    return {}


def profiler_base_us() -> float:
    """The process's profiler base, ``baseTimeNanoseconds`` in
    microseconds, from the export of an empty CPU profile."""
    from torch.profiler import ProfilerActivity, profile
    tmp = tempfile.mkdtemp(prefix="portbench-base-")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            pass
        path = os.path.join(tmp, "base.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return float(json.load(fh)["baseTimeNanoseconds"]) / 1e3
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def split(recs: list[dict], n_window: int, n_profiled: int,
          dropped: int = 0) -> Steps | None:
    """The records of the last ``n_window + n_profiled`` steps; ``None``
    where ``recs`` holds no step root.  Raises where the ring lost
    records those steps need."""
    roots = [r for r in recs if r["name"] == ROOT
             and r.get("labels", {}).get("step") == STEP]
    if not roots or n_window < 1:
        return None
    need = n_window + n_profiled
    before = roots[-need - 1]["ts"] if len(roots) > need else -math.inf
    if len(roots) < need or (dropped and recs[0]["ts"] > before):
        raise RuntimeError(
            f"the port's span ring lost records of the window: it holds "
            f"{len(roots)} step roots for {need} steps and evicted "
            f"{dropped} records (obs_spans_dropped_total)")
    window = roots[len(roots) - need:len(roots) - n_profiled]
    profiled = roots[len(roots) - n_profiled:]
    ids = {r.get("span") for r in window + profiled} - {None}
    children: dict = {}
    for r in recs:
        if r.get("parent") in ids:
            children.setdefault(r["trace"], []).append(r)
    gathers = [r for r in recs if r["name"] == GATHER]
    end_w = window[-1]["ts"] if window else before
    end_p = profiled[-1]["ts"] if profiled else end_w
    return Steps(window, profiled, children,
                 [r for r in gathers if before < r["ts"] <= end_w],
                 [r for r in gathers if end_w < r["ts"] <= end_p])


def attach(run, recs: list[dict], dropped: int = 0,
           base_us: float | None = None) -> Steps | None:
    """Splits ``recs`` for ``run`` and keeps the result on it; with a
    profiled window, adds the profiled spans to its host rows on the
    trace's clock (``base_us``, else the process's profiler base)."""
    tr = run.trace
    steps = split(recs, run.steps, tr.steps if tr is not None else 0,
                  dropped)
    setattr(run, _ATTR, steps)
    if steps is None or tr is None:
        return steps
    launches = sum(1 for name, _, _ in tr.host if name.startswith(LAUNCHES))
    kernels = sum(1 for name, _, _ in tr.kernels
                  if not name.startswith(NOT_KERNELS))
    log(f"[portbench] profiled window: {launches} kernel-launch rows, "
        f"{kernels} kernel rows")
    steps.base_us = profiler_base_us() if base_us is None else base_us
    rows = [r for root in steps.profiled
            for r in [root] + steps.children.get(root.get("trace"), [])]
    tr.host.extend(on_trace(r, steps.base_us)
                   for r in rows + steps.gathers_profiled)
    _summary(run, steps)
    return steps


def _summary(run, steps: Steps) -> None:
    """On stderr, the two numbers no metric carries: the root's own host
    time (the measured window's dispatch less its phases) and the profiled
    window's device idle time outside both the roots and the gathers, ms a
    step."""
    own = sum(r["dur"] - sum(c["dur"] for c in
                             steps.children.get(r.get("trace"), []))
              for r in steps.window) / len(steps.window) * 1e3
    tr = run.trace
    inside = [on_trace(r, steps.base_us)
              for r in steps.profiled + steps.gathers_profiled]
    idle = trace.idle_gaps(tr)
    outside = sum(b - a for a, b in idle) - overlap_us(
        idle, union((s, s + d) for _, s, d in inside))
    log(f"[portbench] program spans: {ROOT}'s own time {own:.4f} ms a "
        f"step (measured window); device idle outside {ROOT} and {GATHER} "
        f"{outside / tr.steps * 1e-3:.4f} ms a step (profiled window)")


def of(run) -> Steps | None:
    """``run``'s steps, split from the port's ring at the first read."""
    if not hasattr(run, _ATTR):
        recs, dropped = ring()
        attach(run, recs, dropped)
    return getattr(run, _ATTR)


def on_trace(rec: dict, base_us: float) -> tuple[str, float, float]:
    """A span record as a trace row ``(name, start_us, dur_us)``."""
    return (rec["name"], rec["start"] * 1e6 - base_us, rec["dur"] * 1e6)


def phase_ms(run, name: str) -> float | None:
    """Mean host ms a step of the measured window in the child spans
    ``name``; ``None`` where no step has one."""
    steps = of(run)
    if steps is None:
        return None
    durs = [r["dur"] for root in steps.window
            for r in steps.children.get(root.get("trace"), [])
            if r["name"] == name]
    return sum(durs) / len(steps.window) * 1e3 if durs else None


def gather_ms(run) -> float | None:
    """Mean host ms a step of the measured window in ``data.gather``."""
    steps = of(run)
    if steps is None or not steps.gathers_window:
        return None
    return sum(r["dur"] for r in steps.gathers_window) \
        / len(steps.window) * 1e3


def union(intervals) -> list[tuple[float, float]]:
    """``[(a, b)]`` merged where they overlap or touch."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def overlap_us(xs, ys) -> float:
    """The length both of two merged, sorted interval lists cover."""
    out, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_in(tr: trace.Trace, rows) -> float:
    """Device idle microseconds of the window inside the rows' union."""
    return overlap_us(trace.idle_gaps(tr),
                      union((s, s + d) for _, s, d in rows))


def idle_ms(run, which: str) -> float | None:
    """Device idle ms a profiled step inside the profiled window's
    ``which`` spans (``ROOT`` or ``GATHER``)."""
    steps = of(run)
    if steps is None or run.trace is None:
        return None
    recs = steps.profiled if which == ROOT else steps.gathers_profiled
    if not recs:
        return None
    rows = [on_trace(r, steps.base_us) for r in recs]
    return idle_in(run.trace, rows) / run.trace.steps * 1e-3
