"""The profiled window of a ``--trace 1`` run and what is read from it.

``settled_profile`` and ``SETTLE_S`` are copies of the port's
``utils/profiling.py`` (torch.profiler on the card drops kernels launched
just after its window opens, none after a synchronize and this pause);
``CLASSES`` is a copy of ``tools/analyze_trace.py``'s.  The trace is the
profiler's Chrome trace, written under the run's temporary directory and
removed once read.

On the card only the device's activity is profiled (kernels, copies and
sets, and the CUDA runtime calls that CUPTI records with them): recording
every host op costs the host microseconds an op, which would slow a
launch-bound step and inflate the idle share it is meant to read.  The
window runs from the first device event of the profiled steps to the end
of the last.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass

SETTLE_S = 0.05
#: the host span that bounds the profiled window
WINDOW_SPAN = "portbench.window"

#: (class, substrings of a kernel's name), first match wins; the rest is
#: ``OTHER``
CLASSES = (
    ("B1 fused_sgd", ("sgd_chunk",)),
    ("B2 fused_elastic", ("elastic_vec4", "elastic_scalar")),
    ("B3 quantize_ef", ("amax_leaves", "quant_ef_leaves")),
    ("B4 dequant_add", ("dequant_add",)),
    ("B5a flash forward", ("flash_fwd",)),
    ("B5b flash dK/dV", ("flash_bwd_dkv",)),
    ("B5c flash dQ", ("flash_bwd_dq",)),
    ("gemm/convolution", ("gemm", "xmma", "cutlass", "cudnn", "conv",
                          "winograd", "implicit", "dgrad", "wgrad",
                          "fprop", "cublas", "sm90_", "sm80_")),
    ("nccl", ("nccl",)),
    ("copy", ("Memcpy", "Memset", "CatArrayBatchedCopy", "copy_kernel")),
)
OTHER = "elementwise/reduce"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def classify(name: str) -> str:
    for cls, subs in CLASSES:
        if any(s in name for s in subs):
            return cls
    return OTHER


@contextlib.contextmanager
def settled_profile(activities, sync=None):
    """``torch.profiler.profile(activities=activities)`` whose window is
    open and settled when the block starts: ``sync()``, then ``SETTLE_S``
    seconds, both inside the window.  Yields the profiler."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        if sync is not None:
            sync()
        time.sleep(SETTLE_S)
        yield prof


@dataclass
class Trace:
    """A profiled window: ``kernels`` ``[(name, start_us, dur_us)]`` of the
    device, ``host`` ``[(name, start_us, dur_us)]`` of the host's ops and
    spans, and the window ``[start_us, end_us]``."""
    kernels: list
    host: list
    start: float
    end: float
    steps: int = 0

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6


def load(path: str, steps: int) -> Trace:
    """The Chrome trace at ``path``: its device events, its host events,
    and its window: the span ``WINDOW_SPAN`` where the host was profiled,
    else the first device event to the end of the last."""
    with open(path) as fh:
        data = json.load(fh)
    ev = data["traceEvents"] if isinstance(data, dict) else data
    kernels, host, win = [], [], None
    for e in ev:
        if e.get("ph") != "X":
            continue
        row = (str(e.get("name", "?")), float(e["ts"]), float(e.get("dur", 0)))
        if e.get("cat") in DEVICE_CATS:
            kernels.append(row)
        elif e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime",
                              "cuda_driver"):
            if row[0] == WINDOW_SPAN and e.get("cat") == "user_annotation":
                win = row
            else:
                host.append(row)
    if win is not None:
        return Trace(kernels, host, win[1], win[1] + win[2], steps)
    if not kernels:
        raise ValueError(f"no device event and no {WINDOW_SPAN} span in "
                         f"{path}")
    return Trace(kernels, host, min(s for _, s, _ in kernels),
                 max(s + d for _, s, d in kernels), steps)


def profile_steps(run_steps, steps: int, on_card: bool = True) -> Trace:
    """Runs ``run_steps()`` (``steps`` steps, ending in a synchronize)
    inside a settled profile of the card (of the host when ``on_card`` is
    false), and returns its trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]
    tmp = tempfile.mkdtemp(prefix="portbench-trace-")
    try:
        with settled_profile(acts, torch.cuda.synchronize if on_card
                             else None) as prof:
            with record_function(WINDOW_SPAN):
                run_steps()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return load(path, steps)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _clip(rows, lo: float, hi: float) -> list[tuple[float, float]]:
    """``[(start, end)]`` of ``rows`` cut to ``[lo, hi]``."""
    out = []
    for _, s, d in rows:
        a, b = max(s, lo), min(s + d, hi)
        if b > a:
            out.append((a, b))
    return out


def busy_intervals(tr: Trace) -> list[tuple[float, float]]:
    """The union of the device's events inside the window, merged."""
    merged: list[list[float]] = []
    for a, b in sorted(_clip(tr.kernels, tr.start, tr.end)):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) * 1e-6


def idle_gaps(tr: Trace) -> list[tuple[float, float]]:
    """The window's stretches with no device event."""
    gaps, t = [], tr.start
    for a, b in busy_intervals(tr):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if tr.end > t:
        gaps.append((t, tr.end))
    return gaps


def class_us(tr: Trace) -> dict[str, float]:
    """Device microseconds in the window by kernel class."""
    out: dict[str, float] = {}
    for name, s, d in tr.kernels:
        a, b = max(s, tr.start), min(s + d, tr.end)
        if b > a:
            cls = classify(name)
            out[cls] = out.get(cls, 0.0) + (b - a)
    return out


def name_us(tr: Trace, match) -> float:
    """Device microseconds in the window of kernels whose name ``match``
    accepts."""
    return sum(min(s + d, tr.end) - max(s, tr.start)
               for name, s, d in tr.kernels
               if match(name) and min(s + d, tr.end) > max(s, tr.start))


def _host_at(tr: Trace, t: float, starts: list, back: int = 4000) -> str:
    """The innermost host call running at ``t``: of those that cover it,
    the one that began last (calls nest), looked for among the ``back``
    that began last before ``t``; else ``"host between calls"``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - back), -1):
        name, s, d = tr.host[j]
        if s + d > t:
            return name
    return "host between calls"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing when each gap began, in seconds."""
    ops: dict[str, float] = {}
    for name, s, d in tr.kernels:
        a, b = max(s, tr.start), min(s + d, tr.end)
        if b > a:
            ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
    gaps: dict[str, float] = {}
    tr.host.sort(key=lambda r: r[1])
    starts = [s for _, s, _ in tr.host]
    for a, b in idle_gaps(tr):
        key = _host_at(tr, a, starts)
        gaps[key] = gaps.get(key, 0.0) + (b - a) * 1e-6
    by = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                          key=lambda kv: -kv[1])[:top]
    return {"device_ops": by(ops), "idle_gaps": by(gaps)}
