"""Tracing and step timing — counterpart of
``distlearn_tpu/utils/profiling.py``: a ``torch.profiler`` trace capture in
place of ``jax.profiler``'s, and the same wall-clock step timer (its
progress meter has no user in the port).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from distlearn_tpu_torch.utils.platform import resolve_device


#: seconds the profiler's window stays open and idle before the profiled
#: work starts: torch.profiler on the card drops kernels launched just
#: after its window opens, none after a synchronize and this pause
#: (``python -m distlearn_tpu_torch.utils.profiler_probe`` measures it).
SETTLE_S = 0.05


@contextlib.contextmanager
def settled_profile(activities, sync=None):
    """``torch.profiler.profile(activities=activities)`` whose window is
    open and settled when the block starts: ``sync()`` (a device
    synchronize; nothing when ``None``), then ``SETTLE_S`` seconds, both
    inside the window.  Yields the profiler."""
    from torch.profiler import profile
    with profile(activities=activities) as prof:
        if sync is not None:
            sync()
        time.sleep(SETTLE_S)
        yield prof


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed steps with ``torch.profiler`` (host activity,
    and the card's unless ``device="cpu"``) and write a Chrome/Perfetto
    trace, ``<log_dir>/trace.json``, when the block exits.  The window is
    settled first (:func:`settled_profile`: a synchronize of the card and
    ``SETTLE_S``), so no kernel of the block is lost.  Yields the
    profiler, so a caller can read ``key_averages()``."""
    import torch
    from torch.profiler import ProfilerActivity
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else None
    with settled_profile(activities, sync) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with warmup discard.

    Call ``tick()`` at step boundaries.  PyTorch returns before the card
    finishes, so intermediate ticks measure enqueue time in steady state;
    the caller synchronises (``torch.cuda.synchronize``) at the end of a
    window, as the JAX caller blocks on the final step.
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: list[float] = []
        self._last: float | None = None

    def tick(self, steps: int = 1):
        """``steps``: how many training steps the interval since the last
        tick covered; the recorded interval is normalised to one step."""
        now = time.perf_counter()
        if self._last is not None:
            self._times.append((now - self._last) / max(1, steps))
        self._last = now

    def reset_window(self):
        """Drop the in-progress interval — call after an out-of-band
        synchronise (checkpoint, profiler boundary) so the drain is not
        recorded as one giant step."""
        self._last = None

    @property
    def steps(self) -> int:
        return max(0, len(self._times) - self.warmup)

    def mean(self) -> float:
        xs = self._times[self.warmup:]
        return float(np.mean(xs)) if xs else float("nan")

    def p50(self) -> float:
        xs = self._times[self.warmup:]
        return float(np.median(xs)) if xs else float("nan")

    def steps_per_sec(self) -> float:
        m = self.mean()
        return 1.0 / m if m and m == m and m > 0 else float("nan")
