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


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed steps with ``torch.profiler`` (host activity,
    and the card's unless ``device="cpu"``) and write a Chrome/Perfetto
    trace, ``<log_dir>/trace.json``, when the block exits.  Yields the
    profiler, so a caller can read ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile
    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + \
        ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
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
