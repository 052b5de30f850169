"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import statistics


def p90(values: list[float]) -> float:
    """The 90th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def rate(count: float, seconds: float) -> float:
    return count / seconds if seconds > 0 else float("nan")


def gaps_ms(times_ms: list[float]) -> list[float]:
    """The gaps between consecutive event times."""
    return [b - a for a, b in zip(times_ms, times_ms[1:])]
