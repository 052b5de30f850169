"""Samples of every step completed in the window over the window's time;
the window ends in a synchronize."""

from portbench import stats

LAYER = None
UNIT = "samples/s"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return stats.rate(run.samples, run.window_s) if run.samples else None
