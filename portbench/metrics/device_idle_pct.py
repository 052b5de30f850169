"""The share of the profiled window that no kernel, copy or set on the
card covers."""

from portbench import trace

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    window = run.trace.window_s
    return 100.0 * (1.0 - trace.busy_s(run.trace) / window) if window else None
