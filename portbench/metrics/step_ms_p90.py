"""The 90th percentile of the window's step times: the gaps between the
CUDA events recorded after each step (the first from one recorded at the
window's start), read once the window has ended.  The 90th is the highest
with ten steps beyond it in ResNet-50's window at batch 256 (about 110
steps)."""

from portbench import stats

LAYER = None
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = None


def read(run):
    return stats.p90(run.step_ms) if run.step_ms else None
