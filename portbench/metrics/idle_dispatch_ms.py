"""Device idle time a step while the host was inside a step call: the
profiled window's stretches with no device event that lie inside the
port's ``train.step`` spans, joined to the trace on its clock, over the
profiled steps."""

from portbench import spans

LAYER = "step builder"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    return spans.idle_ms(run, spans.ROOT)
