"""Device idle time a step while the host was gathering a batch: the
profiled window's stretches with no device event that lie inside the
port's ``data.gather`` spans, joined to the trace on its clock, over the
profiled steps."""

from portbench import spans

LAYER = "data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    return spans.idle_ms(run, spans.GATHER)
