"""Device time a step in elementwise and reduction kernels (the class
``elementwise/reduce``: batchnorm's passes, ReLU, pooling, the loss),
from the profiled window."""

from portbench import trace

LAYER = "model"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    us = trace.class_us(run.trace).get(trace.OTHER, 0.0)
    return us / run.trace.steps * 1e-3 if us else None
