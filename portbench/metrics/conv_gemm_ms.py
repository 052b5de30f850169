"""Device time a step in convolutions and matrix products (the class
``gemm/convolution``), from the profiled window."""

from portbench import trace

LAYER = "model"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    us = trace.class_us(run.trace).get("gemm/convolution", 0.0)
    return us / run.trace.steps * 1e-3 if us else None
