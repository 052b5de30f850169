"""Kernel B1 (``sgd_chunk``, ``ops/csrc/fused_update.cu``): the least time
SGD's update of the configuration's parameters needs (12 bytes a
parameter at the HBM rate) over B1's device time a step, from the
profiled window."""

from portbench import roofline, trace

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "train_samples_per_s"


def read(run):
    us = trace.name_us(run.trace, lambda name: "sgd_chunk" in name)
    if not us:
        return None
    per_step_s = us * 1e-6 / run.trace.steps
    return 100.0 * roofline.sgd_bound_s(run.params) / per_step_s
