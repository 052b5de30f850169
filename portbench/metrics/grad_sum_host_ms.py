"""Host time a step in the gradient sum: the span ``train.grad_sum`` (the
bucket plan, the packing of the gradients into buckets and their
allreduce), a mean per step over the measured window."""

from portbench import spans

LAYER = "collectives"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    return spans.phase_ms(run, "train.grad_sum")
