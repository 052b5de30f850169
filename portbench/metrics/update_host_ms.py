"""Host time a step in the SGD update: the span ``train.update`` (B1's
launches, one a bucket), a mean per step over the measured window."""

from portbench import spans

LAYER = "kernels"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    return spans.phase_ms(run, "train.update")
