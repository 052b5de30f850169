"""Host time a step in the port's forward: the span ``train.forward`` (the
loss, with the hand-written sync batchnorm and its collectives), a mean
per step over the measured window."""

from portbench import spans

LAYER = "model"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    return spans.phase_ms(run, "train.forward")
