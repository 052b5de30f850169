"""Host time to enqueue one step: the port's obs histogram
``train_step_dispatch_seconds{step="sgd"}``, its sum over its count over
the window."""

LAYER = "step builder"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_samples_per_s"


def read(run):
    total, count = run.dispatch
    return total / count * 1e3 if count else None
