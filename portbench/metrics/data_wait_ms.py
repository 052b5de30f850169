"""Host time a step waits for its batch: the harness's span around taking
each batch from the port's feed, a mean per step over the window."""

LAYER = "data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    waits = run.data_wait_s
    return sum(waits) / len(waits) * 1e3 if waits else None
