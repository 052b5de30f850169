"""Host time a step in the device dataset's gather: the span
``data.gather`` (the index vector's copy to the card and the two
``index_select`` launches), a mean per step over the measured window; the
program's own counterpart of ``data_wait_ms``."""

from portbench import spans

LAYER = "data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "train_samples_per_s"


def read(run):
    return spans.gather_ms(run)
