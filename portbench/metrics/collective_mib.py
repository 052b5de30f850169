"""Bytes the collectives reduce a step, in MiB: the port's counter
``collective_bytes_total`` over every site (sync batchnorm's statistics
and their gradients, the gradient buckets, the loss), over the steps its
dispatch histogram counted.  Both count every step of the run, set-up's
among them: an average over the run, which is the window's since every
step of the cell reduces the same buffers."""

from portbench import harness, spans

LAYER = "collectives"
UNIT = "MiB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_samples_per_s"


def read(run):
    nbytes = spans.counter("collective_bytes_total")
    _, steps = harness._dispatch_totals()
    return sum(nbytes.values()) / steps / 2**20 if nbytes and steps else None
