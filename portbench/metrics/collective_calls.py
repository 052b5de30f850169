"""Collective calls a step: the port's counter ``collective_calls_total``
over every site (sync batchnorm's forward and backward, the gradient
buckets, the loss), over the steps its dispatch histogram counted.  Both
count every step of the run, set-up's among them: an average over the
run, which is the window's since a step of the cell issues the same calls
as any other."""

from portbench import harness, spans

LAYER = "collectives"
UNIT = "calls"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "train_samples_per_s"


def read(run):
    calls = spans.counter("collective_calls_total")
    _, steps = harness._dispatch_totals()
    return sum(calls.values()) / steps if calls and steps else None
