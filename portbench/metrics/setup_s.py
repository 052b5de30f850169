"""Process start to the window's start: imports, the card, kernel builds
on a cold cache, the data and weights made from the seed, the first steps
(the ones ``correct`` compares) and the warm-up."""

LAYER = None
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup_s
