"""The allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at the window's start), in GiB."""

LAYER = None
UNIT = "GiB"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = None


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
