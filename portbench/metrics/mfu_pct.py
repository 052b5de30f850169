"""The whole step's share of the card's peak: model FLOPs a sample
(convolutions and dense layers, x 6) times the samples of the window, over
the window's time and the peak of the configuration's compute precision."""

from portbench import roofline

LAYER = "whole step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "train_samples_per_s"


def read(run):
    peak = roofline.PEAK_FLOPS[run.cfg["compute_dtype"]]
    achieved = run.flops_per_sample * run.samples / run.window_s
    return 100.0 * achieved / peak if run.samples else None
