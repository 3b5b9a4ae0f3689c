"""The whole model step's share of the chip's peak: the model FLOPs of
the answers completed in the window, outside the traced slice, a second,
over 989 TFLOP/s (the callers' clock)."""

from benchmark.metrics._layers import mfu


def read(run):
    return mfu(run)
