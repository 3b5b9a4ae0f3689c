"""The device's idle share: the part of the traced slice covered by no
kernel, copy or set (the union of the device intervals in the trace)."""

from benchmark.metrics._layers import device_idle


def read(run):
    return device_idle(run)
