"""The dispatcher's batch fill: requests a batch over --max-batch, from
the engine's /metrics ``requests`` and ``batches`` over the window."""

from benchmark.metrics._layers import batch_fill


def read(run):
    return batch_fill(run)
