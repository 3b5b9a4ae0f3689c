"""Per-layer metrics: one file each, ``<metric name>.py``, found by the
metric's name in ``BENCHMARK.json``. Each has ``read(run)``, which returns
the metric's value, or None where the run gives it nothing to read (the
harness then leaves the metric out). Shared arithmetic is in
``_layers.py``; each file names its own kernels and spans."""
