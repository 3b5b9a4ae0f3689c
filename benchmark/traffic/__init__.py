"""Traffic kinds: one module each, named by a workload file's
``traffic.kind``. Each has ``schedule(params, seed, seconds)``, run in the
harness (a pure function of the seed), and ``drive(schedule, send, t0,
seconds)``, run in the client process: it calls ``send(i, due)`` for each
request it makes and returns nothing; ``send`` records the request. A
schedule's ``connections`` (if any) are opened before the window. Both
use the standard library only: the client process imports no torch."""

import importlib


def kind(name):
    return importlib.import_module(f"benchmark.traffic.{name}")
