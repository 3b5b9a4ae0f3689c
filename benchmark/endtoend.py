"""End-to-end metrics from the callers' records (the harness's host clock),
by name as ``BENCHMARK.json`` lists them."""


def ok(rec, samples):
    return rec["status"] == 200 and rec["samples"] == samples


def answered_in(run, t0, t1):
    """The requests answered correctly between t0 and t1."""
    return [r for r in run.records if ok(r, run.samples) and t0 <= r["done"]
            <= t1]


def requests_per_s(run):
    """Requests answered correctly within the window, over its seconds."""
    t0, t1 = run.window
    return len(answered_in(run, t0, t1)) / (t1 - t0)


def setup_s(run):
    """From the process's start to the window's first request."""
    return run.window[0] - run.t_start


METRICS = {f.__name__: f for f in (requests_per_s, setup_s)}
