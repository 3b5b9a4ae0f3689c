"""What the probe modules share: bf16 constants, timing and
graph-captured scans."""

import math
import time

import numpy as np
import torch

# JAX rounds a Python scalar to the array's dtype before it multiplies a
# bf16 array: 0.999 becomes 1.0 and 0.001 becomes 0.00099945068359375.
BF16_0999 = float(torch.tensor(0.999).to(torch.bfloat16))
BF16_0001 = float(torch.tensor(0.001).to(torch.bfloat16))
# steps captured in one CUDA graph (gcd(steps, GRAPH_CHUNK) when it does not
# divide the scan)
GRAPH_CHUNK = 100

_side = {}


def tensor(a, device, dtype=None):
    """A numpy array on ``device``, as ``dtype`` (rounded to nearest even
    for bf16, as JAX's ``astype``)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def bf16_carry(carry, y):
    """The scripts' scan update on bf16 arrays, ``0.999 * carry + 0.001 *
    y``, one bf16 rounding per operation with bf16 constants, as JAX
    computes it."""
    return carry * BF16_0999 + BF16_0001 * y


def side_stream(device):
    """One warm-up stream per device for the whole process: cuBLAS keeps a
    workspace for every stream it has seen."""
    if device not in _side:
        _side[device] = torch.cuda.Stream(device)
    return _side[device]


def scan(step, x0, steps, graph=True):
    """A callable that runs ``carry = step(carry)`` ``steps`` times from
    ``x0`` and returns the final carry. With ``graph`` on the card, the
    loop body is captured GRAPH_CHUNK steps at a time in one CUDA graph
    and replayed, so host dispatch does not count: for steps that finish
    faster than Python launches them (the library baselines). Otherwise
    it is a plain loop, so a kernel wrapper called by ``step`` counts
    every launch it makes."""
    if not graph or x0.device.type != "cuda":
        def run():
            carry = x0
            for _ in range(steps):
                carry = step(carry)
            return carry
        return run
    chunk = math.gcd(steps, GRAPH_CHUNK)
    static = x0.clone()
    side = side_stream(x0.device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(static.clone())
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    captured = torch.cuda.CUDAGraph()
    with torch.cuda.graph(captured):
        carry = static
        for _ in range(chunk):
            carry = step(carry)
        static.copy_(carry)

    def run():
        static.copy_(x0)
        for _ in range(steps // chunk):
            captured.replay()
        return static
    return run


def time_per_step(run, steps, reps=3):
    """The scripts' measure: ``run()`` once to warm up, then the fastest of
    ``reps`` runs over ``steps``, in microseconds a step (device time by
    CUDA events on the card, the host clock on the CPU). Returns (us a
    step, the last output)."""
    out = run()
    best = math.inf
    for _ in range(reps):
        if _on_cuda(out):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            out = run()
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best / steps * 1e6, out


def _on_cuda(out):
    first = out[0] if isinstance(out, (tuple, list)) else out
    return first.device.type == "cuda"


def parse_args(argv, defaults):
    """The scripts' positional ``[B] [STEPS]``: ints in order, defaults
    where absent."""
    vals = [int(a) for a in (argv or [])]
    return list(vals) + list(defaults[len(vals):])
