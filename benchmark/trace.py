"""The traced run's sources: host spans that the benchmark records around
the calls into the program's layers, and the device's activity from a
``torch.profiler`` capture of a fixed slice of the window, reduced to
kernel intervals, each tied to the host span that launched it.

Spans (the benchmark's own, not the program's): ``dispatch`` (a batch
assembled and launched), ``synth_mel`` (latents, encoder, flows, gate),
``vocode`` (WaveGlow and the PCM) and ``complete`` (the copy to the host
and the hand-out). Each records its start and end on the profiler's clock
(``time.time_ns``) and the shapes that set its work.

The capture costs the server host time: CUPTI's callbacks on every
launch, and the trace's processing after the slice, which holds the
interpreter lock. The run reports the answers a second within the slice
beside the window's (``run.Run.slice_rate``).
"""

import bisect
import threading
import time
from collections import defaultdict


class Spans:
    """Wraps program methods with span recorders (instance attributes, so
    the program's own code finds them)."""

    def __init__(self):
        self.spans = []              # (name, t0_ns, t1_ns, attrs)
        self._lock = threading.Lock()

    def wrap(self, obj, method, name, attrs):
        original = getattr(obj, method)

        def recorded(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return original(*args, **kwargs)
            finally:
                with self._lock:
                    self.spans.append((name, t0, time.time_ns(),
                                       attrs(*args, **kwargs)))

        setattr(obj, method, recorded)

    def install(self, engine):
        """The layer boundaries of a serving engine."""
        self.wrap(engine, "_dispatch_batch", "dispatch",
                  lambda batch: {"requests": len(batch)})
        self.wrap(engine, "_synth_mel", "synth_mel",
                  lambda seeds, sigmas, sids, text, in_lens, *a, **k: {
                      "B": len(seeds), "Tk": int(text.shape[1]),
                      "in_lens": [int(n) for n in in_lens]})
        self.wrap(engine, "_vocode_norm", "vocode",
                  lambda mel, *a, **k: {"B": int(mel.shape[0]),
                                        "frames": int(mel.shape[2])})
        self.wrap(engine, "_complete_batch", "complete",
                  lambda batch, handles: {"requests": len(batch)})


def _short(name):
    """A kernel's name without its return type, namespace marker and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    return name[5:] if name.startswith("void ") else name


class DeviceTrace:
    """A capture's device intervals over [t0_ns, t1_ns), each kernel tied
    to its launch (the host API call with its correlation id) and to the
    benchmark span around that launch."""

    def __init__(self, events, t0_ns, t1_ns, spans):
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        host_calls = {}
        device = []
        for e in events:
            if str(e.device_type()).endswith("CUDA"):
                s, d = e.start_ns(), e.duration_ns()
                if d > 0 and s + d > t0_ns and s < t1_ns:
                    device.append((max(s, t0_ns), min(s + d, t1_ns),
                                   e.name(), e.correlation_id()))
            elif e.name().startswith("cu"):
                host_calls[e.correlation_id()] = e.start_ns()
        device.sort()
        self.device = device
        by_name = defaultdict(list)
        for s in spans:
            by_name[s[0]].append(s)
        self._spans = {k: sorted(v, key=lambda s: s[1])
                       for k, v in by_name.items()}
        self._starts = {k: [s[1] for s in v] for k, v in self._spans.items()}
        self._launch = host_calls

    def _span_at(self, name, t_ns):
        """A span called ``name`` open at t_ns, or None."""
        spans = self._spans.get(name, ())
        i = bisect.bisect_right(self._starts.get(name, ()), t_ns)
        for sp in reversed(spans[max(0, i - 8):i]):
            if sp[2] >= t_ns:
                return sp
        return None

    # -- the device's busy time ---------------------------------------
    def busy_intervals(self):
        """The union of the device's activity intervals, in order."""
        out = []
        for s, e, _n, _c in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self):
        return (self.t1_ns - self.t0_ns) / 1e9

    def top_ops(self, n=10):
        total = defaultdict(int)
        for s, e, name, _c in self.device:
            total[_short(name)] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def active_spans(self, t_ns):
        """The names of the benchmark spans open on the host at t_ns."""
        return sorted(n for n in self._spans
                      if self._span_at(n, t_ns) is not None)

    def idle_gaps(self, n=10):
        """The device's idle time in the slice, summed by what the host was
        doing (the benchmark spans open at each gap's middle)."""
        total = defaultdict(int)
        t = self.t0_ns
        for s, e in self.busy_intervals() + [[self.t1_ns, self.t1_ns]]:
            if s > t:
                label = "+".join(self.active_spans((s + t) // 2)) \
                    or "no model span"
                total[label] += s - t
            t = max(t, e)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    # -- kernels by launch ------------------------------------------------
    def kernels(self, pattern, span_names):
        """[(seconds, span, index)] of the kernels whose name matches
        ``pattern`` (a compiled regex) and that were launched inside a span
        among ``span_names`` opened within the slice: the span and the
        kernel's order among that span's matching launches. Kernels of a
        span opened before the slice, or cut by its end, are left out."""
        out = []
        counts = defaultdict(int)
        for s, e, name, corr in self.device:
            if not pattern.search(name):
                continue
            launch = self._launch.get(corr)
            if launch is None:
                continue
            span = next((sp for sp in (self._span_at(n, launch)
                                       for n in span_names)
                         if sp is not None), None)
            if span is None or span[1] < self.t0_ns:
                continue
            idx = counts[span[1]]
            counts[span[1]] += 1
            if e < self.t1_ns:
                out.append(((e - s) / 1e9, span, idx))
        return out


def prime(device):
    """Start and stop a profiler once, before the program loads: a process
    whose first capture comes after the server is built records no device
    activity at all (torch 2.11 on the H100 machine)."""
    import torch

    x = torch.ones(8, device=device)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    (x + 1).sum().item()
    prof.stop()


def capture(seconds, spans, device):
    """Profile the process's device activity (CUDA: kernels, copies and the
    host API calls that launched them; no host operators, whose recording
    would slow the server) for ``seconds``; returns the ``DeviceTrace`` of
    the slice and the slice's (start, end) on ``time.monotonic``."""
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    t0, m0 = time.time_ns(), time.monotonic()
    time.sleep(seconds)
    torch.cuda.synchronize(device)
    t1, m1 = time.time_ns(), time.monotonic()
    prof.stop()
    return DeviceTrace(prof.profiler.kineto_results.events(), t0, t1,
                       list(spans.spans)), (m0, m1)
