"""The readers' shared arithmetic over a traced run (``run.trace``, a
``benchmark.trace.DeviceTrace``; ``run.spans`` the benchmark's spans)."""

from benchmark import work


def roofline(run, kernels, bound_of):
    """100 x the least time the chip could take for the matched kernels'
    work over their device time, or None when the slice holds none.
    ``kernels``: ``DeviceTrace.kernels`` rows (seconds, span, index);
    ``bound_of(span, index)``: a kernel's (flops, bytes)."""
    if run.trace is None or not kernels:
        return None
    t = sum(k[0] for k in kernels)
    floor = sum(work.bound_s(*bound_of(span, idx))
                for _s, span, idx in kernels)
    return 100.0 * floor / t


def k1_roofline(run, pattern, span_names):
    """The flows' kernel: each launch is one flow over the span's batch
    (the first launch of a span is the gated last flow)."""
    mc, n_flows = run.config["model_config"], run.config["model_config"][
        "n_flows"]

    def bound_of(span, idx):
        a = span[3]
        gated = idx % n_flows == 0 and mc.get("use_gate_layer", True)
        return work.k1_work(mc, run.dtype, a["B"], run.n_frames, a["Tk"],
                            a["in_lens"], gated)

    return roofline(run, run.trace.kernels(pattern, span_names), bound_of)


def k2_roofline(run, pattern, span_names):
    """The WaveNet layer kernel: the span's k-th launch is layer k mod
    n_layers of a pass over the span's rows at frames x 256 / n_group
    squeezed steps."""
    wc = run.config["waveglow_config"]

    def bound_of(span, idx):
        a = span[3]
        T = a["frames"] * 256 // wc["n_group"]
        return work.k2_work(wc, run.dtype, a["B"], T, idx % wc["n_layers"])

    return roofline(run, run.trace.kernels(pattern, span_names), bound_of)


def mfu(run):
    """100 x the model FLOPs of the answers completed in the window (the
    encoder and flows over each answer's frames, WaveGlow over its
    samples) a second, over the chip's peak. The traced slice and its
    processing are left out, answers and seconds: the capture slows the
    server there."""
    from benchmark.endtoend import answered_in

    (t0, t1), (s0, s1) = run.window, run.slice or (run.window[1],) * 2
    done = [r for r in answered_in(run, t0, t1) if not s0 <= r["done"] <= s1]
    if not done:
        return None
    mc, wc = run.config["model_config"], run.config["waveglow_config"]
    flops = sum(work.request_flops(mc, wc, run.n_keys[r["i"]],
                                   r["samples"] // 256) for r in done)
    seconds = (t1 - t0) - (min(s1, t1) - max(s0, t0))
    return 100.0 * flops / seconds / work.PEAK_FLOPS


def device_idle(run):
    """100 x the share of the traced slice in which no operation ran on
    the device."""
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())


def batch_fill(run):
    """100 x the requests a batch carried over the window, over
    --max-batch (the engine's /metrics counters, differenced)."""
    a, b = run.server_metrics
    batches = b["batches"] - a["batches"]
    if batches <= 0:
        return None
    return 100.0 * (b["requests"] - a["requests"]) / batches / run.max_batch
