"""The yardstick: traffic from the seed, the window's rate, the trace's
busy time and its attribution to spans, and the work counted from
shapes."""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import endtoend, work
from benchmark.run import load_cell, request_bodies
from benchmark.trace import DeviceTrace
from benchmark.traffic import kind


def test_closed_schedule_and_texts_follow_the_seed():
    _b, _e, cell, _c = load_cell("libritts-bf16.closed16")
    s1 = kind("closed").schedule(cell["traffic"], 5, 45)
    assert s1 == kind("closed").schedule(cell["traffic"], 6, 45)
    a = request_bodies(cell, "libritts-bf16.closed16", 5, 50)
    assert a == request_bodies(cell, "libritts-bf16.closed16", 5, 50)
    b = request_bodies(cell, "libritts-bf16.closed16", 6, 50)
    assert a != b
    assert len({x["seed"] for x in a}) == 50
    big = 2 ** 31 + 12345
    assert request_bodies(cell, "x", big, 3) == request_bodies(cell, "x", big,
                                                               3)


def test_rate_counts_each_answer_in_the_window_and_no_failure():
    run = SimpleNamespace(samples=4, window=(10.0, 20.0), records=[
        {"status": 200, "samples": 4, "done": 10.0 + k} for k in range(12)]
        + [{"status": 500, "samples": 0, "done": 12.0},
           {"status": 200, "samples": 3, "done": 13.0}])
    # answers done at 10 ... 20 count; 21 does not, nor a failure or a
    # short answer
    assert endtoend.requests_per_s(run) == pytest.approx(11 / 10.0)


def test_mfu_leaves_out_the_traced_slice():
    from benchmark.metrics._layers import mfu

    _b, _e, _cell, config = load_cell("ljs-fp32.closed16")
    mc, wc = config["model_config"], config["waveglow_config"]
    # one answer a second over a 10 s window; the slice [2, 5) and its
    # processing hold none
    done = [0.5, 1.5, 5.5, 6.5, 7.5, 8.5, 9.5]
    run = SimpleNamespace(
        samples=400 * 256, window=(0.0, 10.0), slice=(2.0, 5.0),
        config=config, n_keys={i: 60 for i in range(len(done))},
        records=[{"i": i, "status": 200, "samples": 400 * 256, "done": t}
                 for i, t in enumerate(done)])
    each = work.request_flops(mc, wc, 60, 400)
    assert mfu(run) == pytest.approx(100 * 7 * each / 7.0 / work.PEAK_FLOPS)
    run.slice = None
    assert mfu(run) == pytest.approx(100 * 7 * each / 10.0
                                     / work.PEAK_FLOPS)


def test_the_peak_gap_holds_the_gain_the_pcm_leaves_out():
    from benchmark.check import compare

    rng = np.random.default_rng(0)
    want = (rng.uniform(-1, 1, 512) * 32767).astype(np.int16)
    want[7] = 32767
    mel = torch.ones(80, 2)
    same, _ = compare([want.copy()], [(mel, want)], [mel])
    assert same["pcm_rel_rms"] == 0 and same["pcm_peak_gap"] == 0
    quieter = (want.astype(np.float64) * 0.9).astype(np.int16)
    got, _ = compare([quieter], [(mel, want)], [mel])
    assert got["pcm_rel_rms"] < 1e-4
    assert got["pcm_peak_gap"] == pytest.approx(0.1, abs=1e-4)
    assert got["length_mismatch"] == 0 and got["mel_rel_rms"] == 0


def test_a_step_flipped_reads_alike_in_steps_on_any_loudness():
    from benchmark.check import compare

    mel = torch.ones(80, 2)
    rel = []
    for scale in (30000, 30):
        want = (np.sin(np.arange(4096) / 7.0) * scale).astype(np.int16)
        want[0] = 32767
        got = want.copy()
        got[1::64] += 1                   # one sample in 64 a step off
        r, _ = compare([got], [(mel, want)], [mel])
        assert r["pcm_rms_lsb"] == pytest.approx(1 / 8, rel=0.05)
        rel.append(r["pcm_rel_rms"])
    # the same steps, over a quiet answer's rms, read 20 times higher
    assert rel[1] > 20 * rel[0]


class Event:
    def __init__(self, name, start, dur, corr, device):
        self._n, self._s, self._d, self._c = name, start, dur, corr
        self._dev = device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"


def synthetic_trace():
    """Slice [0, 1000): kernels [100, 300), [250, 400), [600, 700) (the
    last cut by nothing), launched at 50, 60, 550; a span 'vocode'
    [40, 80) and 'synth_mel' [500, 560)."""
    events = [Event("void (anonymous namespace)::wn16_kernel<K>(M)", 100,
                    200, 1, True),
              Event("void wn16_kernel<K>(M)", 250, 150, 2, True),
              Event("k1_bf16_kernel(P)", 600, 100, 3, True),
              Event("cudaLaunchKernel", 50, 5, 1, False),
              Event("cudaLaunchKernelExC", 60, 5, 2, False),
              Event("cudaLaunchCooperativeKernel", 550, 5, 3, False)]
    spans = [("vocode", 40, 80, {"B": 2, "frames": 4}),
             ("synth_mel", 500, 560, {"B": 1, "Tk": 8, "in_lens": [5]})]
    return DeviceTrace(events, 0, 1000, spans)


def test_idle_share_and_gaps_on_a_synthetic_trace():
    tr = synthetic_trace()
    assert tr.busy_s() == pytest.approx(400e-9)     # [100, 400) + [600, 700)
    assert tr.window_s() == pytest.approx(1000e-9)
    assert tr.top_ops()[0] == ["wn16_kernel<K>", pytest.approx(350e-9)]
    gaps = dict((k, v) for k, v in tr.idle_gaps())
    # [0, 100) opens inside 'vocode' at 50; [400, 600) at 500 inside
    # 'synth_mel'; [700, 1000) outside every span
    assert gaps == {"vocode": pytest.approx(100e-9),
                    "synth_mel": pytest.approx(200e-9),
                    "no model span": pytest.approx(300e-9)}


def test_kernels_are_tied_to_the_span_that_launched_them():
    tr = synthetic_trace()
    k2 = tr.kernels(re.compile(r"\bwn16_kernel\b"), ("vocode",))
    assert [(round(t * 1e9), s[0], i) for t, s, i in k2] == [
        (200, "vocode", 0), (150, "vocode", 1)]
    k1 = tr.kernels(re.compile(r"\bk1_(bf16_)?kernel\b"), ("synth_mel",))
    assert [(round(t * 1e9), i) for t, _s, i in k1] == [(100, 0)]


def test_work_counts_match_hand_worked_shapes():
    mc = {"n_hidden": 4, "n_attn_channels": 2, "n_mel_channels": 3,
          "n_lstm_layers": 2, "n_text_dim": 4, "n_speaker_dim": 2,
          "n_flows": 2}
    # attention LSTM 16x3 + 16x4, query 2x4, head 6x4, dense 2 x 4x4,
    # LSTM 16x6 + 16x4 and 16x4 + 16x4; the gate 6
    assert work.flow_weights(mc, False) == 48 + 64 + 8 + 24 + 32 + 160 + 128
    assert work.flow_weights(mc, True) == 464 + 6
    flops, n_bytes = work.k1_work(mc, "bfloat16", B=2, N=5, Tk=3,
                                  in_lens=[3, 1], gated=False)
    assert flops == 5 * ((2 * 464 + 6 * 3 * 2) + (2 * 464 + 6 * 1 * 2))
    assert n_bytes == 2 * (464 + 5 * 2 * 3 + 2 * 2 * 3 * 2) + 4 * 2 * 3 \
        + 4 * (5 * 2 * 3 + 5 * 2 * 3 + 5 * 2)
    wc = {"n_channels": 4, "n_layers": 2}
    # the dilated conv (3 taps, 4 -> 8) and res/skip (4 -> 8, last 4 -> 4)
    assert work.k2_work(wc, "float32", 1, 10, 0) == (
        2 * 10 * (96 + 32), 4 * (40 + 80 + 96 + 8 + 32 + 8 + 80))
    assert work.k2_work(wc, "float32", 1, 10, 1) == (
        2 * 10 * (96 + 16), 4 * (40 + 80 + 96 + 8 + 16 + 4 + 40))


def test_a_flagship_request_is_about_two_teraflops():
    _b, _e, _cell, config = load_cell("ljs-fp32.closed16")
    f = work.request_flops(config["model_config"], config["waveglow_config"],
                           60, 400)
    wg = work.waveglow_flops(config["waveglow_config"], 400)
    assert 2.0e12 < wg < 2.2e12 and 0.0 < f - wg < 0.1e12


def test_roofline_is_the_bound_over_the_kernel_time():
    from benchmark.metrics._layers import k2_roofline

    _b, _e, _cell, config = load_cell("libritts-bf16.closed16")
    tr = synthetic_trace()
    run = SimpleNamespace(trace=tr, config=config, dtype="bfloat16")
    wc = config["waveglow_config"]
    T = 4 * 256 // wc["n_group"]
    want = sum(work.bound_s(*work.k2_work(wc, "bfloat16", 2, T, k))
               for k in (0, 1)) / 350e-9
    got = k2_roofline(run, re.compile(r"\bwn16_kernel\b"), ("vocode",))
    assert got == pytest.approx(100 * want)
