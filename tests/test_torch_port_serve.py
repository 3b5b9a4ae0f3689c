"""The port's serving engine and HTTP front end on the CPU (mirrors
tests/test_serve.py): micro-batching, per-request controls and
independence from the batch, error paths, the endpoints, the refusals of
what is not ported, a w8a8 engine through K4's plain version, an engine
without a vocoder (Griffin-Lim on the host), the denoiser with
per-request strengths, streams over ``POST /stream`` and ``GET
/stream-ws``, streams through the multistream mux (``stream_mux``),
staged vocoding (``vocode_buckets``), and the server CLI's
``build_server``. Toy flows at n_mel 80 with the published WaveGlow
layout on random weights, 6 frames per request."""

import base64
import json
import os
import queue
import socket
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.io import wavfile  # noqa: E402

from flowtron_tpu_torch.config import load_config  # noqa: E402
from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.serve import (  # noqa: E402
    EngineOverloaded, SynthesisEngine, TextTooLong, build_server,
    make_handler, split_measured,
)
from flowtron_tpu_torch.serve import cli as serve_cli  # noqa: E402
from flowtron_tpu_torch.utils import weights as port_weights  # noqa: E402
from flowtron_tpu_torch.utils.device import resolve_device  # noqa: E402
from flowtron_tpu_torch.vocoder.waveglow import waveglow_init  # noqa: E402

# n_hidden 128: the LSTM matrices reach the quantizer's 65536 elements
DIMS = dict(n_speakers=1, n_speaker_dim=4, n_text=185, n_text_dim=16,
            n_mel_channels=80, n_hidden=128, n_attn_channels=32,
            n_lstm_layers=2, mel_encoder_n_hidden=8)
N_FRAMES = 6
ENGINE = dict(max_batch=4, batch_timeout_ms=200, text_buckets=(16, 32),
              n_frames=N_FRAMES, device="cpu")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    rng = np.random.default_rng(0)
    wavfile.write(root / "u.wav", 22050,
                  (rng.standard_normal(4096) * 2000).astype(np.int16))
    (root / "fl.txt").write_text(f"{root}/u.wav|hello|0\n")
    model, _ = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for flow in model.flows:
            step = getattr(flow, "ar_step", flow)
            step.conv.weight.copy_(0.05 * torch.randn(
                step.conv.weight.shape, generator=g))
        # requests run to their n_frames caps, as a trained model would
        model.flows[-1].ar_step.gate_layer.linear_layer.bias.fill_(-20.0)
    torch.save(model.state_dict(), root / "ft.pt")
    wg, _ = waveglow_init(seed=1)
    with torch.no_grad():
        for wn in wg.WN:
            wn.end.weight.copy_(0.05 * torch.randn(wn.end.weight.shape,
                                                   generator=g))
    torch.save(wg.state_dict(), root / "wg.pt")
    overrides = [f"data_config.training_files={root}/fl.txt",
                 f"data_config.validation_files={root}/fl.txt",
                 "data_config.p_arpabet=0.0", "data_config.cmudict_path=",
                 "data_config.heteronyms_path="]
    overrides += [f"model_config.{k}={v}" for k, v in DIMS.items()]
    overrides += ["model_config.n_flows=2"]
    (root / "config.json").write_text(json.dumps(load_config(
        overrides=overrides)))
    return root


@pytest.fixture(scope="module")
def config(files):
    return load_config(str(files / "config.json"))


@pytest.fixture(scope="module")
def engine(files, config):
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          **ENGINE)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def dengine(files, config):
    """An engine started with -d 0.1 (the WaveGlow's end convs are
    perturbed, so its bias spectrum is not zero)."""
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          denoise=0.1, **ENGINE)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def glengine(files, config):
    """An engine without a vocoder: Griffin-Lim on the host."""
    eng = SynthesisEngine(config, str(files / "ft.pt"), **ENGINE)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def qengine(files, config):
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          quantize="w8a8", **ENGINE)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def mengine(files, config):
    """Streams through a 3-slot multiplexer instead of the pool."""
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          stream_mux=3, **ENGINE)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def sengine(files, config):
    """-d 0.1 with staged vocoding at a 3-frame bucket."""
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          denoise=0.1, vocode_buckets=(3,), **ENGINE)
    yield eng
    eng.shutdown()


def _pcm(gen):
    return np.concatenate(list(gen))


def _held_stepper(eng):
    """Hold ``eng``'s mux stepper before its next tick; returns the event
    that releases it."""
    release = threading.Event()
    step = eng._mux.step

    def held():
        release.wait(timeout=300)
        return step()
    eng._mux.step = held
    return release


def _concurrent(eng, kwargs_list):
    """Submit every request from its own thread at once; returns the
    wavs in order and the (requests, batches) the engine counted."""
    before = eng.metrics()
    out = [None] * len(kwargs_list)

    def run(i):
        out[i] = eng.submit(**kwargs_list[i])[0]

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(kwargs_list))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    after = eng.metrics()
    return out, (after["requests"] - before["requests"],
                 after["batches"] - before["batches"])


class TestEngine:
    def test_single_request(self, engine):
        wav, sr = engine.submit("Hello there.", 0)
        assert sr == 22050 and wav.dtype == np.int16
        assert len(wav) == N_FRAMES * 256        # the gate is biased off
        assert np.abs(wav).max() == 32767        # peak-normalised

    def test_concurrent_requests_batched(self, engine):
        reqs = [dict(text=f"Request number {i}.", seed=i) for i in range(4)]
        wavs, (n_req, n_batches) = _concurrent(engine, reqs)
        assert n_req == 4 and n_batches < n_req
        assert not np.array_equal(wavs[0], wavs[1])   # seeds differ

    def test_audio_independent_of_batch(self, engine):
        """A request's audio does not depend on the batch it lands in:
        batched with others (batch and text buckets differ) and alone,
        within one int16 step."""
        reqs = [dict(text="Short.", seed=5),
                dict(text="A somewhat longer request here.", seed=6),
                dict(text="Third one.", seed=7)]
        batched, (_, n_batches) = _concurrent(engine, reqs)
        assert n_batches < 3
        for kw, wav in zip(reqs, batched):
            alone, _ = engine.submit(**kw)
            assert len(alone) == len(wav)
            assert np.abs(alone.astype(np.int32) - wav).max() <= 1, kw

    def test_mixed_temperature_batch(self, engine):
        """Mixed temperatures batch together as a (B, 1) vector (the
        per-frame loop); each request equals itself served alone."""
        reqs = [dict(text="Temperature test.", seed=3, temperature=t)
                for t in (0.5, 1.0, 2.0)]
        batched, (_, n_batches) = _concurrent(engine, reqs)
        assert n_batches < 3
        assert not np.array_equal(batched[0], batched[2])
        for kw, wav in zip(reqs, batched):
            alone, _ = engine.submit(**kw)
            assert np.abs(alone.astype(np.int32) - wav).max() <= 1, kw

    def test_per_request_n_frames_caps_output(self, engine):
        wav, _ = engine.submit("Hello there.", 0, n_frames=3)
        assert len(wav) == 3 * 256
        assert np.abs(wav).max() == 32767    # normalised over the kept part
        wav, _ = engine.submit("Hello there.", 0, n_frames=10 * N_FRAMES)
        assert len(wav) == N_FRAMES * 256

    def test_empty_text_errors(self, engine):
        with pytest.raises(ValueError, match="empty text"):
            engine.submit("~~~", 0)

    def test_long_text_rejected_not_truncated(self, engine):
        with pytest.raises(TextTooLong, match="largest bucket"):
            engine.submit("word " * 50, 0)
        assert engine.metrics()["rejected_too_long"] >= 1

    def test_long_text_split_synthesizes_all(self, engine):
        wav, _ = engine.submit("One two three. " * 8, 0, split=True)
        assert len(wav) >= 4 * N_FRAMES * 256

    def test_completion_failure_fails_only_that_batch(self, engine):
        orig = engine._complete_batch
        calls = {"n": 0}

        def boom(batch, handles):
            if calls["n"] == 0:
                calls["n"] += 1
                raise RuntimeError("completion exploded")
            return orig(batch, handles)

        engine._complete_batch = boom
        try:
            with pytest.raises(RuntimeError, match="completion exploded"):
                engine.submit("Hello.", 0)
        finally:
            engine._complete_batch = orig
        wav, _ = engine.submit("Hello again.", 0)
        assert len(wav) > 0

    def test_overload_raises_429(self, engine):
        old = engine._queue
        try:
            full = queue.Queue(maxsize=1)
            full.put_nowait(None)        # never consumed: the worker reads old
            engine._queue = full
            with pytest.raises(EngineOverloaded, match="queue full"):
                engine.submit("Hello.", 0)
        finally:
            engine._queue = old
        assert engine.metrics()["rejected_overload"] >= 1

    def test_per_request_denoise_needs_engine_denoiser(self, engine):
        """An engine started without -d has no bias spectrum: a request's
        ``denoise`` is refused, on both paths, before any work."""
        for call in (engine.submit, engine.stream):
            with pytest.raises(ValueError, match="started with -d"):
                call("Hello.", 0, denoise=0.1)

    def test_per_request_denoise_changes_audio_keeps_length(self, dengine):
        """Strengths 0 and 2 differ from the engine's 0.1 and each other,
        at the same length; batched together each equals itself alone."""
        alone = {d: dengine.submit("Denoise me.", 0, seed=4,
                                   denoise=d)[0] for d in (None, 0.0, 2.0)}
        assert len({len(w) for w in alone.values()}) == 1
        assert len(alone[None]) == N_FRAMES * 256
        assert not np.array_equal(alone[0.0], alone[2.0])
        assert not np.array_equal(alone[None], alone[2.0])
        reqs = [dict(text="Denoise me.", seed=4, denoise=d)
                for d in (None, 0.0, 2.0)]
        batched, (_, n_batches) = _concurrent(dengine, reqs)
        assert n_batches < 3
        for kw, wav in zip(reqs, batched):
            assert np.abs(alone[kw["denoise"]].astype(np.int32)
                          - wav).max() <= 1, kw

    def test_engine_without_vocoder_runs_griffin_lim(self, glengine,
                                                     config):
        """No -w: the flows run on the device, each request's mel is
        vocoded by Griffin-Lim (20 iterations) on the host and
        peak-normalised; n frames give (n - 1) * 256 samples."""
        from flowtron_tpu_torch.infer.sampling import (
            mel_to_audio_griffinlim)
        seen = []
        vocode = glengine._vocode

        def spy(mel):
            seen.append(mel)
            return vocode(mel)
        glengine._vocode = spy
        try:
            wav, sr = glengine.submit("Hello there.", 0)
            capped, _ = glengine.submit("Hello there.", 0, n_frames=3)
        finally:
            glengine._vocode = vocode
        assert sr == 22050 and wav.dtype == np.int16
        assert len(wav) == (N_FRAMES - 1) * 256 and len(capped) == 2 * 256
        assert np.abs(wav).max() == 32767
        assert seen[0].shape == (80, N_FRAMES)
        ref = mel_to_audio_griffinlim(seen[0], config["data_config"],
                                      n_iters=20)
        np.testing.assert_array_equal(
            wav, (ref / np.abs(ref).max() * 32767).astype(np.int16))
        assert not glengine.can_stream
        with pytest.raises(RuntimeError, match="vocoder"):
            glengine.stream("Hello.", 0)

    def test_stream_concatenates_to_n_valid_frames(self, engine):
        """``stream`` yields int16 chunks that add up to n_valid * 256
        samples (the gate is biased off: N_FRAMES), the same for the same
        seed; per-stream generators: another seed differs."""
        a = np.concatenate(list(engine.stream("Stream this.", 0, seed=3)))
        b = np.concatenate(list(engine.stream("Stream this.", 0, seed=3)))
        c = np.concatenate(list(engine.stream("Stream this.", 0, seed=4)))
        assert a.dtype == np.int16 and len(a) == N_FRAMES * 256
        assert np.array_equal(a, b) and not np.array_equal(a, c)
        capped = np.concatenate(list(engine.stream("Stream this.", 0,
                                                   n_frames=2)))
        assert len(capped) == 2 * 256
        assert engine.metrics()["stream_requests"] >= 4

    def test_stream_with_denoise_and_split(self, dengine):
        """-d streams through a StreamingDenoiser (same length, other
        samples); split=True streams every segment back to back."""
        raw = np.concatenate(list(dengine.stream("Stream me.", 0, seed=2,
                                                 denoise=0.0)))
        den = np.concatenate(list(dengine.stream("Stream me.", 0, seed=2)))
        assert len(raw) == len(den) == N_FRAMES * 256
        assert not np.array_equal(raw, den)
        long = np.concatenate(list(dengine.stream("One two three. " * 8, 0,
                                                  split=True)))
        assert len(long) >= 4 * N_FRAMES * 256

    def test_stream_pool_overload_raises_429(self, engine):
        pool = engine._stream_pool
        held = [pool.get(timeout=60) for _ in range(engine._stream_workers)]
        old = engine.stream_acquire_timeout
        engine.stream_acquire_timeout = 0.05
        try:
            with pytest.raises(EngineOverloaded, match="streaming workers"):
                engine.stream("Hello.", 0)
        finally:
            engine.stream_acquire_timeout = old
            for pair in held:
                pool.put(pair)

    def test_warmup_runs_every_bucket_pair(self, engine):
        out = engine.warmup()
        assert out["batches"] == len(engine.batch_buckets()) * 2
        assert engine.batch_buckets() == [1, 2, 4]

    def test_w8a8_engine_runs_k4_plain(self, qengine, monkeypatch):
        calls = []
        k4 = port_weights.quantized_matmul

        def spy(*a, **k):
            calls.append(k.get("a8"))
            return k4(*a, **k)
        monkeypatch.setattr(port_weights, "quantized_matmul", spy)
        wav, _ = qengine.submit("Quantized hello.", 0)
        assert len(wav) == N_FRAMES * 256 and np.abs(wav).max() == 32767
        # per flow and frame, the five LSTM matrices that reach 65536
        # elements at these widths (all but the attention LSTM's w_ih)
        assert len(calls) == 2 * 5 * N_FRAMES and all(calls)


class TestMux:
    """``stream_mux``: every stream holds a slot of one multiplexer."""

    def test_muxed_stream_equals_pooled_stream(self, mengine, engine):
        """The same request through the mux and through the pool: the same
        seeds (segment 0: ``stream_generators(seed)``), one tick of 6
        frames, within one int16 step."""
        for kw in (dict(seed=11), dict(seed=12, temperature=0.6,
                                       n_frames=4)):
            a = _pcm(mengine.stream("Hello there mux.", 0, **kw))
            b = _pcm(engine.stream("Hello there mux.", 0, **kw))
            assert len(a) == len(b) == kw.get("n_frames", N_FRAMES) * 256
            assert np.abs(a.astype(np.int32) - b).max() <= 1, kw
        assert mengine.active_mux_streams == 0

    def test_concurrent_streams_complete(self, mengine):
        """Three streams at once share the ticks; each equals itself
        streamed alone."""
        texts = ["First mux stream.", "Second one here.", "Third."]
        out = [None] * 3

        def run(i):
            out[i] = _pcm(mengine.stream(texts[i], 0, seed=30 + i))
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        for i in range(3):
            alone = _pcm(mengine.stream(texts[i], 0, seed=30 + i))
            assert len(out[i]) == N_FRAMES * 256
            assert np.abs(alone.astype(np.int32) - out[i]).max() <= 1

    def test_metrics_show_the_mux(self, mengine):
        m = mengine.metrics()
        assert m["mux_slots"] == 3 and m["mux_active_streams"] == 0
        before = m["stream_requests"]
        _pcm(mengine.stream("Count me.", 0))
        assert mengine.metrics()["stream_requests"] == before + 1

    def test_warmup_runs_the_mux(self, mengine):
        out = mengine.warmup()
        assert out["mux_streams"] == 1 and out["batches"] == 6
        assert mengine.active_mux_streams == 0
        assert len(_pcm(mengine.stream("After warmup.", 0))) == \
            N_FRAMES * 256

    def test_abandoned_stream_frees_its_slot(self, files, config):
        """A consumer that leaves after its first chunk closes its slot;
        the mux then serves the next stream. Chunks of 2 frames, context
        and lookahead 2, so the stream is left mid-way."""
        eng = SynthesisEngine(config, str(files / "ft.pt"),
                              str(files / "wg.pt"), stream_mux=1, **ENGINE)
        eng._mux.C = eng._mux.context = eng._mux.lookahead = 2
        try:
            gen = eng.stream("Abandon me.", 0, seed=50)
            first = next(gen)
            assert 0 < len(first) < N_FRAMES * 256
            gen.close()
            for _ in range(600):
                if eng.active_mux_streams == 0:
                    break
                threading.Event().wait(0.05)
            assert eng.active_mux_streams == 0
            assert len(_pcm(eng.stream("Still here.", 0, seed=51))) == \
                N_FRAMES * 256
        finally:
            eng.shutdown()

    def test_one_slot_gives_429_and_shutdown_fails_waiters(self, files,
                                                           config):
        """stream_mux=1, the stepper held: a second stream is refused
        (EngineOverloaded, 429 over HTTP); shutdown hands the waiting
        consumer an error."""
        from http.server import ThreadingHTTPServer
        eng = SynthesisEngine(config, str(files / "ft.pt"),
                              str(files / "wg.pt"), stream_mux=1, **ENGINE)
        release = _held_stepper(eng)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(eng))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        got = {}

        def consume():
            try:
                got["pcm"] = _pcm(gen)
            except RuntimeError as e:
                got["error"] = str(e)
        try:
            gen = eng.stream("Hold the slot.", 0)
            with pytest.raises(EngineOverloaded, match="mux stream slots"):
                eng.stream("Second.", 0)
            code, err = TestHTTP()._status(
                f"http://127.0.0.1:{srv.server_address[1]}/stream",
                {"text": "Third."})
            assert code == 429 and "mux" in err["error"]
            assert eng.metrics()["rejected_overload"] == 2
            c = threading.Thread(target=consume)
            c.start()
            eng.shutdown(timeout=1)
            c.join(timeout=60)
            assert not c.is_alive()
            assert got == {"error": "engine shut down"}
        finally:
            release.set()
            srv.shutdown()
            srv.server_close()
            eng.shutdown()

    def test_denoise_and_split_through_the_mux(self, files, config,
                                               dengine):
        """-d: a muxed stream is denoised as the pooled one (within an
        int16 step); split=True streams every segment, each on its own
        slot and seed, as the pool does."""
        eng = SynthesisEngine(config, str(files / "ft.pt"),
                              str(files / "wg.pt"), stream_mux=2,
                              denoise=0.1, **ENGINE)
        try:
            for kw in (dict(seed=2), dict(seed=2, denoise=0.0)):
                a = _pcm(eng.stream("Stream me.", 0, **kw))
                b = _pcm(dengine.stream("Stream me.", 0, **kw))
                assert len(a) == len(b) == N_FRAMES * 256
                assert np.abs(a.astype(np.int32) - b).max() <= 1, kw
            text = "One two three. " * 8
            a = _pcm(eng.stream(text, 0, seed=4, split=True))
            b = _pcm(dengine.stream(text, 0, seed=4, split=True))
            assert len(a) == len(b) >= 4 * N_FRAMES * 256
            assert np.abs(a.astype(np.int32) - b).max() <= 1
        finally:
            eng.shutdown()

    def test_http_stream_and_ws_through_the_mux(self, mengine):
        from http.server import ThreadingHTTPServer
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(mengine))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            with TestHTTP._post(url + "/stream",
                                {"text": "Over HTTP.", "seed": 7}) as r:
                pcm = np.frombuffer(r.read()[44:], "<i2")
            ref = _pcm(mengine.stream("Over HTTP.", seed=7))
            np.testing.assert_array_equal(pcm, ref)
            _, _, _, frames = TestHTTP._ws_stream(
                url, {"text": "Over a socket.", "seed": 7})
            assert frames[-1] == (8, b"\x03\xe8")
            assert sum(len(p) for op, p in frames if op == 2) == \
                2 * N_FRAMES * 256
            assert TestHTTP._get(url + "/metrics")["mux_slots"] == 3
        finally:
            srv.shutdown()
            srv.server_close()


class TestStaged:
    """``vocode_buckets``: a batch whose n_frames caps fit a bucket below
    n_frames is vocoded at the smallest bucket that covers it."""

    def test_staged_at_full_bucket_equals_one_pass(self, sengine, dengine,
                                                   monkeypatch):
        """Staging forced for every batch: an uncapped request is vocoded
        at the full bucket, the one-pass chain's audio within an int16
        step."""
        assert sengine._vocode_buckets == (3, N_FRAMES)
        monkeypatch.setattr(sengine, "_staged", lambda caps: True)
        before = sengine.metrics()["vocode_bucket_hits"][str(N_FRAMES)]
        got, _ = sengine.submit("Hello staged.", 0, seed=21)
        want, _ = dengine.submit("Hello staged.", 0, seed=21)
        assert len(got) == len(want) == N_FRAMES * 256
        assert np.abs(got.astype(np.int32) - want).max() <= 1
        assert sengine.metrics()["vocode_bucket_hits"][str(N_FRAMES)] == \
            before + 1

    def test_capped_batch_is_staged_with_denoise(self, sengine):
        """Caps of 2 frames fit the 3-frame bucket: staged, a hit counted,
        -d applied at the request's own strength; an uncapped request
        stays on the one-pass chain."""
        m0 = sengine.metrics()
        wavs = {d: sengine.submit("Short one.", 0, seed=5, n_frames=2,
                                  denoise=d)[0] for d in (None, 0.0, 2.0)}
        assert all(len(w) == 2 * 256 for w in wavs.values())
        assert np.abs(wavs[None]).max() == 32767
        assert not np.array_equal(wavs[0.0], wavs[2.0])
        again, _ = sengine.submit("Short one.", 0, seed=5, n_frames=2)
        np.testing.assert_array_equal(again, wavs[None])
        m1 = sengine.metrics()
        assert m1["staged_batches"] - m0["staged_batches"] == 4
        assert m1["vocode_bucket_hits"]["3"] - \
            m0["vocode_bucket_hits"]["3"] == 4
        sengine.submit("Full length.", 0, seed=6)
        assert sengine.metrics()["staged_batches"] == m1["staged_batches"]

    def test_no_sub_bucket_warns_and_disables_staging(self, files, config):
        with pytest.warns(UserWarning, match="no bucket below n_frames"):
            eng = SynthesisEngine(config, str(files / "ft.pt"),
                                  str(files / "wg.pt"),
                                  vocode_buckets=(N_FRAMES, 9), **ENGINE)
        try:
            assert eng._vocode_buckets is None
            wav, _ = eng.submit("Still serves.", 0, n_frames=2)
            assert len(wav) == 2 * 256
            assert eng.metrics()["staged_batches"] == 0
        finally:
            eng.shutdown()

    def test_warmup_vocodes_each_sub_bucket(self, sengine):
        out = sengine.warmup()
        assert out["batches"] == 6 and out["staged_vocodes"] == 3


@pytest.mark.parametrize("option,groups", [
    (dict(mesh_shape=[1, 1]), 1),
    (dict(mesh_shape=[2, 1], replicas=2, devices=["cpu", "cpu"]), 2),
])
def test_unported_engine_options_raise(files, config, option, groups):
    """The serving mesh is ported (tests/test_torch_port_tp.py): each
    option builds its engine, one data group a row of the mesh, its flows
    kept off kernel K1, and serves a request."""
    kw = dict(ENGINE, waveglow_path=str(files / "wg.pt"), batch_timeout_ms=20)
    kw.update(option)
    eng = SynthesisEngine(config, str(files / "ft.pt"), **kw)
    try:
        assert len(eng._groups) == eng._batch_mult == groups
        assert all(f.on_mesh for g in eng._groups
                   for f in (g.model.flows[0],))
        wav, _ = eng.submit("Hello.", 0)
        assert len(wav) > 0
    finally:
        eng.shutdown()


@pytest.mark.parametrize("option,built", [
    (dict(vocode_buckets=[2]),
     lambda e: e._vocode_buckets == (2, N_FRAMES) and e.can_stream),
    (dict(stream_mux=2),
     lambda e: e._mux.slots == 2 and e._stream_pool is None
     and e._mux.max_joins_per_tick is None),
    (["--stream-mux", "2"], lambda e: e._mux.slots == 2),
    (["--stream-mux", "2", "--mux-joins-per-tick", "2"],
     lambda e: e._mux.max_joins_per_tick == 2),
    (["--vocode-buckets", "2,4"],
     lambda e: e._vocode_buckets == (2, 4, N_FRAMES) and e._mux is None),
    (["--stream-mux", "4"],
     lambda e: e._mux.slots == 4 and e._mux.Tk == 128 and e.can_stream),
    (dict(bf16=True), lambda e: _bf16_engine(e)),
    (["--bf16", "--quantize", "w8a8"],
     lambda e: _bf16_engine(e) and e.quantize == "w8a8"),
])
def test_ported_options_build_their_engine(files, config, monkeypatch,
                                           option, built):
    """The options that used to be refused (the engine's stream_mux,
    vocode_buckets and bf16, the server's --stream-mux,
    --mux-joins-per-tick, --vocode-buckets and --bf16) now build their
    engine."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    if isinstance(option, dict):
        engines = {"default": SynthesisEngine(
            config, str(files / "ft.pt"), str(files / "wg.pt"),
            **dict(ENGINE, **option))}
    else:
        server, engines = build_server(
            ["-c", str(files / "config.json"), "-f", str(files / "ft.pt"),
             "-w", str(files / "wg.pt"), "--port", "0", "--n-frames",
             str(N_FRAMES)] + option, host="127.0.0.1")
        server.server_close()
    try:
        assert built(engines["default"])
    finally:
        engines["default"].shutdown()


def _bf16_engine(e):
    """A bf16 engine: every float leaf of the flows and the vocoder bf16,
    every quantized leaf's scales fp32, and it serves a request."""
    floats = [t for m in (e.model, e.wg) for t in (*m.parameters(),
                                                   *m.buffers())
              if t.is_floating_point()]
    scales = [m.s for m in e.model.modules()
              if isinstance(m, port_weights.QuantizedWeight)]
    wav, _ = e.submit("Hello there.", 0)
    return (e.bf16 and len(wav) == N_FRAMES * 256
            and all(t.dtype == torch.float32 for t in scales)
            and all(t.dtype == torch.bfloat16 for t in floats
                    if not any(t is s for s in scales)))


def test_device_defaults_to_cuda_and_names_the_variable(monkeypatch):
    monkeypatch.delenv("FLOWTRON_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="FLOWTRON_PLATFORM=cpu"):
        resolve_device()
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    assert resolve_device() == torch.device("cpu")
    monkeypatch.setenv("FLOWTRON_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="FLOWTRON_PLATFORM"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_wav_bytes_match_scipy():
    """The response body is what the JAX server's scipy writer gives."""
    import io
    from scipy.io import wavfile as scipy_wavfile
    from flowtron_tpu_torch.serve.wire import _wav_bytes
    for n in (0, 1, 1000):
        pcm = (np.random.default_rng(n).standard_normal(n) * 3000) \
            .astype(np.int16)
        buf = io.BytesIO()
        scipy_wavfile.write(buf, 22050, pcm)
        assert _wav_bytes(pcm, 22050) == buf.getvalue()


def test_split_measured_packs_sentences():
    def measure(s):
        return list(s)

    segs = split_measured("Aa bb. Cc dd! Ee ff? Gg hh.", measure, 14)
    assert [s for s, _ in segs] == ["Aa bb. Cc dd!", "Ee ff? Gg hh."]
    segs = split_measured("aaaa bbbb cccc dddd", measure, 9)
    assert [s for s, _ in segs] == ["aaaa bbbb", "cccc dddd"]
    with pytest.raises(TextTooLong):
        split_measured("superlongword", measure, 5)


def test_split_measured_stochastic_measure_never_overflows():
    rng = np.random.default_rng(0)

    def measure(s):
        return list(s) + [0] * rng.integers(0, 4)

    text = ". ".join(["word one two", "three four five", "six seven",
                      "eight nine ten"] * 3) + "."
    for _ in range(10):
        for seg, ids in split_measured(text, measure, 20):
            assert len(ids) <= 20, (seg, len(ids))


class TestHTTP:
    @pytest.fixture(scope="class")
    def server(self, engine, qengine):
        from http.server import ThreadingHTTPServer
        srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(
            {"default": engine, "w8a8": qengine}))
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        yield f"http://127.0.0.1:{srv.server_address[1]}"
        srv.shutdown()
        srv.server_close()

    @staticmethod
    def _post(url, body, method="POST"):
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(), method=method,
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=300)

    @staticmethod
    def _get(url):
        with urllib.request.urlopen(url, timeout=60) as r:
            return json.loads(r.read())

    def _status(self, url, body, method="POST"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            self._post(url, body, method)
        return ei.value.code, json.loads(ei.value.read())

    def test_synthesize_wav(self, server):
        for model in ("default", "w8a8"):
            with self._post(server + "/synthesize",
                            {"text": "Hello HTTP.", "model": model}) as r:
                assert r.headers["Content-Type"] == "audio/wav"
                body = r.read()
            assert body[:4] == b"RIFF"
            sr = int.from_bytes(body[24:28], "little")
            assert sr == 22050

    def test_healthz_models_metrics(self, server):
        h = self._get(server + "/healthz")
        assert h["status"] == "ok" and set(h["models"]) == {"default",
                                                             "w8a8"}
        models = self._get(server + "/models")
        assert models["default"] == "default"
        assert [m["name"] for m in models["models"]] == ["default", "w8a8"]
        assert all(m["can_stream"] is True for m in models["models"])
        self._post(server + "/synthesize", {"text": "Count me."}).read()
        m = self._get(server + "/metrics")
        assert m["default"]["requests"] >= 1
        assert m["default"]["audio_seconds"] > 0
        assert "batch_ms_p50" in m["default"]
        idx = self._get(server + "/")
        assert idx["service"] == "flowtron_tpu_torch"
        assert "POST /synthesize" in idx["endpoints"]

    def test_unknown_model_and_path_are_404(self, server):
        code, err = self._status(server + "/synthesize",
                                 {"text": "Hi.", "model": "nope"})
        assert code == 404 and "unknown model" in err["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(server + "/nowhere", timeout=60)
        assert ei.value.code == 404

    def test_missing_field_is_400(self, server):
        assert self._status(server + "/synthesize",
                            {"speaker_id": 0})[0] == 400

    def test_http_413_on_long_text_and_split(self, server):
        code, err = self._status(server + "/synthesize",
                                 {"text": "word " * 60})
        assert code == 413 and "largest bucket" in err["error"]
        with self._post(server + "/synthesize",
                        {"text": "One two three. " * 8, "split": True}) as r:
            assert r.read()[:4] == b"RIFF"

    def test_http_413_on_oversized_body(self, server):
        host, port = server.replace("http://", "").split(":")
        with socket.create_connection((host, int(port)), timeout=60) as s:
            s.sendall((f"POST /synthesize HTTP/1.1\r\nHost: {host}\r\n"
                       "Content-Type: application/json\r\n"
                       "Content-Length: 5000000000\r\n"
                       "Connection: close\r\n\r\n").encode())
            s.settimeout(60)
            status = s.makefile("rb").readline()
        assert b"413" in status, status

    def test_http_429_on_overload(self, server, engine):
        old = engine._queue
        try:
            full = queue.Queue(maxsize=1)
            full.put_nowait(None)
            engine._queue = full
            code, err = self._status(server + "/synthesize", {"text": "Hi."})
        finally:
            engine._queue = old
        assert code == 429 and "queue full" in err["error"]

    def test_stream_is_a_chunked_wav(self, server, engine):
        """POST /stream: a WAV header with unknown sizes, then PCM16 that
        equals the engine's own stream of the same request."""
        body = {"text": "Stream over HTTP.", "seed": 7}
        with self._post(server + "/stream", body) as r:
            assert r.headers["Transfer-Encoding"] == "chunked"
            assert r.headers["Content-Type"] == "audio/wav"
            data = r.read()
        assert data[:4] == b"RIFF" and data[8:16] == b"WAVEfmt "
        assert struct.unpack("<I", data[4:8])[0] == 0xFFFFFFFF
        assert struct.unpack("<I", data[24:28])[0] == 22050
        assert data[36:40] == b"data"
        pcm = np.frombuffer(data[44:], "<i2")
        assert len(pcm) == N_FRAMES * 256
        ref = np.concatenate(list(engine.stream(body["text"], seed=7)))
        np.testing.assert_array_equal(pcm, ref)

    def test_stream_errors_before_the_response(self, server):
        assert self._status(server + "/stream", {"sigma": 0.5})[0] == 400
        code, err = self._status(server + "/stream",
                                 {"text": "Hi.", "denoise": 0.2})
        assert code == 400 and "started with -d" in err["error"]
        assert self._status(server + "/stream",
                            {"text": "word " * 60})[0] == 413
        assert self._status(server + "/stream",
                            {"text": "Hi.", "model": "nope"})[0] == 404

    @staticmethod
    def _ws_stream(url, req):
        """GET /stream-ws: handshake, one masked text frame with ``req``;
        returns the accept key's check and the frames (opcode, payload)
        up to the close."""
        host, port = url.replace("http://", "").split(":")
        key = base64.b64encode(os.urandom(16)).decode()
        with socket.create_connection((host, int(port)), timeout=300) as s:
            s.sendall((f"GET /stream-ws HTTP/1.1\r\nHost: {host}\r\n"
                       "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                       f"Sec-WebSocket-Key: {key}\r\n"
                       "Sec-WebSocket-Version: 13\r\n\r\n").encode())
            f = s.makefile("rb")
            status = f.readline()
            headers = {}
            while (line := f.readline().strip()):
                k, _, v = line.decode().partition(":")
                headers[k.lower()] = v.strip()
            payload, mask = json.dumps(req).encode(), os.urandom(4)
            s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + bytes(
                b ^ mask[i % 4] for i, b in enumerate(payload)))
            frames = []
            while True:
                h = f.read(2)
                n = h[1] & 0x7F
                if n == 126:
                    n = struct.unpack(">H", f.read(2))[0]
                elif n == 127:
                    n = struct.unpack(">Q", f.read(8))[0]
                frames.append((h[0] & 0x0F, f.read(n)))
                if frames[-1][0] == 8:
                    return status, headers, key, frames

    def test_stream_ws(self, server):
        from flowtron_tpu_torch.serve.wire import _ws_accept_key
        status, headers, key, frames = self._ws_stream(
            server, {"text": "Stream over a socket.", "seed": 7})
        assert b"101" in status
        assert headers["sec-websocket-accept"] == _ws_accept_key(key)
        assert frames[0][0] == 1 and json.loads(frames[0][1]) == {
            "sample_rate": 22050, "format": "pcm16"}
        assert frames[-1] == (8, b"\x03\xe8")
        pcm = b"".join(p for op, p in frames[1:-1] if op == 2)
        assert len(pcm) == 2 * N_FRAMES * 256
        _, _, _, frames = self._ws_stream(server, {"sigma": 0.5})
        assert "missing field" in json.loads(frames[0][1])["error"]


@pytest.mark.parametrize("flag", [
    ["--mesh", "1,1"], ["--mesh", "2,1", "--replicas", "2"]])
def test_unported_server_flags_exit_naming_roadmap(flag, files, capsys,
                                                   monkeypatch):
    """Every flag of the JAX server is ported: ``--mesh 1,1`` builds its
    one data group; ``--mesh 2,1`` with ``--replicas 2`` prints JAX's
    warning and, with one visible device, stops at the mesh's device
    count, as JAX's reshape of its devices does."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    argv = ["-c", str(files / "config.json"), "-f", str(files / "ft.pt"),
            "-w", str(files / "wg.pt"), "--port", "0", "--n-frames",
            str(N_FRAMES)] + flag
    if flag[1] == "1,1":
        server, engines = build_server(argv, host="127.0.0.1")
        try:
            assert len(engines["default"]._groups) == 1
        finally:
            server.server_close()
            for eng in engines.values():
                eng.shutdown()
    else:
        with pytest.raises(ValueError, match="needs 2 devices; 1 given"):
            build_server(argv, host="127.0.0.1")
        assert "WARNING: --replicas is incompatible with --mesh" in \
            capsys.readouterr().out
    assert not serve_cli.UNPORTED_FLAGS


def test_build_server_denoise_and_stream_workers(files, monkeypatch):
    """``build_server`` with -d and --stream-workers: the engine's bias
    spectrum and pool, one stream over HTTP, and a voice without a vocoder
    (--model NAME=CONFIG:CKPT) that -d leaves alone and that cannot
    stream."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    cfg, ft, wg = (str(files / n) for n in ("config.json", "ft.pt",
                                            "wg.pt"))
    server, engines = build_server(
        ["-c", cfg, "-f", ft, "-w", wg, "--port", "0", "--n-frames", "4",
         "-d", "0.1", "--stream-workers", "1", "--model",
         f"gl={cfg}:{ft}"], host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        eng = engines["default"]
        assert eng._denoiser is not None and eng._stream_workers == 1
        assert engines["gl"]._denoiser is None
        assert not engines["gl"].can_stream
        url = f"http://127.0.0.1:{server.server_address[1]}"
        req = urllib.request.Request(url + "/stream", data=json.dumps(
            {"text": "Hi there."}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            assert len(r.read()) == 44 + 2 * 4 * 256
        req = urllib.request.Request(url + "/stream", data=json.dumps(
            {"text": "Hi there.", "model": "gl"}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=300)
        assert ei.value.code == 501
        req = urllib.request.Request(url + "/synthesize", data=json.dumps(
            {"text": "Hi there.", "model": "gl"}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            assert len(r.read()) == 44 + 2 * 3 * 256
    finally:
        server.shutdown()
        server.server_close()
        for e in engines.values():
            e.shutdown()


def test_build_server_serves_a_quantized_voice(files, monkeypatch):
    """``build_server`` end to end: two voices (the second w4 through
    --model ... and --quantize applies to both), --warmup, a request."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    cfg, ft, wg = (str(files / n) for n in ("config.json", "ft.pt",
                                            "wg.pt"))
    server, engines = build_server(
        ["-c", cfg, "-f", ft, "-w", wg, "--port", "0", "--max-batch", "1",
         "--n-frames", "4", "--quantize", "w4", "--warmup",
         "--model", f"other={cfg}:{ft}:{wg}"], host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        assert set(engines) == {"default", "other"}
        assert all(e.quantize == "w4" for e in engines.values())
        url = f"http://127.0.0.1:{server.server_address[1]}/synthesize"
        req = urllib.request.Request(
            url, data=json.dumps({"text": "Hi there.",
                                  "model": "other"}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
        assert body[:4] == b"RIFF" and len(body) == 44 + 2 * 4 * 256
    finally:
        server.shutdown()
        server.server_close()
        for eng in engines.values():
            eng.shutdown()
    # no refusal left
    assert set(serve_cli.UNPORTED_FLAGS) == set()


def test_shutdown_refuses_new_work(files, config):
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          **ENGINE)
    eng.shutdown()
    eng.shutdown()                            # safe twice
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit("Hello.", 0)
    assert eng.model is None and eng.wg is None
