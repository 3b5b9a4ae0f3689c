"""The port's serving engine and HTTP front end on the CPU (mirrors
tests/test_serve.py): micro-batching, per-request controls and
independence from the batch, error paths, the endpoints, the refusals of
what is not ported, a w8a8 engine through K4's plain version, an engine
without a vocoder (Griffin-Lim on the host), the denoiser with
per-request strengths, streams over ``POST /stream`` and ``GET
/stream-ws``, and the server CLI's ``build_server``. Toy flows at n_mel 80
with the published WaveGlow layout on random weights, 6 frames per
request."""

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


@pytest.mark.parametrize("option,item", [
    (dict(bf16=True), "deferred item 3"),
    (dict(mesh_shape=[1, 1]), "item 23"),
    (dict(replicas=2), "item 23"),
    (dict(vocode_buckets=[2]), "item 22"),
    (dict(stream_mux=2), r"Queue 1 \(e\), slice C item 18"),
])
def test_unported_engine_options_raise(files, config, option, item):
    kw = dict(waveglow_path=str(files / "wg.pt"), device="cpu")
    kw.update(option)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md.*{item}"):
        SynthesisEngine(config, str(files / "ft.pt"), **kw)


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

    @pytest.mark.parametrize("method,path,item", [
        ("POST", "/profile", "item 25"), ("POST", "/models", "item 24"),
        ("DELETE", "/models/default", "item 24")])
    def test_unported_endpoints_are_501(self, server, method, path, item):
        if method == "GET":
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(server + path, timeout=60)
            code, err = ei.value.code, json.loads(ei.value.read())
        else:
            code, err = self._status(server + path, {"text": "Hi."}, method)
        assert code == 501 and f"ROADMAP.md Queue 1, slice C {item}" in \
            err["error"]


@pytest.mark.parametrize("flag", [
    ["--mesh", "1,1"], ["--replicas", "2"], ["--stream-mux", "2"],
    ["--bf16"], ["--mux-joins-per-tick", "2"], ["--vocode-buckets", "100"],
    ["--compile-cache", "x"], ["--profiler-port", "9999"]])
def test_unported_server_flags_exit_naming_roadmap(flag, capsys):
    with pytest.raises(SystemExit):
        build_server(["-c", "config.json", "-f", "x.pt", "-w", "y.pt"]
                     + flag)
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP.md Queue 1" in err


def test_stream_mux_refusal_names_queue_1_e(capsys):
    with pytest.raises(SystemExit):
        build_server(["-c", "config.json", "-f", "x.pt", "-w", "y.pt",
                      "--stream-mux", "4"])
    assert "ROADMAP.md Queue 1, (e) slice C item 18 (multistream mux)" in \
        capsys.readouterr().err


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
    assert serve_cli.UNPORTED_FLAGS          # the refusals stay listed


def test_shutdown_refuses_new_work(files, config):
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          **ENGINE)
    eng.shutdown()
    eng.shutdown()                            # safe twice
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit("Hello.", 0)
    assert eng.model is None and eng.wg is None
