"""The server's admin endpoints and flags on the CPU: ``POST /models``,
``DELETE /models/<name>`` and ``POST /profile`` answer as the JAX
package's handler does (the same requests through both handlers over the
same stand-in engines give the same codes and bodies), runtime loads and
unloads on tiny real engines, the ``--profiler-port`` listener, and
``--compile-cache``."""

import gc
import json
import os
import shutil
import socket
import threading
import types
import urllib.error
import urllib.request
import weakref
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scipy.io import wavfile  # noqa: E402

from flowtron_tpu.serve.http import make_handler as jax_make_handler  # noqa: E402

from flowtron_tpu_torch.config import load_config  # noqa: E402
from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.ops import _build  # noqa: E402
from flowtron_tpu_torch.serve import build_server, make_handler  # noqa: E402
from flowtron_tpu_torch.serve import http as port_http  # noqa: E402
from flowtron_tpu_torch.serve.engine import SynthesisEngine  # noqa: E402

DIMS = dict(n_speakers=1, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=80, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)
ENGINE = dict(max_batch=2, batch_timeout_ms=50, text_buckets=(16,),
              n_frames=4, device="cpu")


class StandIn:
    """What the handlers read of an engine, and a record of shutdowns."""

    def __init__(self, name, can_stream=False):
        self.name, self.can_stream = name, can_stream
        self.device = torch.device("cpu")
        self.data_config = {"sampling_rate": 22050}
        self.config = {"model_config": {"n_speakers": 1}}
        self.frontend = types.SimpleNamespace(speaker_ids={0: 0})
        self.queue_depth = 0
        self.closed = False

    def metrics(self):
        return {"requests": 0}

    def shutdown(self):
        self.closed = True


def _serve(handler):
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _call(url, method="POST", body=None, raw=None):
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _loader(config_path, ckpt, vocoder):
    if ckpt == "broken.pt":
        raise FileNotFoundError(ckpt)
    return StandIn(ckpt, can_stream=bool(vocoder))


SCRIPT = [
    ("POST", "/models", {"name": "b", "config": "c.json"}),
    ("POST", "/models", {"name": "b", "config": "c.json",
                         "checkpoint": "b.pt", "vocoder": "w.pt"}),
    ("POST", "/models", {"name": "b", "config": "c.json",
                         "checkpoint": "b2.pt"}),
    ("POST", "/models", {"name": "x", "config": "c.json",
                         "checkpoint": "broken.pt"}),
    ("POST", "/models", {"name": "x", "config": "c.json",
                         "checkpoint": "x.pt"}),
    ("GET", "/models", None),
    ("DELETE", "/models/nobody", None),
    ("DELETE", "/models/default", None),
    ("GET", "/models", None),
    ("GET", "/healthz", None),
    ("DELETE", "/models/b", None),
    ("DELETE", "/models/x", None),
    ("DELETE", "/other", None),
    ("POST", "/profile", {"seconds": "soon"}),
    ("POST", "/profile", {"seconds": None}),
]


@pytest.mark.parametrize("with_loader", [True, False])
def test_admin_answers_match_jax(with_loader):
    """The script of requests above through JAX's ``make_handler`` and the
    port's, each over its own stand-in engines: the same codes and JSON
    bodies, the same engines shut down (400 for a missing field, 409 for
    a loaded name, 500 for a failing loader with the name freed, 404 and
    409 for unknown and last voices, the default promoted; 501 without a
    loader)."""
    answers, closed = [], []
    for make in (jax_make_handler, make_handler):
        engines = {"default": StandIn("default")}
        seen = [engines["default"]]

        def loader(*args):
            eng = _loader(*args)
            seen.append(eng)
            return eng

        server, url = _serve(make(engines, loader=loader if with_loader
                                  else None))
        try:
            answers.append([_call(url + path, method, body)
                            for method, path, body in SCRIPT])
        finally:
            server.shutdown()
            server.server_close()
        closed.append([(e.name, e.closed) for e in seen])
    assert answers[1] == answers[0]
    assert closed[1] == closed[0]
    codes = [code for code, _ in answers[1]]
    if with_loader:
        assert codes == [400, 200, 409, 500, 200, 200, 404, 200, 200, 200,
                         200, 409, 404, 400, 400]
        assert answers[1][7][1] == {"unloaded": "default", "default": "b"}
    else:
        assert codes[:5] == [501] * 5


def test_index_lists_the_admin_endpoints():
    server, url = _serve(make_handler(StandIn("default")))
    try:
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            endpoints = json.loads(r.read())["endpoints"]
    finally:
        server.shutdown()
        server.server_close()
    assert {"POST /models", "DELETE /models/<name>",
            "POST /profile"} <= set(endpoints)


def test_concurrent_loads_of_one_name_have_one_winner():
    """A slow loader: a second load of the name while the first is in the
    loader gets 409; the first gets 200; one engine is built."""
    entered, release, built = (threading.Event(), threading.Event(), [])

    def slow(config_path, ckpt, vocoder):
        entered.set()
        release.wait(30)
        built.append(ckpt)
        return StandIn(ckpt)

    engines = {"default": StandIn("default")}
    server, url = _serve(make_handler(engines, loader=slow))
    body = {"name": "v", "config": "c.json", "checkpoint": "v.pt"}
    first = []
    t = threading.Thread(target=lambda: first.append(
        _call(url + "/models", body=body)))
    try:
        t.start()
        assert entered.wait(30)
        second = _call(url + "/models", body=dict(body, checkpoint="w.pt"))
        release.set()
        t.join(30)
    finally:
        release.set()
        server.shutdown()
        server.server_close()
    assert not t.is_alive()
    assert second[0] == 409 and "already loaded" in second[1]["error"]
    assert first == [(200, {"loaded": "v", "can_stream": False})]
    assert built == ["v.pt"] and set(engines) == {"default", "v"}


def _tiny_files(root):
    rng = np.random.default_rng(0)
    wavfile.write(root / "u.wav", 22050,
                  (rng.standard_normal(4096) * 2000).astype(np.int16))
    (root / "fl.txt").write_text(f"{root}/u.wav|hello|0\n")
    model, _ = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS)
    with torch.no_grad():
        model.flows[-1].ar_step.gate_layer.linear_layer.bias.fill_(-20.0)
    torch.save(model.state_dict(), root / "ft.pt")
    overrides = [f"data_config.training_files={root}/fl.txt",
                 f"data_config.validation_files={root}/fl.txt",
                 "data_config.p_arpabet=0.0", "data_config.cmudict_path=",
                 "data_config.heteronyms_path="]
    overrides += [f"model_config.{k}={v}" for k, v in DIMS.items()]
    (root / "config.json").write_text(json.dumps(load_config(
        overrides=overrides)))
    return str(root / "config.json"), str(root / "ft.pt")


def _wav(url, body):
    req = urllib.request.Request(url + "/synthesize",
                                 data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.read()


def test_runtime_load_route_and_unload(tmp_path):
    """Real engines (Griffin-Lim, no vocoder): a voice loaded at runtime
    answers bitwise like the default on the same checkpoint and seed;
    unloading the default promotes it; the unloaded engine's model is
    freed; the last voice stays."""
    cfg, ft = _tiny_files(tmp_path)

    def loader(config_path, ckpt, vocoder):
        return SynthesisEngine(load_config(config_path), ckpt, vocoder,
                               **ENGINE)

    engines = {"default": loader(cfg, ft, "")}
    model_ref = weakref.ref(engines["default"].model)
    server, url = _serve(make_handler(engines, loader=loader))
    try:
        assert _call(url + "/models", body={
            "name": "twin", "config": cfg, "checkpoint": ft}) == \
            (200, {"loaded": "twin", "can_stream": False})
        body = {"text": "Hello there.", "seed": 5}
        assert _wav(url, dict(body, model="twin")) == _wav(url, body)
        assert _call(url + "/models/default", "DELETE") == \
            (200, {"unloaded": "default", "default": "twin"})
        gc.collect()
        assert model_ref() is None
        assert _call(url + "/models/twin", "DELETE")[0] == 409
        assert len(_wav(url, body)) > 44
    finally:
        server.shutdown()
        server.server_close()
        for eng in engines.values():
            eng.shutdown()


class HeldSleep:
    """``time`` for serve/http.py whose ``sleep`` holds a capture (and its
    lock) until released."""

    def __init__(self):
        self.entered, self.release = threading.Event(), threading.Event()

    def sleep(self, seconds):
        self.entered.set()
        self.release.wait(30)


def _held_capture(url, body, monkeypatch):
    """Start a capture through ``url`` that holds the lock until the
    returned ``HeldSleep`` is released; returns (its thread, its answer
    list, the HeldSleep)."""
    held = HeldSleep()
    monkeypatch.setattr(port_http, "time", held)
    out = []
    t = threading.Thread(target=lambda: out.append(_call(
        url + "/profile", body=body)))
    t.start()
    assert held.entered.wait(30)
    return t, out, held


def test_profile_writes_a_trace_and_refuses_a_second(tmp_path, monkeypatch):
    """``POST /profile``: a Chrome trace of the live traffic in ``dir``, or
    in a fresh temporary directory; 409 while a capture runs."""
    server, url = _serve(make_handler(StandIn("default")))
    try:
        code, body = _call(url + "/profile", body={
            "seconds": 0.05, "dir": str(tmp_path)})
        assert (code, body) == (200, {"trace_dir": str(tmp_path),
                                      "seconds": 0.05})
        with open(tmp_path / "trace.json") as f:
            assert "traceEvents" in json.load(f)
        code, body = _call(url + "/profile", body={"seconds": 0.05})
        assert code == 200 and os.path.basename(
            body["trace_dir"]).startswith("flowtron-trace-")
        assert os.path.exists(os.path.join(body["trace_dir"], "trace.json"))
        t, first, held = _held_capture(url, {"dir": str(tmp_path / "b")},
                                       monkeypatch)
        code, body = _call(url + "/profile", body={"seconds": 0.05})
        held.release.set()
        t.join(30)
        assert code == 409 and "already running" in body["error"]
        assert first == [(200, {"trace_dir": str(tmp_path / "b"),
                                "seconds": 1.0})]
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("asked,clamped", [(0.0, 0.05), (1e9, 60.0),
                                           ("2", 2.0)])
def test_profile_clamps_seconds(monkeypatch, tmp_path, asked, clamped):
    slept = []
    monkeypatch.setattr(port_http, "time",
                        types.SimpleNamespace(sleep=slept.append))
    capture = port_http.ProfileCapture("cpu")
    assert capture({"seconds": asked, "dir": str(tmp_path)}) == \
        (200, {"trace_dir": str(tmp_path), "seconds": clamped})
    assert slept == [clamped]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_profiler_port_listener(tmp_path, monkeypatch):
    """``--profiler-port P``: a second listener on P answers ``POST
    /profile`` alone (404 elsewhere) and shares the main server's lock;
    the main server's runtime loader is on (``build_server`` passes
    ``loader=build``)."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    cfg, ft = _tiny_files(tmp_path)
    port = _free_port()
    server, engines = build_server(
        ["-c", cfg, "-f", ft, "--port", "0", "--n-frames", "4",
         "--max-batch", "1", "--profiler-port", str(port)], host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    purl = f"http://127.0.0.1:{port}"
    try:
        assert server.profiler_server.server_address[1] == port
        assert _call(purl + "/profile", body={
            "seconds": 0.05, "dir": str(tmp_path / "t")}) == \
            (200, {"trace_dir": str(tmp_path / "t"), "seconds": 0.05})
        assert os.path.exists(tmp_path / "t" / "trace.json")
        assert _call(purl + "/models", body={})[0] == 404
        t, first, held = _held_capture(url, {"dir": str(tmp_path / "u")},
                                       monkeypatch)
        code = _call(purl + "/profile", body={"seconds": 0.05})[0]
        held.release.set()
        t.join(30)
        assert code == 409 and first[0][0] == 200
        assert _call(url + "/models", body={
            "name": "two", "config": cfg, "checkpoint": ft})[0] == 200
        assert set(engines) == {"default", "two"}
    finally:
        server.shutdown()
        server.server_close()
        server.profiler_server.shutdown()
        server.profiler_server.server_close()
        for eng in list(engines.values()):
            eng.shutdown()


def test_compile_cache_sets_the_build_directory(tmp_path, monkeypatch):
    """``--compile-cache DIR`` makes DIR the build directory; a library
    loaded from it pins it: moving it again raises naming both."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain available")
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    cfg, ft = _tiny_files(tmp_path)
    cache = tmp_path / "cache"
    server, engines = build_server(
        ["-c", cfg, "-f", ft, "--port", "0", "--n-frames", "4",
         "--compile-cache", str(cache)], host="127.0.0.1")
    try:
        assert _build.BUILD_DIR == cache.resolve()
        _build.set_build_dir(cache)           # the same directory: fine
        from flowtron_tpu_torch import native
        native.build()
        assert list(cache.glob("mel-*.so"))
        with pytest.raises(RuntimeError) as err:
            _build.set_build_dir(tmp_path / "elsewhere")
        assert str(cache.resolve()) in str(err.value)
        assert str((tmp_path / "elsewhere").resolve()) in str(err.value)
    finally:
        server.server_close()
        for eng in engines.values():
            eng.shutdown()
