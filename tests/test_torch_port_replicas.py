"""``--replicas`` on the serving engine (serve/engine.py, dispatch.py,
cli.py; the JAX engine's flowtron_tpu/serve/engine.py:315-342) on the
CPU, with a device list of two CPU devices patched in for the cards:
micro-batches round-robin over the replicas and counted in
``replica_batches`` (also over ``GET /metrics``), answers bitwise equal
to one replica's, the in-flight bound 2R - 1, warmup a replica at a
time, warm streamer pairs spread over the replicas, the JAX engine's
clamp and mesh-precedence warnings, and ``--replicas auto``. Toy flows at
n_mel 80 with the published WaveGlow layout, as tests/
test_torch_port_serve.py (whose fixtures these are)."""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flowtron_tpu_torch.serve import SynthesisEngine, build_server  # noqa: E402
from flowtron_tpu_torch.serve import engine as engine_mod  # noqa: E402

from tests.test_torch_port_serve import (  # noqa: E402,F401
    ENGINE, config, files,
)

TEXTS = ["Hello there.", "A second one.", "Third text here.", "Four."]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread here: the suite runs several workers a core's
    worth of them, and the ranks and engines of these tests beside them;
    torch's default of a thread a core slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def two_cpus(monkeypatch):
    monkeypatch.setattr(engine_mod, "local_devices",
                        lambda device: [torch.device("cpu")] * 2)


def _settled(metrics, requests, timeout=30.0):
    """``metrics()`` once the completion thread has counted ``requests``:
    it hands a request its audio before it counts the batch."""
    deadline = time.monotonic() + timeout
    while True:
        m = metrics()
        if m["requests"] >= requests or time.monotonic() > deadline:
            return m
        time.sleep(0.01)


def _answers(eng):
    """Each text alone (one batch each), in turn."""
    return [eng.submit(t, seed=40 + i)[0] for i, t in enumerate(TEXTS)]


def test_replicas_round_robin_bitwise(files, config, two_cpus):
    one = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          **ENGINE)
    two = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          replicas=2, **ENGINE)
    try:
        assert two._n_replicas == 2 and two._inflight.maxsize == 3
        assert one._inflight.maxsize == 1
        assert two._replicas[1].model is not two._replicas[0].model
        ref, got = _answers(one), _answers(two)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        m = _settled(two.metrics, len(TEXTS))
        assert m["replica_batches"] == [2, 2]
        assert sum(m["replica_batches"]) == m["batches"] == len(TEXTS)
        assert _settled(one.metrics, len(TEXTS))["replica_batches"] == \
            [len(TEXTS)]
        # warmup: every (batch, text) bucket on each replica in turn
        assert two.warmup()["batches"] == \
            2 * len(two.batch_buckets()) * len(two.text_buckets)
        # the warm streamer pairs alternate over the replicas
        models = [pair[0].model for pair in two._stream_pool.queue]
        assert models[0] is two._replicas[0].model
        assert models[1] is two._replicas[1].model
        streamed = b"".join(p.tobytes() for p in two.stream(TEXTS[0]))
        assert len(streamed) > 0
    finally:
        one.shutdown()
        two.shutdown()


def test_replicas_clamp_and_mesh_precedence(files, config, two_cpus, capsys):
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          replicas=3, **ENGINE)
    try:
        assert eng._n_replicas == 2
        assert eng.metrics()["replica_batches"] == [0, 0]
    finally:
        eng.shutdown()
    assert "WARNING: --replicas 3 > 2 local devices; clamping" in \
        capsys.readouterr().out
    # the mesh wins over replicas: one data group a visible device
    eng = SynthesisEngine(config, str(files / "ft.pt"), str(files / "wg.pt"),
                          replicas=2, mesh_shape=[2, 1], **ENGINE)
    try:
        assert eng._n_replicas == 1 and len(eng._groups) == 2
    finally:
        eng.shutdown()
    assert "--replicas is incompatible with --mesh" in \
        capsys.readouterr().out


def test_cli_replicas_auto_serves_metrics(files, two_cpus, monkeypatch):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    server, engines = build_server(
        ["-c", str(files / "config.json"), "-f", str(files / "ft.pt"),
         "-w", str(files / "wg.pt"), "--port", "0", "--n-frames", "6",
         "--replicas", "auto", "--max-batch", "4"], host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert engines["default"]._n_replicas == 2
        for text in TEXTS[:3]:
            req = urllib.request.Request(
                url + "/synthesize", data=json.dumps({"text": text}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200 and len(r.read()) > 44
        m = _settled(engines["default"].metrics, 3)
        with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
            assert json.loads(r.read())["replica_batches"] == [2, 1]
        assert m["replica_batches"] == [2, 1]
        assert sum(m["replica_batches"]) == m["batches"] == 3
    finally:
        server.shutdown()
        server.server_close()
        for eng in engines.values():
            eng.shutdown()
        thread.join(10)
    assert not thread.is_alive()
