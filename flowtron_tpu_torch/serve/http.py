"""HTTP front end: request routing and the model registry (port of the
batch endpoints of flowtron_tpu/serve/http.py; see the package docstring
for the protocol). Endpoints that are not ported answer 501 and name
their ROADMAP.md item."""

import json

from flowtron_tpu_torch import __version__
from flowtron_tpu_torch.serve.common import (
    EngineOverloaded, TextTooLong, UnknownModel,
)
from flowtron_tpu_torch.serve.wire import (
    _BodyTooLarge, _HTTP_MAX_BODY, _wav_bytes,
)

UNPORTED = {
    ("POST", "/stream"): "Queue 1, slice C item 17 (streaming)",
    ("GET", "/stream-ws"): "Queue 1, slice C item 17 (streaming)",
    ("POST", "/profile"): "Queue 1, slice C item 25 (/profile)",
    ("POST", "/models"): "Queue 1, slice C item 24 (runtime model load)",
    ("DELETE", "/models/"): "Queue 1, slice C item 24 (runtime model load)",
}


def make_handler(engine):
    """HTTP handler over one engine or a {name: engine} dict; requests
    pick a voice with a "model" field, the first entry is the default.
    Runtime model loading (the JAX handler's ``loader``) is not ported:
    POST /models answers 501."""
    from http.server import BaseHTTPRequestHandler

    engines = engine if isinstance(engine, dict) else {"default": engine}
    if not engines:
        raise ValueError("no models given")
    default_name = next(iter(engines))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _engine(self, req):
            name = req.get("model") or default_name
            if name not in engines:
                raise UnknownModel(name, set(engines))
            return engines[name]

        def _read_json_body(self):
            """Bounded body read: a declared Content-Length above
            _HTTP_MAX_BODY is rejected before anything is read."""
            length = int(self.headers.get("Content-Length", 0))
            if length > _HTTP_MAX_BODY:
                raise _BodyTooLarge(length)
            return json.loads(self.rfile.read(length) or b"{}")

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _unported(self, method):
            """501 for an endpoint that is not ported; True if it was one.
            The body is left unread, so the connection closes."""
            for (m, path), item in UNPORTED.items():
                if m == method and (self.path == path or (
                        path.endswith("/") and self.path.startswith(path))):
                    self.close_connection = True
                    self._json(501, {"error": f"{method} {self.path} is not "
                                     f"ported yet; see ROADMAP.md {item}"})
                    return True
            return False

        def do_GET(self):
            multi = len(engines) > 1
            if self._unported("GET"):
                return
            if self.path == "/healthz":
                depths = {n: e.queue_depth for n, e in engines.items()}
                out = {"status": "ok", "queue_depth": sum(depths.values())}
                if multi:
                    out["models"] = depths
                self._json(200, out)
            elif self.path == "/metrics":
                self._json(200, {n: e.metrics() for n, e in engines.items()}
                           if multi else engines[default_name].metrics())
            elif self.path == "/models":
                self._json(200, {
                    "default": default_name,
                    "models": [{
                        "name": n,
                        "can_stream": e.can_stream,
                        "sampling_rate": e.data_config["sampling_rate"],
                        "n_speakers": e.config["model_config"]
                        .get("n_speakers"),
                        "speaker_ids": sorted(
                            int(s) for s in e.frontend.speaker_ids),
                    } for n, e in engines.items()]})
            elif self.path == "/":
                self._json(200, {
                    "service": "flowtron_tpu_torch",
                    "version": __version__,
                    "endpoints": {
                        "POST /synthesize": "full wav (json request)",
                        "GET /models": "resident voices + speaker ids",
                        "GET /metrics": "counters + latency percentiles",
                        "GET /healthz": "liveness + queue depth",
                    },
                    "request_fields": [
                        "text", "speaker_id", "sigma", "seed", "n_frames",
                        "temperature", "split", "model"],
                })
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            if not self._unported("DELETE"):
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self._unported("POST"):
                return
            if self.path != "/synthesize":
                self.close_connection = True
                self._json(404, {"error": "not found"})
                return
            try:
                req = self._read_json_body()
                text = req["text"]
                wav, sr = self._engine(req).submit(
                    text, req.get("speaker_id", 0),
                    req.get("sigma", 0.5), req.get("seed", 1234),
                    n_frames=req.get("n_frames"),
                    temperature=req.get("temperature"),
                    split=bool(req.get("split", False)),
                    denoise=req.get("denoise"))
                body = _wav_bytes(wav, sr)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except KeyError as e:
                self._json(400, {"error": f"missing field {e}"})
            except UnknownModel as e:
                self._json(404, {"error": str(e)})
            except _BodyTooLarge as e:
                self.close_connection = True
                self._json(413, {"error": str(e)})
            except TextTooLong as e:
                self._json(413, {"error": str(e)})
            except EngineOverloaded as e:
                self._json(429, {"error": str(e)})
            except ValueError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                self._json(500, {"error": repr(e)})

    return Handler
