"""HTTP front end: request routing, the model registry, and the chunked
and WebSocket streaming transports (port of flowtron_tpu/serve/http.py;
see the package docstring for the protocol). Endpoints that are not
ported answer 501 and name their ROADMAP.md item."""

import json

from flowtron_tpu_torch import __version__
from flowtron_tpu_torch.serve.common import (
    EngineOverloaded, TextTooLong, UnknownModel, _log,
)
from flowtron_tpu_torch.serve.wire import (
    _BodyTooLarge, _HTTP_MAX_BODY, _wav_bytes, _wav_stream_header,
    _ws_accept_key, _ws_recv, _ws_send,
)

UNPORTED = {
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

        def _stream_args(self, req, eng):
            """``eng.stream`` on a request body; validation errors raise
            here, before any response is committed."""
            return eng.stream(
                req["text"], req.get("speaker_id", 0),
                req.get("sigma", 0.5), req.get("seed", 1234),
                n_frames=req.get("n_frames"),
                temperature=req.get("temperature"),
                split=bool(req.get("split", False)),
                denoise=req.get("denoise"))

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
            elif self.path == "/stream-ws":
                self._do_stream_ws()
            elif self.path == "/":
                self._json(200, {
                    "service": "flowtron_tpu_torch",
                    "version": __version__,
                    "endpoints": {
                        "POST /synthesize": "full wav (json request)",
                        "POST /stream": "chunked-transfer wav",
                        "GET /stream-ws": "WebSocket: json in, pcm16 "
                                          "frames out",
                        "GET /models": "resident voices + speaker ids",
                        "GET /metrics": "counters + latency percentiles",
                        "GET /healthz": "liveness + queue depth",
                    },
                    "request_fields": [
                        "text", "speaker_id", "sigma", "seed", "n_frames",
                        "temperature", "split", "denoise", "model"],
                })
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            if not self._unported("DELETE"):
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self._unported("POST"):
                return
            if self.path == "/stream":
                self._do_stream()
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

        def _do_stream(self):
            """Chunked-transfer WAV: audio bytes flow as synthesis runs."""
            try:
                req = self._read_json_body()
                eng = self._engine(req)
                if not eng.can_stream:
                    self._json(501, {"error": "streaming requires a "
                                     "neural vocoder (-w)"})
                    return
                gen = self._stream_args(req, eng)
            except KeyError as e:
                self._json(400, {"error": f"missing field {e}"})
                return
            except UnknownModel as e:
                self._json(404, {"error": str(e)})
                return
            except _BodyTooLarge as e:
                self.close_connection = True
                self._json(413, {"error": str(e)})
                return
            except TextTooLong as e:
                self._json(413, {"error": str(e)})
                return
            except EngineOverloaded as e:
                self._json(429, {"error": str(e)})
                return
            except ValueError as e:  # empty text, denoise without -d, ...
                self._json(400, {"error": str(e)})
                return
            except Exception as e:
                self._json(500, {"error": repr(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def write_chunk(b):
                self.wfile.write(f"{len(b):X}\r\n".encode() + b + b"\r\n")

            try:
                write_chunk(_wav_stream_header(
                    eng.data_config["sampling_rate"]))
                for pcm in gen:
                    if len(pcm):
                        write_chunk(pcm.tobytes())
                self.wfile.write(b"0\r\n\r\n")
            finally:
                gen.close()  # a client that left: release the streamers

        def _do_stream_ws(self):
            """WebSocket streaming (RFC 6455): the client upgrades, sends
            one text frame with the /stream JSON body, and receives a text
            frame {"sample_rate", "format"}, binary frames of PCM16 mono,
            then a close frame. An error arrives as a text frame {"error":
            ...} before the close."""
            key = self.headers.get("Sec-WebSocket-Key")
            if self.headers.get("Upgrade", "").lower() != "websocket" \
                    or not key:
                self._json(400, {"error": "expected websocket upgrade"})
                return
            if not any(e.can_stream for e in engines.values()):
                self._json(501, {"error": "streaming requires a neural "
                                 "vocoder (-w)"})
                return
            self.send_response(101, "Switching Protocols")
            self.send_header("Upgrade", "websocket")
            self.send_header("Connection", "Upgrade")
            self.send_header("Sec-WebSocket-Accept", _ws_accept_key(key))
            self.end_headers()
            self.close_connection = True

            def text(obj):
                _ws_send(self.wfile, json.dumps(obj).encode(), 1)

            def close():
                _ws_send(self.wfile, b"\x03\xe8", 8)   # 1000, normal

            gen = None
            try:
                opcode, payload = _ws_recv(self.rfile)
                if opcode != 1:
                    text({"error": "expected a text frame with the "
                          "request JSON"})
                    close()
                    return
                req = json.loads(payload or b"{}")
                eng = self._engine(req)
                if not eng.can_stream:
                    text({"error": "streaming requires a neural vocoder "
                          "(-w) on this model"})
                    close()
                    return
                gen = self._stream_args(req, eng)
                text({"sample_rate": eng.data_config["sampling_rate"],
                      "format": "pcm16"})
                for pcm in gen:
                    if len(pcm):
                        _ws_send(self.wfile, pcm.tobytes(), 2)
                close()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client went away mid-stream
            except KeyError as e:
                text({"error": f"missing field {e}"})
                close()
            except Exception as e:
                try:
                    text({"error": str(e)})
                    close()
                except OSError:
                    _log.debug("client socket gone while sending the "
                               "websocket error frame", exc_info=True)
            finally:
                if gen is not None:
                    gen.close()  # release the streamers

    return Handler
