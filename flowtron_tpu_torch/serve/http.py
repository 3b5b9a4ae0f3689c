"""HTTP front end: request routing, the model registry with runtime
loads and unloads, trace capture, and the chunked and WebSocket streaming
transports (port of flowtron_tpu/serve/http.py; see the package docstring
for the protocol)."""

import gc
import json
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler

import torch

from flowtron_tpu_torch import __version__
from flowtron_tpu_torch.serve.common import (
    EngineOverloaded, TextTooLong, UnknownModel, _log,
)
from flowtron_tpu_torch.serve.wire import (
    _BodyTooLarge, _HTTP_MAX_BODY, _wav_bytes, _wav_stream_header,
    _ws_accept_key, _ws_recv, _ws_send,
)
from flowtron_tpu_torch.utils.profiler import start_profiler, stop_profiler


class ProfileCapture:
    """``POST /profile``'s capture, one at a time: ``torch.profiler`` (CPU
    activity, plus CUDA activity when ``device`` is a card) for
    ``seconds`` of whatever traffic is live, written as a Chrome trace
    ``trace.json`` into ``dir`` or a fresh temporary directory. The
    server's handler and the ``--profiler-port`` listener share one, so
    they share its lock. CUDA activity is the whole process's (CUPTI); CPU
    operator events of the dispatcher and stream threads may be missing."""

    def __init__(self, device):
        self._device = torch.device(device)
        self._lock = threading.Lock()

    def __call__(self, req):
        """A request body -> (HTTP code, JSON answer), as the JAX server's
        ``_do_profile``: ``seconds`` clamped to [0.05, 60], 400 for one
        that is not a number, 409 while another capture runs."""
        try:
            seconds = min(60.0, max(0.05, float(req.get("seconds", 1.0))))
        except (TypeError, ValueError):
            return 400, {"error": "seconds must be a number"}
        if not self._lock.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running"}
        try:
            trace_dir = req.get("dir") or tempfile.mkdtemp(
                prefix="flowtron-trace-")
            prof = start_profiler(self._device)
            time.sleep(seconds)
            stop_profiler(prof, trace_dir)
        except Exception as e:
            _log.exception("profile capture failed")
            return 500, {"error": repr(e)}
        finally:
            self._lock.release()
        return 200, {"trace_dir": trace_dir, "seconds": seconds}


class _JsonHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

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

    def _json_request(self):
        """The request body, or None after answering 413 / 400."""
        try:
            return self._read_json_body()
        except _BodyTooLarge as e:
            self.close_connection = True
            self._json(413, {"error": str(e)})
        except Exception as e:
            self._json(400, {"error": repr(e)})
        return None


def make_profile_handler(profile):
    """The ``--profiler-port`` listener's handler: ``POST /profile`` with
    the ``ProfileCapture`` ``profile``, 404 for anything else."""

    class ProfileHandler(_JsonHandler):
        def do_POST(self):
            if self.path != "/profile":
                self.close_connection = True
                self._json(404, {"error": "not found"})
                return
            req = self._json_request()
            if req is not None:
                self._json(*profile(req))

    return ProfileHandler


def make_handler(engine, loader=None, profile=None):
    """HTTP handler over one engine or a {name: engine} dict; requests
    pick a voice with a "model" field, the first entry is the default.

    With ``loader(config_path, ckpt, vocoder) -> SynthesisEngine``, ``POST
    /models`` {"name", "config", "checkpoint", "vocoder"?} loads a voice
    at runtime (501 without one), and ``DELETE /models/<name>`` shuts its
    engine down and gives its device memory back. The last resident model
    cannot be unloaded; unloading the default promotes the next voice. The
    dict is not copied: runtime loads and unloads change the caller's, so
    its owner shuts the runtime-loaded engines down too. ``profile``: the
    ``ProfileCapture`` behind ``POST /profile`` (by default a new one on
    the first engine's device)."""
    engines = engine if isinstance(engine, dict) else {"default": engine}
    if not engines:
        raise ValueError("no models given")
    reg_lock = threading.Lock()
    reg = {"default": next(iter(engines)), "loading": set()}
    if profile is None:
        profile = ProfileCapture(next(iter(engines.values())).device)

    class Handler(_JsonHandler):
        def _engine(self, req):
            with reg_lock:
                name = req.get("model") or reg["default"]
                if name not in engines:
                    raise UnknownModel(name, set(engines))
                return engines[name]

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

        def do_GET(self):
            with reg_lock:
                snap = dict(engines)
                default_name = reg["default"]
            multi = len(snap) > 1
            if self.path == "/healthz":
                depths = {n: e.queue_depth for n, e in snap.items()}
                out = {"status": "ok", "queue_depth": sum(depths.values())}
                if multi:
                    out["models"] = depths
                self._json(200, out)
            elif self.path == "/metrics":
                self._json(200, {n: e.metrics() for n, e in snap.items()}
                           if multi else snap[default_name].metrics())
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
                    } for n, e in snap.items()]})
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
                        "POST /models": "load a voice at runtime",
                        "DELETE /models/<name>": "drain + unload",
                        "GET /metrics": "counters + latency percentiles",
                        "GET /healthz": "liveness + queue depth",
                        "POST /profile": "capture a device trace",
                    },
                    "request_fields": [
                        "text", "speaker_id", "sigma", "seed", "n_frames",
                        "temperature", "split", "denoise", "model"],
                })
            else:
                self._json(404, {"error": "not found"})

        def do_DELETE(self):
            """DELETE /models/<name>: shut the engine down (its queue
            drains, active streams finish) and give its device memory
            back. 404 for an unknown name, 409 for the last resident
            model."""
            if not self.path.startswith("/models/"):
                self._json(404, {"error": "not found"})
                return
            name = self.path[len("/models/"):]
            # decide under the lock, answer outside it: a slow client must
            # not block the registry
            eng = err = None
            with reg_lock:
                if name not in engines:
                    err = (404, {"error": f"unknown model {name!r}"})
                elif len(engines) == 1:
                    err = (409, {"error": "cannot unload the last resident "
                                 "model"})
                else:
                    eng = engines.pop(name)
                    if reg["default"] == name:
                        reg["default"] = next(iter(engines))
                    new_default = reg["default"]
            if err is not None:
                self._json(*err)
                return
            on_card = eng.device.type == "cuda"
            eng.shutdown()
            del eng
            if on_card:
                gc.collect()
                torch.cuda.empty_cache()
            self._json(200, {"unloaded": name, "default": new_default})

        def _do_load_model(self, req):
            """POST /models: load a voice at runtime. The engine is built
            outside the registry lock (a checkpoint load takes seconds); a
            set of names being loaded leaves concurrent loads of one name
            one winner (409 for the others)."""
            if loader is None:
                self._json(501, {"error": "runtime model loading is not "
                                 "enabled (start via the serve CLI, or pass "
                                 "make_handler a loader)"})
                return
            try:
                name = req["name"]
                config_path = req["config"]
                ckpt = req["checkpoint"]
            except KeyError as e:
                self._json(400, {"error": f"missing field {e}"})
                return
            with reg_lock:
                taken = name in engines or name in reg["loading"]
                if not taken:
                    reg["loading"].add(name)
            if taken:
                self._json(409, {"error": f"model {name!r} is already "
                                 "loaded (or loading)"})
                return
            try:
                eng = loader(config_path, ckpt, req.get("vocoder", ""))
            except Exception as e:
                _log.exception("loading model %r failed", name)
                with reg_lock:
                    reg["loading"].discard(name)
                self._json(500, {"error": repr(e)})
                return
            # one step: a gap between them would let a concurrent load of
            # the same name take the slot and leak this engine
            with reg_lock:
                reg["loading"].discard(name)
                engines[name] = eng
            self._json(200, {"loaded": name, "can_stream": eng.can_stream})

        def do_POST(self):
            if self.path == "/stream":
                self._do_stream()
                return
            if self.path in ("/models", "/profile"):
                req = self._json_request()
                if req is None:
                    return
                if self.path == "/models":
                    self._do_load_model(req)
                else:
                    self._json(*profile(req))
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
            with reg_lock:
                streamable = any(e.can_stream for e in engines.values())
            if not streamable:
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

