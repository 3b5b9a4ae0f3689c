"""Serving runtime: an HTTP TTS endpoint with dynamic request batching
and streaming (port of flowtron_tpu/serve without the mesh and bf16).

A micro-batching queue coalesces concurrent requests into one synthesis
chain on the card: latents -> flows (kernel K1, or the per-frame loop for
a quantized flow or a batch of mixed temperatures, with kernel K4 under
``--quantize w8a8``) -> gate masking -> WaveGlow (kernel K2) -> the bias
denoiser with per-request strengths (``-d``) -> peak-normalised int16. A
dispatcher thread launches each batch and a completion thread copies it
to the host. With ``--vocode-buckets`` a batch whose n_frames caps all
fit a bucket below ``--n-frames`` is staged: its mel first, then the
completion thread vocodes it at the smallest bucket that covers its
frames. Without a vocoder (no ``-w``) the chain ends at the mel and the
completion thread vocodes each request with Griffin-Lim on the host.
Streams run on a pool of ``--stream-workers`` warm streamer pairs, each
stream on its own producer thread (infer/streaming.py: the prelude flows
through K1, flow 0 through the loop chunk by chunk, K2 for each vocoder
window), or with ``--stream-mux N`` on the N slots of one multiplexer
(infer/multistream.py): a stepper thread advances every stream with one
batched loop a tick of 40 frames and vocodes the ready windows in
batches; ``--mux-joins-per-tick K`` joins at most K streams a tick.

POST /synthesize  {"text": "...", "speaker_id": 0, "sigma": 0.5,
                   "n_frames": 400, "temperature": 1.0, "seed": 1234,
                   "split": false, "denoise": 0.1, "model": "default"}
  -> audio/wav bytes. Text longer than the largest bucket is rejected
  with 413 unless "split": true, which sentence-splits it and
  synthesizes the segments as one micro-batch. A full queue answers 429;
  a body over 1 MB 413. "denoise" overrides -d's strength (only on an
  engine started with -d).
POST /stream      same body -> chunked-transfer audio/wav (PCM16 with
                  unknown sizes), bytes flowing as synthesis runs; a
                  fixed clip scale, not peak-normalised. All stream
                  workers (or mux slots) busy: 429. Without a vocoder:
                  501.
GET /stream-ws    WebSocket (RFC 6455): one text frame with the same JSON
                  body in; {"sample_rate", "format"}, binary PCM16 frames
                  and a close frame out; errors as a JSON text frame.
GET /healthz      -> {"status": "ok", "queue_depth": N}
GET /metrics      -> request/batch/stream/error/rejection counters, audio
                  seconds, recent batch-latency percentiles, staged
                  batches and hits per vocode bucket; with the mux
                  mux_active_streams and mux_slots
GET /models       -> loaded voices (``--model`` adds more)
POST /models      {"name", "config", "checkpoint", "vocoder"?} -> loads a
                  voice at runtime: {"loaded", "can_stream"}; 400 for a
                  missing field, 409 for a name loaded or loading, 500 when
                  the load fails (the name is free again), 501 without a
                  loader (``make_handler`` without one)
DELETE /models/<name> -> drains and unloads a voice and gives its device
                  memory back: {"unloaded", "default"} (unloading the
                  default promotes the next voice); 404 for an unknown
                  name, 409 for the last resident voice
POST /profile     {"seconds": 1.0, "dir": optional} -> a torch.profiler
                  Chrome trace of the live traffic (seconds clamped to
                  [0.05, 60]): {"trace_dir", "seconds"}; 400 for a seconds
                  that is not a number, 409 while a capture runs
GET /             -> the endpoint index

``--profiler-port P`` answers POST /profile on a second port;
``--compile-cache DIR`` makes DIR the kernel libraries' build directory;
``--mesh D,M`` serves over a data x model mesh of the visible cards
(engine.py), ``--bf16`` in bf16. Every flag of the JAX server is ported.

Run: python -m flowtron_tpu_torch.serve -c config.json -f model.pt
     [-w waveglow.pt -d 0.1 --stream-workers 2 | --stream-mux 8
     --mux-joins-per-tick 2] [--vocode-buckets 120,240] [--port 8080
     --max-batch 8 --batch-timeout-ms 20 --max-queue 64
     --quantize w8|w8a8|w4 --bf16 --mesh D,M --warmup
     --compile-cache DIR --profiler-port P]
"""

from flowtron_tpu_torch.serve.common import (EngineOverloaded, TextTooLong,
                                             UnknownModel, split_measured)
from flowtron_tpu_torch.serve.engine import SynthesisEngine
from flowtron_tpu_torch.serve.http import make_handler
from flowtron_tpu_torch.serve.cli import build_server, main

__all__ = ["EngineOverloaded", "TextTooLong", "UnknownModel",
           "split_measured", "SynthesisEngine", "make_handler",
           "build_server", "main"]
