"""Server CLI: argument parsing, engine construction (with extra
``--model`` voices and the runtime loader of ``POST /models``), warmup
and graceful shutdown (port of flowtron_tpu/serve/cli.py).
``build_server`` does everything but serve, so a caller can run the
server in-process.

    python -m flowtron_tpu_torch.serve -c config.json -f model.pt \\
        [-w waveglow.pt] [-d 0.1] [--stream-workers 2 | --stream-mux 8 \\
        [--mux-joins-per-tick 2]] [--vocode-buckets 120,240] \\
        [--quantize w8a8] [--bf16] [--max-batch 8] [--replicas N|auto | \\
        --mesh D,M] [--warmup] [--compile-cache DIR] [--profiler-port P] \\
        [--model NAME=CONFIG:CKPT[:VOCODER] ...]

Without ``-w`` the server vocodes with Griffin-Lim on the host and cannot
stream.

``--compile-cache DIR``: the JAX server points XLA's persistent compile
cache there. Serving compiles nothing here but the kernel libraries, so
DIR becomes their build directory (``ops/_build.py:set_build_dir``): a
fresh process or checkout pointed at it reuses the libraries built into
it (they are keyed by a hash of source, headers and flags).
``--profiler-port P``: the JAX server starts ``jax.profiler``'s gRPC
server there for TensorBoard's capture button; PyTorch has none, so this
starts a second HTTP listener on P that answers ``POST /profile`` alone,
with the main server's capture and lock. TensorBoard's remote-capture
button does not reach it.

``--mesh D,M``: the JAX server's data x model serving mesh over the
visible cards (engine.py's ``mesh_shape``); it wins over ``--replicas``
and turns ``--vocode-buckets`` and ``--fused`` off, each with the JAX
server's warning.

Runs on cuda:0 (``--replicas``: one copy a card); ``FLOWTRON_PLATFORM=cpu``
runs it on the CPU. Every flag of the JAX server is ported.
"""

import argparse
import signal
import threading
from http.server import ThreadingHTTPServer

from flowtron_tpu_torch.config import load_config
from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.serve import engine as serve_engine
from flowtron_tpu_torch.serve.engine import SynthesisEngine
from flowtron_tpu_torch.serve.http import (
    ProfileCapture, make_handler, make_profile_handler,
)
from flowtron_tpu_torch.utils.device import resolve_device

# the JAX server's flags that the port refuses (flag -> its ROADMAP.md
# item): none since the serving mesh
UNPORTED_FLAGS = {}


def _parser():
    parser = argparse.ArgumentParser(
        description="Flowtron TTS server (PyTorch/CUDA port)")
    parser.add_argument("-c", "--config", required=True)
    parser.add_argument("-p", "--params", nargs="+", default=[])
    parser.add_argument("-f", "--flowtron_path", required=True,
                        help="reference-format .pt state_dict or a JAX "
                             "package pickle checkpoint")
    parser.add_argument("-w", "--waveglow_path", default="",
                        help="WaveGlow .pt or JAX package pickle; without "
                             "it requests are vocoded by Griffin-Lim on the "
                             "host")
    parser.add_argument("-d", "--denoise", type=float, default=0.0,
                        help="WaveGlow bias-denoiser strength (0 = off; "
                             "needs -w); requests override it with "
                             "\"denoise\"")
    parser.add_argument("--stream-workers", type=int, default=2,
                        help="concurrent /stream(-ws) capacity: warm "
                             "streamer pairs (needs -w)")
    parser.add_argument("--stream-mux", type=int, default=0,
                        help="N > 0: serve streams through one batched "
                             "N-slot multiplexer (one frame loop advances "
                             "every stream) instead of the streamer pool")
    parser.add_argument("--mux-joins-per-tick", type=int, default=0,
                        help="K > 0: --stream-mux joins at most K new "
                             "streams a tick (encode and prelude), so a "
                             "rush of joins cannot stall running streams; "
                             "0 joins in the request thread")
    parser.add_argument("--vocode-buckets", default="",
                        help="comma list of mel-frame buckets (e.g. "
                             "'120,240'): a batch whose n_frames caps all "
                             "fit a bucket below --n-frames is vocoded at "
                             "the smallest bucket that covers it")
    parser.add_argument("--replicas", default="1",
                        help="N or 'auto': data-parallel replicas, one "
                             "model-and-vocoder copy a visible card, "
                             "micro-batches dispatched round-robin; 'auto' "
                             "= the card count, N above it clamps")
    parser.add_argument("--mesh", default="",
                        help="multi-chip serving mesh 'data,model', e.g. "
                             "'2,4': weights tensor-parallel over model, "
                             "requests sharded over data")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--batch-timeout-ms", type=float, default=20.0)
    parser.add_argument("--n-frames", type=int, default=400)
    parser.add_argument("--max-queue", type=int, default=64,
                        help="pending-request bound; overload returns 429")
    parser.add_argument("--int8", action="store_true",
                        help="int8 weight-only flows (alias: --quantize w8)")
    parser.add_argument("--quantize", choices=("w8", "w8a8", "w4"),
                        default="", help="flow-weight quantization mode; "
                                         "w8a8 runs kernel K4")
    parser.add_argument("--bf16", action="store_true",
                        help="serve in bf16: the flows' and the vocoder's "
                             "float weights cast to bf16 (quantized leaves "
                             "keep their fp32 scales); kernels K1, K2 and "
                             "K4 run their bf16 bodies")
    parser.add_argument("--fused", action="store_true",
                        help="early exit in the decoder kernel K1 once "
                             "every stream of a batch has finished")
    parser.add_argument("--warmup", action="store_true",
                        help="run one dummy batch per (batch, text) bucket "
                             "before accepting traffic")
    parser.add_argument("--model", action="append", default=[],
                        metavar="NAME=CONFIG:CKPT[:VOCODER]",
                        help="an extra named model next to the primary one "
                             "('default'); requests pick one with a "
                             "\"model\" field")
    parser.add_argument("--compile-cache", default="",
                        help="build directory of the kernel libraries: a "
                             "fresh process or checkout pointed at it "
                             "reuses the libraries built there")
    parser.add_argument("--profiler-port", type=int, default=0,
                        help="P > 0: a second HTTP listener on P answering "
                             "POST /profile alone (torch.profiler, the "
                             "main server's capture and lock); "
                             "TensorBoard's remote-capture button does not "
                             "reach it")
    return parser


def build_server(argv=None, host="0.0.0.0"):
    """Parse the flags, build every engine (warming them up with
    ``--warmup``) and the HTTP server, without serving. Returns (server,
    engines)."""
    parser = _parser()
    args = parser.parse_args(argv)

    if args.compile_cache:
        _build.set_build_dir(args.compile_cache)
    device = resolve_device()
    if args.replicas == "auto":
        n_replicas = len(serve_engine.local_devices(device))
    else:
        n_replicas = int(args.replicas)

    def build(config_path, ckpt, vocoder):
        return SynthesisEngine(
            load_config(config_path, args.params), ckpt, vocoder,
            max_batch=args.max_batch,
            batch_timeout_ms=args.batch_timeout_ms, n_frames=args.n_frames,
            int8=args.int8, quantize=args.quantize, fused=args.fused,
            bf16=args.bf16,
            max_queue=args.max_queue,
            # as in the JAX server, -d applies to the voices with a vocoder
            denoise=args.denoise if vocoder else 0.0,
            stream_workers=args.stream_workers, stream_mux=args.stream_mux,
            mux_joins_per_tick=args.mux_joins_per_tick,
            replicas=n_replicas,
            mesh_shape=[int(x) for x in args.mesh.split(",")]
            if args.mesh else None,
            vocode_buckets=[int(x) for x in args.vocode_buckets.split(",")]
            if args.vocode_buckets else None)

    engines = {"default": build(args.config, args.flowtron_path,
                                args.waveglow_path)}
    for spec in args.model:
        name, _, rest = spec.partition("=")
        parts = rest.split(":")
        if not name or len(parts) < 2:
            parser.error(f"--model expects NAME=CONFIG:CKPT[:VOCODER], "
                         f"got {spec!r}")
        engines[name] = build(parts[0], parts[1],
                              parts[2] if len(parts) > 2 else "")
    if args.warmup:
        for name, eng in engines.items():
            print(f"warming up {name}...", flush=True)
            print(f"  {eng.warmup()}", flush=True)
    profile = ProfileCapture(device)
    server = ThreadingHTTPServer((host, args.port), make_handler(
        engines, loader=build, profile=profile))
    # the --profiler-port listener, serving from here on; main() (or the
    # in-process caller) shuts it down with the server
    server.profiler_server = None
    if args.profiler_port:
        listener = ThreadingHTTPServer((host, args.profiler_port),
                                       make_profile_handler(profile))
        threading.Thread(target=listener.serve_forever, daemon=True).start()
        server.profiler_server = listener
        print(f"profiler listener on :{listener.server_address[1]} (POST "
              "/profile, torch.profiler; TensorBoard's remote capture does "
              "not reach it)", flush=True)
    return server, engines


def main(argv=None):
    server, engines = build_server(argv)

    def _graceful(signum, frame):
        # serve_forever() blocks this thread; shutdown() must be called
        # from another one or it deadlocks
        print(f"signal {signum}: draining...", flush=True)
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    print(f"serving on :{server.server_address[1]} (models="
          f"{list(engines)})", flush=True)
    server.serve_forever()
    server.server_close()
    if server.profiler_server is not None:
        server.profiler_server.shutdown()
        server.profiler_server.server_close()
    # a snapshot: a late POST /models may still change the dict
    for eng in list(engines.values()):
        eng.shutdown()
    print("shutdown complete")
