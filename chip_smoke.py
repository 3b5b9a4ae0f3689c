"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``flowtron_tpu_torch/csrc/`` (into
``build/torch_kernels/``, one ``nvcc`` per source, all started together),
holds each against its plain PyTorch version at its path's shapes (and
splits one vocoder pass's device time by part, ``waveglow_split``), then
drives the port's three paths at the full width of the repo's
``config.json`` model, on seeded random weights:

- the audio tail: the STFT, inverse STFT, Griffin-Lim and the denoiser
  (its bias pass: K2) on the card against the CPU, and the host
  ``StreamingDenoiser`` against the card's ``Denoiser``;
- streaming: ``infer/streaming.py:stream_tts`` at B=1 (the prelude flow
  through K1, flow 0 through the loop chunk by chunk, K2 for each vocoder
  window), against the offline mel and one offline vocoder pass;
- inference (text -> mel -> audio) through
  ``flowtron_tpu_torch.infer.sampling`` with the
  ``configs/config_waveglow.json`` vocoder (kernels K1, K2);
- the multistream mux (``infer/multistream.py``): 8 slots, eight streams
  (six joining at once, two later, one capped, one at another
  temperature), each held against its solo stream; K1 once a join (the
  prelude), never in a tick, K2 for each window group; then two w8a8
  streams (K4);
- bf16 serving (the JAX server's ``--bf16``): the bf16 bodies of K1, K2
  and K4 against their plain versions (and K1's and K2's against their
  fp32 bodies; K2's at eight shapes and widths, in CUDA graphs, beside
  bf16 cuBLAS's two products) at the main path's shapes, then the bf16
  chain at full
  width (``bf16_slice``: a B=1 and a B=4 400-frame request beside the
  fp32 chain on the same latents, K1 bf16 twice and K2 bf16 96 times a
  request), and later the servers with ``--bf16`` and ``--bf16 --quantize
  w8a8`` (the serve phase's waves), a ``POST /stream`` and the 2-slot mux
  (``serve_bf16``), and ``--bf16`` with ``--quantize w8`` and with
  ``--quantize w4 --vocode-buckets`` (``serve_bf16_mode``): only the bf16
  bodies launch;
- batch serving: the HTTP server of ``flowtron_tpu_torch.serve``, built
  in-process by ``serve/cli.py:build_server`` from the model saved to
  ``.pt`` files, first unquantized (K1, K2), then with ``--quantize
  w8a8`` (K4, K2), each answering concurrent ``POST /synthesize``
  requests; then the quantized modes (w8, w8a8, w4) card against CPU;
  then with ``--stream-workers 2 -d 0.1``, two ``POST /stream`` and a
  ``GET /stream-ws`` beside a wave of ``POST /synthesize``; then with
  ``--stream-mux 4 --mux-joins-per-tick 2 -d 0.1``, four ``POST /stream``
  beside a wave, a fifth refused with 429, a ``GET /stream-ws``, one
  stream held against the pooled server's; then staged vocoding
  (``--vocode-buckets 120,240``), capped waves staged and one-pass in
  turns; then without a vocoder (Griffin-Lim on the host, no K2);
- training through ``flowtron_tpu_torch.cli.train_main`` on a synthetic
  coded-tone corpus written to a temporary directory: one epoch of 10
  steps with ``config.json``'s bf16 policy, then one in fp32 (kernel K3,
  forward and backward); the fp32 run's checkpoint is then loaded for
  inference and put through the invertibility oracle; then the rest of
  the trainer: ``configs/config_libritts2k_gm.json``'s Gaussian-mixture
  model at its full width (16 steps, its bf16 policy, steps 10-14 traced
  by ``torch.profiler``, the trace checked for K3's kernels) and one of
  its steps card against CPU; config.json in fp32 with ``remat`` (its
  losses against the fp32 run's); config.json with cumulative attention
  (3 steps and a 400-frame request, neither K1 nor K3 in its flows);
  ``flowtron-torch-evaluate --plots --tone-cer 4`` on the GM checkpoint
  (its losses against the loop's validation, the oracle with the heads
  perturbed) and ``flowtron-torch-infer`` on it;
- the vocoder trainer (``flowtron_tpu_torch.scripts.train_waveglow``) on
  ``configs/config_waveglow.json`` at full width, B=4, 16000-sample
  segments of the same corpus, 10 steps in its bf16 policy and 10 in
  fp32 (no kernel: K2 has no backward), one step at reduced depth card
  against CPU; then WaveGlows wider than 256: a 512-channel one trained
  one step and a seeded 1024-channel one, each saved, loaded by
  ``load_waveglow`` and vocoding 400 frames through K2's wide builds
  against the plain path on the card (K2 at 512 and 1024 is first held
  against its plain version at the vocoder's shapes, ``k2`` / ``k2_bm``);
- distribution: ``train()`` over two ranks on the one card (gloo, spawned
  by ``parallel/launch.py``), config.json at full width in fp32 without
  dropout, against one process at the same global batch, then the ranks'
  ``torch.distributed.checkpoint`` directory resumed here bitwise
  (``ddp``); the vocoder trainer over two ranks against one
  (``waveglow_ddp``); and the server with ``--replicas auto`` and
  ``--replicas 2`` (clamped to the one card, answers bitwise alike,
  ``serve_replicas``);
- style transfer (``infer/style_transfer.py``, ``style_transfer``): four
  corpus utterances as references at config.json's full width, K3's
  forward in ``collect_z`` and K1 once a flow in the inversion, the card
  against the CPU's plain path, the card's attention maps fed back through
  ``attns=`` (the loop, no K1) against the K1 run; runtime voices
  (``serve_models``): ``POST /models`` of a second voice answering bitwise
  like the default, two concurrent loads of one name (200 and 409),
  ``DELETE`` giving the device memory back, the last voice kept;
  ``serve_profile``: ``POST /profile`` during waves of requests (the trace
  names K1's and K2's kernels), a second capture refused, the
  ``--profiler-port`` listener, and ``--compile-cache`` reused by a second
  process; ``native_mel``: the port's C++ mel and WAV reader built with
  ``g++`` on the host, against numpy and scipy;
- the TPU probes of ``scripts/exp_*.py`` (P1-P5) through their ports in
  ``flowtron_tpu_torch/scripts/``: the int4 dequant matmuls (``w4.cu``),
  the resident-weight scans (``resident.cu``) and K1 stripped for cost
  attribution (``fused_cost.cu``), each kernel first held against its
  plain version over the first 16 steps (and against a second run of
  itself, bit for bit), then each module's
  ``main`` driven at the script's default batch (and B=8 for P4 and P5).

Each path runs with every kernel's launch count set to 0 just before it
and read just after. Each phase prints one JSON line; the line before the
last lists the kernels (time, plain time, launches, the least time the
card could take for the same work, and a PyTorch library call's time
where one computes the same function), the last line is ``{"ok": true,
"device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result. There is no CPU fallback: without CUDA it
exits non-zero at once.

Imports nothing of JAX or of the JAX package ``flowtron_tpu`` (checked
at the end): the port carries its own text frontend and config.

    python3 chip_smoke.py --k4

runs only ``phase_k4_bf16`` (K4's bf16 bodies checked at every shape,
timed a call and the frame's nine calls in order, bf16 and fp32) and
prints no result. Copied into another checkout's root and run there, it
times that checkout's K4 with this script's harness: run it in two
checkouts in turns, in one call to the card, to hold two versions of the
kernel against each other.

    python3 chip_smoke.py --k1-bf16

runs only ``phase_k1_bf16`` (K1's bf16 body against its plain version
and the fp32 kernel at B=1, 4 and 8, both flows, its stage split and
where its rows lie, timed beside the fp32 kernel in turns; the fp32
kernel's outputs hashed) on the model the full run builds, and prints no
result; copied into another checkout it does the same for that one.

    python3 chip_smoke.py --k2-bf16

runs only ``phase_k2_bf16`` (K2's bf16 body against its plain version at
the vocoder's shapes and widths, timed in CUDA graphs, beside the fp32
body and the two products in bf16 cuBLAS, the host's us a call, every
build of its plan; the fp32 body's outputs hashed at the ``k2`` phase's
cases) on the vocoder the full run builds, and prints no result; copied
into another checkout it does the same for that one.
"""

import argparse
import contextlib
import io
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np
import torch

N_FRAMES = 400      # the reference's inference operating point
TK = 128            # text length of the random-text kernel checks
HOP, SR = 256, 22050
SIGMA = 0.5         # the latents' scale in infer/sampling.py:synthesize
REQ_SEED = 100      # latents seed of the first request
K1_TOL = 1e-3       # mel / attn / gate max-abs, kernel vs plain, fp32
K2_TOL = 1e-4       # max-abs relative to the output scale, fp32
K2_WIDE = (512, 1024)   # K2's builds past the 256-channel vocoder
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # of the output scale
SLICE_TOL = 1e-3    # card slice vs CPU plain slice, fp32
STFT_TOL = 1e-4     # STFT, ISTFT, Griffin-Lim, denoiser: card vs CPU, and
                    # the host StreamingDenoiser vs the card's Denoiser, of
                    # the output scale
SEAM_TOL = 5e-3     # streamed audio vs one vocoder pass on the same latents,
                    # of the scale: JAX's seam bar (tests/test_streaming.py)
# stream_tts on the main path: the server's chunk and window settings
STREAM = dict(max_frames=N_FRAMES, chunk_frames=40, context=24, lookahead=16)
# the multistream mux: the server's geometry, 8 slots, text at TK
MUX = dict(chunk_frames=40, context=24, lookahead=16, max_frames=N_FRAMES,
           text_len=TK, gate_threshold=0.5)
MUX_SEED = 500      # latents seed of the mux's first stream
# the stream servers' text frontend without its random ARPAbet
# substitutions (p_arpabet 0.5 draws them from a stream each server
# advances with every request), so one text gets the same ids on two
# servers and serve_mux can hold a muxed stream against a pooled one
NO_ARPABET = "data_config.p_arpabet=0.0"
MUX_TOL = 1e-3      # a muxed stream vs its solo stream on the card: mel
                    # max-abs, audio of its scale
N_UTTS, N_VAL = 66, 6   # corpus: 60 training utterances = 10 steps at B=6
LOSS_TOL, GNORM_TOL = 1e-4, 1e-3   # card step vs CPU plain step, relative
INV_TOL = 1e-4      # invertibility oracle on the card, fp32
K4_W8_TOL = 1e-5    # weight-only K4 vs plain, of the output scale (W8A8:
                    # bitwise, its int32 sums are exact)
QUANT_TOL = {"w8": 1e-3, "w4": 1e-3, "w8a8": 1e-2}   # card vs CPU mel
# mel MAE over the fp32 mel's mean magnitude: JAX's bars
# (tests/test_quantize.py:56,102), but for w4, whose 0.03 was set at
# n_hidden 64 and which the JAX package itself misses at this width on
# these weights (0.03393, tests/test_torch_port_quant_flagship.py)
QUALITY_BAR = {"w8": 0.005, "w4": 0.04, "w8a8": 0.03}
# the card's published peaks (H100 SXM, dense): HBM bytes/s and op/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12,
              "tf32": 495e12}
# special-function results (tanh, exp, reciprocal: MUFU ops) a second:
# derived, not a published peak; 132 SMs x 16 a clock (CUDA's throughput
# table for compute capability 9.0) x 1.98 GHz, the card's top SM clock
SFU_OPS_S = 132 * 16 * 1.98e9
# fp32 FMA-pipe instructions (FFMA, FADD, FMUL) a second: 132 SMs x 128
# lanes x 1.98 GHz, half PEAK_OPS_S["fp32"], which counts an FFMA as two
FMA_INSTR_S = 132 * 128 * 1.98e9
# FMA-pipe instructions of a reciprocal without the special-function
# pipe: three Newton steps of two FFMAs (csrc/attention.cu:rcp_newton)
NEWTON_RCP_FMA = 6
# (K, N) of kernel K4's calls on the flagship decoder's path: the nine
# per-frame dots of one flow, then the key/value precompute (once a flow)
K4_FRAME_KN = [(80, 4096), (1024, 4096), (1664, 4096), (1024, 4096),
               (1024, 4096), (1024, 4096), (1024, 640), (1024, 1024),
               (1024, 1024)]
K4_KN = sorted(set(K4_FRAME_KN)) + [(640, 640)]
# the probes of scripts/exp_*.py: kernel vs plain over the first 16 steps
# of each recurrence; bf16 outputs within 1e-2 of their scale (a bf16
# rounding may move by one step, ~0.4-0.8%, when the fp32 sums run in
# another order), fp32 states and mels within 1e-3 (their recurrences
# round each dot input to bf16, so such a step can pass into later steps)
PROBE_STEPS = 16
PROBE_BF16_TOL, PROBE_FP32_TOL = 1e-2, 1e-3
PROBE_KERNELS = ("w4_matmul", "resident_scan", "fused_cost")
P_W4_BODIES = ("k1", "k2", "k3", "k4", "k5", "concat", "2dot")
# kernel table rows of the probes: name -> (counter, Pallas body file:line)
PROBE_ROWS = [
    ("w4_matmul_k1", "w4", "scripts/exp_w4_kernel_bisect.py:54"),
    ("w4_matmul_k2", "w4", "scripts/exp_w4_kernel_bisect.py:62"),
    ("w4_matmul_k3", "w4", "scripts/exp_w4_kernel_bisect.py:72"),
    ("w4_matmul_k4", "w4", "scripts/exp_w4_kernel_bisect.py:85"),
    ("w4_matmul_k5", "w4", "scripts/exp_w4_kernel_bisect.py:96"),
    ("w4_matmul_concat", "w4", "scripts/exp_int4_variants.py:132"),
    ("w4_matmul_2dot", "w4", "scripts/exp_int4_variants.py:145"),
    ("resident_scan_p3", "resident", "scripts/exp_resident_weight.py:55"),
    ("resident_scan_bf16", "resident", "scripts/exp_fused_int8.py:71"),
    ("resident_scan_w8a8", "resident", "scripts/exp_fused_int8.py:127"),
    ("fused_cost_dots", "fused_cost", "scripts/exp_fused_cost.py:82"),
    ("fused_cost_lstm", "fused_cost", "scripts/exp_fused_cost.py:104"),
    ("fused_cost_attn", "fused_cost", "scripts/exp_fused_cost.py:133"),
]
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned.",
    "It was a bright cold day in April, and the clocks were striking "
    "thirteen.",
    "Hello world.",
]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, reps=1):
    """Mean device time of fn() over reps, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def paired_ms(kernel_fn, plain_fn, reps=1, plain_reps=1, rounds=3):
    """Kernel and plain times in turns (plain, kernel, kernel, plain),
    ``rounds`` times after a warm-up of each. The plain versions launch
    many small operations, so the host's load moves their times; the
    median of each side damps that. Returns both medians, every run in
    order, and the outputs of the last kernel and plain runs."""
    kernel_fn(), plain_fn()
    runs = []
    for _ in range(rounds):
        p1, out_p = cuda_ms(plain_fn, plain_reps)
        k1, out_k = cuda_ms(kernel_fn, reps)
        k2, _ = cuda_ms(kernel_fn, reps)
        p2, _ = cuda_ms(plain_fn, plain_reps)
        runs += [p1, k1, k2, p2]
    return (statistics.median(runs[1::4] + runs[2::4]),
            statistics.median(runs[0::4] + runs[3::4]), runs, out_k, out_p)


def warm_eager_ms(fn, reps=20, rounds=3):
    """Median over ``rounds`` of the ms per call of ``reps`` eager calls of
    fn(), after one warm-up call: device time with the host's launch time
    in it, as a training step pays it."""
    fn()
    return statistics.median(cuda_ms(fn, reps)[0] for _ in range(rounds))


def graph_times(fns, side, reps=20, rounds=3):
    """Device time per call of each fn in ``fns``: ``reps`` calls captured
    in one CUDA graph each and replayed in turns (the first fn, the
    second, ... then the reverse), ``rounds`` times; host dispatch does
    not count. Returns each fn's median ms per call, its last output and its
    runs' ms per call in order.
    For kernels that finish faster than Python can launch them. ``side``
    is the stream for the warm-up calls: one for the whole run, because
    cuBLAS keeps a workspace for every stream it has seen."""
    graphs, outs = [], []
    for fn in fns:
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                out = fn()
        graphs.append(g)
        outs.append(out)
    runs = [[] for _ in fns]
    for _ in range(rounds):
        order = list(range(len(fns)))
        for i in order + order[::-1]:
            ms, _ = cuda_ms(graphs[i].replay)
            runs[i].append(ms / reps)
    return [statistics.median(r) for r in runs], outs, runs


def bound(n_bytes, n_ops, kind="fp32"):
    """The least time (ms) the card could take: the larger of the bytes
    over HBM's rate and the operations over the peak rate of their type.
    ``n_ops`` may be a dict {type: operations} for work of mixed types,
    each part over its own peak, the times added. Returns (ms, "bytes"
    or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    ops = n_ops if isinstance(n_ops, dict) else {kind: n_ops}
    t_ops = sum(n / PEAK_OPS_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_bound(n_bytes, fma_instr, recips):
    """K3's least time (ms): the larger of the bytes over HBM's rate and
    the pipes' time. ``fma_instr`` FMA-pipe instructions must run; each of
    ``recips`` reciprocals runs either as one special-function op or as
    NEWTON_RCP_FMA FMA-pipe instructions, and the pipes run at once, so
    the least time shares the reciprocals out so that both finish
    together. Returns (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    # share f on the FMA pipe: (1 - f) R / S = (I + 6 f R) / F
    ratio = FMA_INSTR_S / SFU_OPS_S
    f = (recips * ratio - fma_instr) / (recips * (ratio + NEWTON_RCP_FMA))
    f = min(1.0, max(0.0, f))
    t_ops = max((1 - f) * recips / SFU_OPS_S,
                (fma_instr + NEWTON_RCP_FMA * f * recips) / FMA_INSTR_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_valid_of(gates, thresh):
    hit = gates > thresh
    first = hit.to(torch.int64).argmax(dim=0)
    return torch.where(hit.any(dim=0), first + 1, gates.shape[0])


def gate_stop(gates, t_min=N_FRAMES // 8):
    """A threshold at which one stream's gate (N,) first fires at a frame
    t >= t_min: the midpoint between the gate at t and the largest gate
    before t, for the first t from t_min on whose gate tops every earlier
    one by 1e-3 (else the last such t). Returns (threshold, t + 1), the
    n_valid that threshold gives."""
    g = gates.double().cpu()
    before = torch.cummax(g, 0).values
    rises = [t for t in range(1, len(g) - 1) if g[t] > before[t - 1] + 1e-3]
    check(rises, "the gate never rises above its first frame")
    t = next((t for t in rises if t >= t_min), rises[-1])
    return float(g[t] + before[t - 1]) / 2, t + 1


def pad_ids(ids):
    lens = torch.tensor([len(x) for x in ids])
    text = torch.zeros(len(ids), int(lens.max()), dtype=torch.long)
    for b, x in enumerate(ids):
        text[b, :len(x)] = torch.as_tensor(x)
    return text, lens


def perturb_flow_heads(model, g):
    """The flows' coupling heads start at zero, which would make mel == z
    and leave every layer before them without a gradient; 0.05 * normal
    (drawn from ``g``) makes them matter."""
    with torch.no_grad():
        for flow in model.flows:
            step = getattr(flow, "ar_step", flow)
            step.conv.weight.copy_(0.05 * torch.randn(
                step.conv.weight.shape, generator=g))


def perturb_heads(model, wg, seed):
    """As ``perturb_flow_heads``, then WaveGlow's zero-init ``end`` convs,
    so audio depends on the WN stack."""
    g = torch.Generator().manual_seed(seed)
    perturb_flow_heads(model, g)
    with torch.no_grad():
        for wn in wg.WN:
            wn.end.weight.copy_(0.05 * torch.randn(wn.end.weight.shape,
                                                   generator=g))


def k1_case(model, cfg, flow, sid, text, in_lens, res, n_valid_in, dev):
    """One flow's K1 against its plain version on the card, with and
    without early exit. The gated flow's early exit stops where its gate
    fires; the ungated flow's where ``n_valid_in`` says, as on the main
    path. Returns the fields to print and the early run's n_valid."""
    from flowtron_tpu_torch.models.attention import attention_precompute
    from flowtron_tpu_torch.models.flowtron import _encode_text
    from flowtron_tpu_torch.ops.decoder import (
        fused_flow_infer, fused_flow_infer_reference, k1_launch_info,
        k1_stage_split)

    B, Tk = text.shape
    mask = None if in_lens is None else \
        (torch.arange(Tk)[None] < in_lens[:, None]).to(dev)
    with torch.no_grad():
        enc = _encode_text(model, cfg, torch.full((B,), sid, device=dev),
                           text.to(dev), mask)
        kp, vals = attention_precompute(flow.attention_layer, enc, enc)
    km = (torch.ones(B, Tk, device=dev) if mask is None
          else mask.to(torch.float32)).contiguous()
    args = (flow.packed_weights(), res.to(dev).contiguous(), kp, vals, km,
            1.0)
    gated = hasattr(flow, "gate_layer")
    k_ms, p_ms, runs, out_k, out_p = paired_ms(
        lambda: fused_flow_infer(*args),
        lambda: fused_flow_infer_reference(*args), reps=3)
    errs = [float((a - b).abs().max()) for a, b in zip(out_k, out_p)]
    nv_k, nv_p = n_valid_of(out_k[2], 0.5), n_valid_of(out_p[2], 0.5)
    tag = f"K1 {'gated' if gated else 'ungated'} B={B} Tk={Tk}"
    check(all(torch.equal(a, b) for a, b in zip(out_k, fused_flow_infer(
        *args))), f"{tag}: two calls differ")
    check(all(math.isfinite(e) for e in errs), f"{tag} not finite")
    check(max(errs) <= K1_TOL, f"{tag} mel/attn/gate err {errs}")
    check(torch.equal(nv_k, nv_p), f"{tag} n_valid {nv_k} {nv_p}")

    if gated:
        # a threshold that every stream crosses in the first half, so the
        # later frames are skipped
        thresh = float(out_p[2][:N_FRAMES // 2].max(dim=0).values.min()) \
            - 1e-4
        expect = n_valid_of(out_p[2], thresh)
    else:
        thresh = 1e6                          # the gate is 0: never fires
        expect = n_valid_in.to(dev)
    e_args = args + (True, thresh, n_valid_in)
    ke_ms, out_ke = cuda_ms(lambda: fused_flow_infer(*e_args), reps=3)
    out_pe = fused_flow_infer_reference(*e_args)
    check(all(torch.equal(a, b) for a, b in zip(out_ke, fused_flow_infer(
        *e_args))), f"{tag} early: two calls differ")
    errs_e = [float((a - b).abs().max()) for a, b in zip(out_ke, out_pe)]
    if gated:
        nv_ke = n_valid_of(out_ke[2], thresh)
        check(torch.equal(nv_ke, expect),
              f"{tag} early n_valid {nv_ke} {expect}")
    check(max(errs_e) <= K1_TOL and not any(
        bool(o.isnan().any()) for o in out_ke), f"{tag} early {errs_e}")
    stop = int(expect.max())
    check(bool((out_ke[0][stop:] == 0).all())
          and bool((out_ke[1][stop:] == 0).all())
          and bool((out_ke[2][stop:] == 1).all()),
          f"{tag} early: skipped frames not mel=0, attn=0, gate=1")
    w = args[0]
    n_w = sum(t.numel() for v in w.values()
              for t in ([v] if torch.is_tensor(v) else
                        [x for pair in v for x in pair]))
    fields = dict(gated=gated, B=B, N=N_FRAMES, Tk=Tk,
                  key_mask=in_lens is not None, max_abs_err_mel=errs[0],
                  max_abs_err_attn=errs[1], max_abs_err_gate=errs[2],
                  n_valid=nv_k.tolist(), kernel_ms=k_ms, plain_ms=p_ms,
                  runs_plain_kernel_kernel_plain_ms=runs,
                  kernel_us_per_frame=1e3 * k_ms / N_FRAMES,
                  early_threshold=thresh, early_n_valid=expect.tolist(),
                  early_kernel_ms=ke_ms, early_max_abs_err=max(errs_e),
                  # the packed weights streamed once a frame from HBM
                  streamed_floor_us_per_frame=4 * n_w / HBM_BYTES_S * 1e6,
                  stage_us_per_frame=k1_stage_split(*args),
                  **k1_launch_info(w, B, Tk, dev))
    return fields, max(errs + errs_e), out_k[2], expect


def k1_bound(weights, N, B, Tk, D, M=80):
    """K1's floor for one flow over N frames: the packed weights, latents,
    keys, values and key mask read once, mel, attention and gates written
    once, fp32; per frame and stream 2 operations per weight element and
    6 per (text position, attention channel) of the attention."""
    from flowtron_tpu_torch.ops.decoder import _with_matrices

    tensors = [t for v in _with_matrices(weights).values()
               for t in ([v] if torch.is_tensor(v) else
                         [x for pair in v for x in pair])]
    n_w = sum(t.numel() for t in tensors)
    n_bytes = 4 * (n_w + 2 * N * B * M + 2 * B * Tk * D + B * Tk
                   + N * B * Tk + N * B)
    return bound(n_bytes, N * B * (2 * n_w + 6 * Tk * D))


def phase_k1(model, cfg, ids, sid, dev):
    """K1 on the card: the grid barrier's cost, the gated last flow (run
    first on the main path) at Tk=128 and B=1, 4 and 12, then both flows
    at the main path's own shapes: the first request's text at B=1 with
    the latents that request draws, and the four texts padded with their
    key mask at B=4. The ungated flow gets the gated flow's early n_valid,
    as on the main path. Returns the max
    error, the gated flow's B=1 request-shape times, and the threshold
    and n_valid at which the first request's gate stops it, and the gated
    flow's B=1 frames split by stage (for ``p5_split``)."""
    gated, ungated = model.flows[-1].ar_step, model.flows[0]
    g = torch.Generator().manual_seed(11)
    rand_text = torch.randint(1, 185, (4, TK), generator=g)
    batch_text, batch_lens = pad_ids(ids)
    # synthesize's latents, flipped as the backward (gated) flow sees them
    z_req = SIGMA * torch.randn(1, 80, N_FRAMES, generator=torch.Generator()
                                .manual_seed(REQ_SEED))
    rand12 = torch.randint(1, 185, (12, TK), generator=g)
    cases = [
        ("random_text", rand_text[:1], None,
         0.5 * torch.randn(N_FRAMES, 1, 80, generator=g)),
        ("random_text", rand_text, torch.tensor([TK, 100, 77, 50]),
         0.5 * torch.randn(N_FRAMES, 4, 80, generator=g)),
        # two groups of 8 batch rows
        ("random_text", rand12, torch.randint(TK // 4, TK + 1, (12,),
                                              generator=g),
         0.5 * torch.randn(N_FRAMES, 12, 80, generator=g)),
        ("request", batch_text[:1, :len(ids[0])], None,
         z_req.permute(2, 0, 1).flip(0)),
        ("batch", batch_text, batch_lens,
         0.5 * torch.randn(N_FRAMES, 4, 80, generator=g)),
    ]
    from flowtron_tpu_torch.ops.decoder import barrier_bench

    # one grid barrier of K1 (and of cooperative_groups, its yardstick):
    # 5000 in one launch after a warm-up launch
    barrier = {}
    for mode, name in ((0, "barrier_us"), (1, "barrier_cg_us")):
        barrier_bench(mode, 100, dev)
        ms, _ = cuda_ms(lambda: barrier_bench(mode, 5000, dev))
        barrier[name] = 1e3 * ms / 5000
    emit("k1_barrier", **barrier)
    max_err, times, stop, frames = 0.0, None, None, {}
    for shape, text, in_lens, res in cases:
        flows = [gated] if shape == "random_text" else [gated, ungated]
        nv_in = None
        for flow in flows:
            fields, err, gates, nv_in = k1_case(
                model, cfg, flow, sid, text, in_lens, res, nv_in, dev)
            max_err = max(max_err, err)
            emit("k1", shape=shape, **fields, **barrier)
            if fields["B"] == 1 and flow is gated:
                frames[f"{shape} Tk={fields['Tk']}"] = dict(
                    stage_us_per_frame=fields["stage_us_per_frame"],
                    weight_bytes=fields["streamed_floor_us_per_frame"]
                    * HBM_BYTES_S / 1e6)
            if shape == "request" and flow is gated:
                times = (fields["kernel_ms"], fields["plain_ms"]) + k1_bound(
                    flow.packed_weights(), N_FRAMES, 1, text.shape[1],
                    flow.attention_layer.query.linear_layer.weight.shape[0])
                stop = gate_stop(gates[:, 0])
    return max_err, times, stop, frames


def k2_work(B, Tp, C, n_rs):
    """A WN layer's fp32 FLOPs and bytes: x, cond, weights and biases read
    once, x' (not on the last layer) and skip written once."""
    flops = 2 * B * Tp * (3 * C * 2 * C + C * n_rs)
    n_bytes = 4 * (B * Tp * C + B * Tp * 2 * C + 3 * C * 2 * C + 2 * C
                   + C * n_rs + n_rs + (2 if n_rs > C else 1) * B * Tp * C)
    return flops, n_bytes


def k2_case(args, layer, T, reps, sms):
    """K2 against its plain version on one layer's arguments (x with Tp -
    T pad rows), in turns: within K2_TOL of the output scale, pad rows
    zero, two calls bitwise equal; emits a ``k2`` line. Returns the max
    abs error and (ms, plain ms, bound ms, bound_by, rows a block)."""
    from flowtron_tpu_torch.ops.wavenet import (
        wn_layer, wn_layer_reference, wn_plan)

    B, Tp, C = args[0].shape
    n_rs = args[5].shape[1]
    with torch.no_grad():
        k_ms, p_ms, runs, out_k, out_p = paired_ms(
            lambda: wn_layer(*args), lambda: wn_layer_reference(*args),
            reps=reps, plain_reps=reps)
        again = wn_layer(*args)
    abs_errs, errs = [], []
    for a, r in zip(out_k, out_p):
        if r is not None:
            abs_errs.append(float((a - r).abs().max()))
            errs.append(abs_errs[-1] / max(1.0, float(r.abs().max())))
    check(all(e <= K2_TOL for e in errs),
          f"K2 C={C} layer {layer} B={B} Tp={Tp} err {errs}")
    bitwise = all(a is None or torch.equal(a, b)
                  for a, b in zip(out_k, again))
    check(bitwise, f"K2 C={C} layer {layer} B={B}: two calls differ")
    if out_k[0] is not None and Tp > T:
        check(bool((out_k[0][:, T:] == 0).all()), "K2 pad rows not zero")
    flops, n_bytes = k2_work(B, Tp, C, n_rs)
    # the kernel does the fp32 products as three bf16 passes
    bound_ms, bound_by = bound(n_bytes, {"bf16": 3 * flops})
    plan = wn_plan(B, Tp, C, sms)
    emit("k2", layer=layer, d=args[1], last=out_k[0] is None, C=C, B=B,
         T=T, Tp=Tp, plan=plan._asdict(), max_abs_err=max(abs_errs),
         max_rel_err=max(errs), bitwise=bitwise, kernel_ms=k_ms,
         plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by,
         runs_plain_kernel_kernel_plain_ms=runs,
         kernel_tflops_fp32=flops / k_ms / 1e9,
         kernel_tflops_bf16=3 * flops / k_ms / 1e9,
         plain_tflops=flops / p_ms / 1e9)
    return max(abs_errs), (k_ms, p_ms, bound_ms, bound_by, plan.bm)


def k2_builds(args, reps, sms):
    """Every build of the width, rows a block, on one layer's arguments in
    turns, each bitwise equal to the planned one; emits a ``k2_bm`` line
    with each build's ms and its row's time in a full wave, against the
    width's first build (what ops/wavenet.py:WN_ROW_COST records)."""
    from flowtron_tpu_torch.ops.wavenet import WN_BUILDS, wn_layer, wn_plan

    B, T, C = args[0].shape
    builds = list(WN_BUILDS[C])
    with torch.no_grad():
        ref = wn_layer(*args)
        fns = [lambda bm=bm: wn_layer(*args, bm=bm) for bm in builds]
        for f in fns:
            f()
        ms = {bm: [] for bm in builds}
        for _ in range(3):
            for bm, f in list(zip(builds, fns)) + list(
                    zip(builds, fns))[::-1]:
                ms[bm].append(cuda_ms(f, reps)[0])
        for bm, f in zip(builds, fns):
            check(all(torch.equal(a, b) for a, b in zip(f(), ref)),
                  f"K2 C={C} bm={bm} differs from the planned bm")
    med = {bm: statistics.median(v) for bm, v in ms.items()}
    plans = {bm: wn_plan(B, T, C, sms, bm) for bm in builds}
    row_us = {bm: 1e3 * med[bm] / (-(-plans[bm].grid // sms) * bm)
              for bm in builds}
    emit("k2_bm", B=B, T=T, C=C, planned=wn_plan(B, T, C, sms).bm, ms=med,
         row_us=row_us,
         row_cost={bm: row_us[bm] / row_us[builds[0]] for bm in builds},
         plans={bm: p._asdict() for bm, p in plans.items()})


# phase_k2's cases: (layer, B, Tp) at T = 12800, in the order their
# inputs are drawn
K2_CASES = ((0, 1, 12800), (3, 1, 12800), (7, 1, 12800), (3, 1, 12896),
            (3, 8, 12800))


def k2_layer_args(wn, g, layer, B, Tp, T, dev):
    """One WN layer's fp32 arguments at the vocoder's weights: x (B, Tp, C)
    from ``g``, zero on pad rows, and a cond slice of the all-layer
    conditioning (row stride 2CL), drawn after it."""
    C, L = wn.n_channels, wn.n_layers
    w_cat, b, w_rs, b_rs = wn.packed_layers()[layer]
    x = torch.randn(B, Tp, C, generator=g)
    x[:, T:] = 0
    cond_all = torch.randn(B, Tp, 2 * C * L, generator=g).to(dev)
    cond = cond_all[..., 2 * C * layer:2 * C * (layer + 1)]
    return (x.to(dev), 2 ** layer, cond, w_cat, b, w_rs, b_rs, T)


def k2_fp32_sha256(wg, dev):
    """The fp32 body's outputs (x' then skip, their bytes) hashed at
    phase_k2's cases, on the same inputs: one sha256 a case."""
    import hashlib

    from flowtron_tpu_torch.ops.wavenet import wn_layer

    g = torch.Generator().manual_seed(12)
    out = {}
    with torch.no_grad():
        for layer, B, Tp in K2_CASES:
            h = hashlib.sha256()
            for t in wn_layer(*k2_layer_args(wg.WN[0], g, layer, B, Tp,
                                             N_FRAMES * HOP // 8, dev)):
                if t is not None:
                    h.update(t.contiguous().cpu().view(torch.uint8)
                             .numpy().tobytes())
            out[f"layer{layer}_B{B}_Tp{Tp}"] = h.hexdigest()
    return out


def phase_k2(wg, dev):
    """K2 against its plain version at the vocoder's shapes: layers 0, 3
    and 7 (d = 1, 8, 128; 7 the last) at B=1, T=12800 (400 mel frames),
    layer 3 with 96 pad rows, and layer 3 at B=8 (the server's largest
    batch). Then every block size built for C=256 at B=1 and B=8. Returns
    the max error and (ms, plain ms, bound, bound_by, rows a block) of
    layer 3 at B=1."""
    wn = wg.WN[0]
    T = N_FRAMES * HOP // 8                   # 12800 grouped samples
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(12)

    def layer_args(layer, B, Tp):
        return k2_layer_args(wn, g, layer, B, Tp, T, dev)

    max_err, times = 0.0, None
    for layer, B, Tp in K2_CASES:
        err, case = k2_case(layer_args(layer, B, Tp), layer, T,
                            20 if B == 1 else 5, sms)
        max_err = max(max_err, err)
        if (layer, B, Tp) == (3, 1, T):
            times = case
    for B in (1, 8):
        k2_builds(layer_args(3, B, T), 20 if B == 1 else 5, sms)
    return max_err, times


def phase_k2_wide(dev):
    """K2's wide builds against the plain version at the vocoder's shapes,
    on init-scaled random weights: for C = 512 and 1024, a middle layer
    (layer 3, d = 8) and the last (layer 7, d = 128) at B=1, T=12800, and
    layer 3 at B=8, cond a strided slice. Then each build of the width at
    B=1 and B=8. Returns {C: (max abs err, ms, plain ms, bound ms,
    bound_by, rows a block)} of layer 3 at B=1."""
    T = N_FRAMES * HOP // 8
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(31)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device=dev)

    out = {}
    for C in K2_WIDE:
        def layer_args(layer, B):
            n_rs = C if layer == 7 else 2 * C
            cond = rand(B, T, 4 * C)[..., 2 * C:]          # row stride 4C
            return (rand(B, T, C), 2 ** layer, cond,
                    rand(3 * C, 2 * C, scale=(3 * C) ** -0.5),
                    rand(2 * C, scale=0.1), rand(C, n_rs, scale=C ** -0.5),
                    rand(n_rs, scale=0.1), T)

        max_err, times = 0.0, None
        for layer, B in ((3, 1), (7, 1), (3, 8)):
            err, case = k2_case(layer_args(layer, B), layer, T,
                                10 if B == 1 else 2, sms)
            max_err = max(max_err, err)
            if (layer, B) == (3, 1):
                times = case
        out[C] = (max_err,) + times
        for B in (1, 8):
            k2_builds(layer_args(3, B), 5 if B == 1 else 2, sms)
        torch.cuda.empty_cache()
    return out


def phase_waveglow_split(wg, wg_cfg, dev):
    """Device time of one B=1 waveglow_infer_z at N_FRAMES, by CUDA events
    around each of its parts: K2's 96 layers, the 12 cond_layer products,
    the upsample, and the rest (start/end convs, couplings, inverse 1x1s
    and any gaps)."""
    from flowtron_tpu_torch.vocoder import waveglow as wgm

    g = torch.Generator().manual_seed(21)
    Tg = N_FRAMES * HOP // wg_cfg["n_group"]
    mel = torch.randn(1, wg_cfg["n_mel_channels"], N_FRAMES,
                      generator=g).to(dev)
    z_main = (0.8 * torch.randn(1, wgm.waveglow_n_remaining(wg_cfg), Tg,
                                generator=g)).to(dev)
    z_early = [(0.8 * torch.randn(1, wg_cfg["n_early_size"], Tg,
                                  generator=g)).to(dev)
               if f % wg_cfg["n_early_every"] == 0 and f > 0 else None
               for f in range(wg_cfg["n_flows"])]
    cond_layers = {id(wn.cond_layer) for wn in wg.WN}
    spans = {"k2": [], "cond_layer": [], "upsample": []}
    originals = {n: getattr(wgm, n)
                 for n in ("wn_layer", "_mm1x1", "_upsample_mel")}

    def timed(part, fn):
        def run(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **k)
            e.record()
            spans[part].append((s, e))
            return out
        return run

    wn_timed = timed("k2", originals["wn_layer"])
    mm_timed = timed("cond_layer", originals["_mm1x1"])
    wgm.wn_layer = wn_timed
    wgm._upsample_mel = timed("upsample", originals["_upsample_mel"])
    wgm._mm1x1 = lambda x, conv: (mm_timed if id(conv) in cond_layers
                                  else originals["_mm1x1"])(x, conv)
    try:
        for run in range(2):                  # a warm-up, then the timed run
            for v in spans.values():
                v.clear()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            audio = wgm.waveglow_infer_z(wg, wg_cfg, mel, z_main, z_early)
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for n, fn in originals.items():
            setattr(wgm, n, fn)
    check(tuple(audio.shape) == (1, N_FRAMES * HOP)
          and bool(torch.isfinite(audio).all()), "waveglow_split audio")
    total = start.elapsed_time(end)
    parts = {k: sum(s.elapsed_time(e) for s, e in v)
             for k, v in spans.items()}
    check(len(spans["k2"]) == wg_cfg["n_flows"] * wg.WN[0].n_layers
          and len(spans["cond_layer"]) == wg_cfg["n_flows"],
          f"waveglow_split counted {[len(v) for v in spans.values()]}")
    emit("waveglow_split", B=1, frames=N_FRAMES, total_ms=total, wall_s=wall,
         k2_ms=parts["k2"], k2_calls=len(spans["k2"]),
         cond_layer_ms=parts["cond_layer"],
         cond_layer_calls=len(spans["cond_layer"]),
         upsample_ms=parts["upsample"],
         rest_ms=total - sum(parts.values()))


def phase_slice(model, cfg, wg, wg_cfg, ids, sid, stop, dev):
    """The main path through infer/sampling.py: one request whose gate
    stops it early, then (gate biased off) three full requests and one
    B=4 batch."""
    from flowtron_tpu_torch.infer.sampling import text_to_audio
    from flowtron_tpu_torch.models.flowtron import flowtron_infer
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_infer

    text_to_audio(model, cfg, wg, wg_cfg, ids[0], sid, gate_threshold=1e6,
                  seed=0, fused="early")     # warm-up: cuBLAS/cuDNN setup
    torch.cuda.synchronize()
    # early exit end to end: the gate as drawn, at the threshold phase_k1
    # found for this request's text and latents
    thresh, n_expect = stop
    t0 = time.perf_counter()
    audio, _, _, n = text_to_audio(model, cfg, wg, wg_cfg, ids[0], sid,
                                   n_frames=N_FRAMES, sigma=SIGMA,
                                   gate_threshold=thresh, seed=REQ_SEED,
                                   fused="early")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(n == n_expect and n < N_FRAMES,
          f"early request n_valid {n}, expected {n_expect}")
    check(audio.shape == (n * HOP,), "early request audio shape")
    check(bool(torch.isfinite(torch.from_numpy(audio)).all()),
          "early request audio not finite")
    emit("slice_early_exit", text_len=len(ids[0]), gate_threshold=thresh,
         n_valid=n, audio_samples=int(audio.shape[0]), wall_s=wall)

    # random weights would end every utterance within its first frames;
    # a trained model stops at the end of its text. Bias the gate off so
    # the requests below synthesize the full N_FRAMES (the gate still runs).
    with torch.no_grad():
        model.flows[-1].ar_step.gate_layer.linear_layer.bias.fill_(-20.0)
    model.flows[-1].ar_step.packed_weights()   # repack outside the timing
    requests = []
    for i in range(3):
        t0 = time.perf_counter()
        audio, _, _, n = text_to_audio(model, cfg, wg, wg_cfg, ids[i], sid,
                                       n_frames=N_FRAMES, sigma=SIGMA,
                                       seed=REQ_SEED + i, fused="early")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(audio.shape == (n * HOP,) and n > 0, f"request {i} shape")
        check(bool(torch.isfinite(torch.from_numpy(audio)).all()),
              f"request {i} audio not finite")
        requests.append({"text_len": len(ids[i]), "n_valid": n,
                         "wall_s": wall, "mel_frames_per_s": n / wall,
                         "rtf": wall / (n * HOP / SR)})
    emit("slice_requests", requests=requests)

    B = len(ids)
    text, lens = pad_ids(ids)
    g = torch.Generator().manual_seed(7)
    residual = (SIGMA * torch.randn(B, 80, N_FRAMES, generator=g)).to(dev)
    t0 = time.perf_counter()
    mel, attns, n_valid = flowtron_infer(
        model, cfg, residual, torch.full((B,), sid, device=dev),
        text.to(dev), gate_threshold=0.5, in_lens=lens.to(dev),
        fused="early")
    audio = waveglow_infer(wg, wg_cfg, mel, sigma=0.8, seed=7)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(tuple(audio.shape) == (B, N_FRAMES * HOP), "batch audio shape")
    check(bool(torch.isfinite(audio).all()), "batch audio not finite")
    emit("slice_batch", B=B, text_lens=lens.tolist(),
         n_valid=n_valid.tolist(), wall_s=wall)


def phase_cpu_agreement(model, cfg, wg, wg_cfg, dev):
    """The same slice at flagship widths on a short input: kernels on the
    card against the plain path on the CPU."""
    from flowtron_tpu_torch.models.flowtron import flowtron_infer
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_infer_z

    N, B = 24, 2
    g = torch.Generator().manual_seed(5)
    residual = 0.5 * torch.randn(B, 80, N, generator=g)
    text = torch.randint(1, 185, (B, 20), generator=g)
    in_lens = torch.tensor([20, 13])
    sids = torch.zeros(B, dtype=torch.long)
    z_main = 0.8 * torch.randn(B, 4, N * HOP // 8, generator=g)
    z_early = [0.8 * torch.randn(B, 2, N * HOP // 8, generator=g)
               if f % 4 == 0 and f > 0 else None for f in range(12)]
    outs = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        model.to(d), wg.to(d)
        mel, _, nv = flowtron_infer(model, cfg, residual.to(d), sids.to(d),
                                    text.to(d), gate_threshold=0.5,
                                    in_lens=in_lens.to(d))
        audio = waveglow_infer_z(wg, wg_cfg, mel, z_main.to(d),
                                 [z if z is None else z.to(d)
                                  for z in z_early])
        outs[where] = (mel.cpu(), nv.cpu(), audio.cpu())
    model.to(dev), wg.to(dev)
    mel_err = float((outs["card"][0] - outs["cpu"][0]).abs().max())
    audio_err = float((outs["card"][2] - outs["cpu"][2]).abs().max()) \
        / max(1.0, float(outs["cpu"][2].abs().max()))
    check(torch.equal(outs["card"][1], outs["cpu"][1]), "slice n_valid")
    check(mel_err <= SLICE_TOL and audio_err <= SLICE_TOL,
          f"slice card vs cpu: mel {mel_err} audio {audio_err}")
    emit("slice_vs_cpu", N=N, B=B, n_valid=outs["cpu"][1].tolist(),
         max_abs_err_mel=mel_err, max_rel_err_audio=audio_err)


def k4_case(M, K, N, a8, g, side, dev):
    """K4 against its plain version on the card at (M, K, N), with the
    fp32 cuBLAS product on the pre-dequantized weight as the library
    yardstick, all three timed as device time in CUDA graphs (one call
    takes microseconds, less than Python needs to launch it); the eager
    call's time, host dispatch included, beside them. Returns the fields
    to print."""
    from flowtron_tpu_torch.infer.quantize import _quantize_matrix
    from flowtron_tpu_torch.ops.qmm import (
        quantized_matmul, quantized_matmul_reference)

    leaf = _quantize_matrix(0.05 * torch.randn(N, K, generator=g), a8=a8)
    x = torch.randn(M, K, generator=g).to(dev)
    q, s = leaf.q.to(dev), leaf.s.to(dev)
    w = q.float() * s[:, None]
    (k_ms, p_ms, lib_ms), (out_k, out_p, _), _ = graph_times([
        lambda: quantized_matmul(x, q, s, a8=a8),
        lambda: quantized_matmul_reference(x, q, s, a8=a8),
        lambda: torch.nn.functional.linear(x, w)], side)
    # the same call launched from Python, as the per-frame loop does
    eager_ms, out_e = cuda_ms(lambda: quantized_matmul(x, q, s, a8=a8),
                              reps=20)
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    tag = f"K4 {'w8a8' if a8 else 'w8'} M={M} K={K} N={N}"
    check(math.isfinite(err), f"{tag} not finite")
    check(torch.equal(out_e, out_k), f"{tag} not bitwise repeatable")
    if a8:
        check(torch.equal(out_k, out_p), f"{tag} not bitwise: err {err}")
    else:
        check(err <= K4_W8_TOL * scale, f"{tag} err {err} scale {scale}")
    n_bytes = 4 * M * K + N * K + 4 * N + 4 * M * N
    # W8A8's products on the int8 tensor cores; weight-only runs each
    # product twice on the tf32 ones (x split into hi and lo)
    ops = {"int8": 2 * M * K * N} if a8 else {"tf32": 2 * 2 * M * K * N}
    bound_ms, bound_by = bound(n_bytes, ops)
    return dict(body="w8a8" if a8 else "w8", M=M, K=K, N=N,
                max_abs_err=err, scale=scale, kernel_ms=k_ms, plain_ms=p_ms,
                library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by,
                eager_call_ms=eager_ms)


def phase_k4(dev):
    """K4's two bodies against their plain versions at every (K, N) of the
    flagship path, M in {1, 8, 64}, and one unaligned shape. Returns, per
    body, the max error and one flow-frame's nine calls at M = 8 summed:
    (kernel ms, plain ms, bound ms, bound_by, library ms)."""
    g = torch.Generator().manual_seed(14)
    side = torch.cuda.Stream()
    table = {}
    for a8 in (True, False):
        cases, max_err = {}, 0.0
        for (K, N) in K4_KN:
            for M in (1, 8, 64):
                cases[M, K, N] = k4_case(M, K, N, a8, g, side, dev)
        cases[3, 100, 200] = k4_case(3, 100, 200, a8, g, side, dev)
        for f in cases.values():
            max_err = max(max_err, f["max_abs_err"])
            emit("k4", **f)
        frame = [cases[8, K, N] for K, N in K4_FRAME_KN]
        sums = {k: sum(f[k] for f in frame)
                for k in ("kernel_ms", "plain_ms", "bound_ms", "library_ms",
                          "eager_call_ms")}
        by = "bytes" if all(f["bound_by"] == "bytes" for f in frame) \
            else "operations"
        emit("k4_flow_frame", body="w8a8" if a8 else "w8", M=8,
             calls=len(frame), **sums, bound_by=by)
        table["w8a8" if a8 else "w8"] = (
            max_err, sums["kernel_ms"], sums["plain_ms"], sums["bound_ms"],
            by, sums["library_ms"])
    return table


def post_wav(url, body):
    """POST /synthesize; returns (status, wall seconds, sample rate,
    samples, peak |sample|)."""
    req = urllib.request.Request(url + "/synthesize",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        status, data = r.status, r.read()
    wall = time.perf_counter() - t0
    with wave.open(io.BytesIO(data)) as w:
        rate, n = w.getframerate(), w.getnframes()
        pcm = torch.frombuffer(bytearray(w.readframes(n)), dtype=torch.int16)
    return status, wall, rate, n, int(pcm.abs().max()) if n else 0


def wave_of(url, bodies):
    """Send every body at once, each from its own thread; returns the
    results in order and the wall time of the whole wave."""
    out = [None] * len(bodies)
    errors = []

    def run(i):
        try:
            out[i] = post_wav(url, bodies[i])
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not errors and all(o is not None for o in out),
          f"requests failed: {errors}")
    return out, time.perf_counter() - t0


def get_json(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return json.loads(r.read())


def check_answers(tag, bodies, results, n_frames):
    for body, (status, _, rate, n, peak) in zip(bodies, results):
        cap = min(body.get("n_frames", n_frames), n_frames)
        check(status == 200 and rate == SR, f"{tag}: status {status} rate "
              f"{rate}")
        check(n % HOP == 0 and 0 < n <= cap * HOP,
              f"{tag}: {n} samples for a cap of {cap} frames")
        check(peak > 0, f"{tag}: silent answer")


def phase_serve(ft_path, wg_path, kernels, quantize, bf16=False):
    """The batch-serving path: the port's HTTP server built in-process by
    serve/cli.py:build_server (--warmup, and --bf16 with ``bf16``), then 8
    concurrent requests (the four texts x 2 seeds) with one capped at 120
    frames alongside, SERVE_WAVES times (the first wave's launches
    counted, every wave's requests/s kept), then a wave of 4 with mixed
    temperatures. Returns the launches of the first main wave and of the
    mixed wave."""
    from flowtron_tpu_torch.serve.cli import build_server

    argv = ["-c", "config.json", "-f", ft_path, "-w", wg_path, "--port",
            "0", "--warmup"] + (["--quantize", quantize] if quantize else []) \
        + (["--bf16"] if bf16 else [])
    tag = f"serve {quantize or 'float'} {'bf16' if bf16 else 'fp32'}"
    t0 = time.perf_counter()
    server, engines = build_server(argv, host="127.0.0.1")
    start_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        get_json(url, "/healthz")   # the first request's one-time imports
        bodies = [{"text": t, "seed": REQ_SEED + k}
                  for k in range(2) for t in TEXTS]
        bodies.append({"text": TEXTS[3], "seed": REQ_SEED + 9,
                       "n_frames": 120})
        torch.cuda.synchronize()
        reset_launches(kernels)
        results, wall = wave_of(url, bodies)
        torch.cuda.synchronize()
        main_launches = read_launches(kernels)
        check_answers(tag, bodies, results, N_FRAMES)
        walls = [wall]
        for _ in range(SERVE_WAVES - 1):
            again, w = wave_of(url, bodies)
            check_answers(tag, bodies, again, N_FRAMES)
            walls.append(w)
        metrics = get_json(url, "/metrics")
        check(metrics["batches"] < metrics["requests"],
              f"{tag}: no micro-batching {metrics}")
        mixed = [{"text": TEXTS[i], "seed": REQ_SEED + 20 + i,
                  "temperature": 0.7 + 0.2 * i} for i in range(4)]
        torch.cuda.synchronize()
        reset_launches(kernels)
        mixed_results, mixed_wall = wave_of(url, mixed)
        torch.cuda.synchronize()
        mixed_launches = read_launches(kernels)
        check_answers(tag + " mixed", mixed, mixed_results, N_FRAMES)
        metrics = get_json(url, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        for eng in engines.values():
            eng.shutdown()
        torch.cuda.empty_cache()
    audio_s = [n / SR for _, _, _, n, _ in results]
    rps = [len(bodies) / w for w in walls]
    SERVE_RPS[quantize or "float", "bf16" if bf16 else "fp32"] = rps
    emit("serve", quantize=quantize or None, bf16=bf16,
         build_and_warmup_s=start_s,
         requests=len(bodies), wall_s=wall, requests_per_s=len(bodies) / wall,
         waves_requests_per_s=rps,
         requests_per_s_median=statistics.median(rps),
         latency_s=[r[1] for r in results],
         rtf=[r[1] / a for r, a in zip(results, audio_s)],
         audio_s=audio_s, mixed_wall_s=mixed_wall,
         mixed_latency_s=[r[1] for r in mixed_results],
         batches=metrics["batches"], served=metrics["requests"],
         batch_ms_p50=metrics.get("batch_ms_p50"),
         batch_ms_p90=metrics.get("batch_ms_p90"),
         launches=main_launches, mixed_launches=mixed_launches)
    return main_launches, mixed_launches


def quant_inputs(N=24, B=2):
    """phase_quant_vs_cpu's latents, speaker ids, text and text lengths
    (tests/test_torch_port_quant_flagship.py runs the JAX package on the
    same)."""
    g = torch.Generator().manual_seed(6)
    residual = 0.5 * torch.randn(B, 80, N, generator=g)
    text = torch.randint(1, 185, (B, 20), generator=g)
    return residual, torch.zeros(B, dtype=torch.long), text, \
        torch.tensor([20, 13])


def phase_quant_vs_cpu(model, cfg, dev):
    """The three quantized modes at flagship width on a short input: the
    card (K4 for w8a8, the per-frame loop for all) against the CPU plain
    path, and each mode's mel against the unquantized one."""
    from flowtron_tpu_torch.infer.quantize import quantize_flows_for_inference
    from flowtron_tpu_torch.models.flowtron import flowtron_infer

    residual, sids, text, in_lens = quant_inputs()
    B, _, N = residual.shape
    cpu = torch.device("cpu")

    def run(m, d):
        return flowtron_infer(m.to(d), cfg, residual.to(d), sids.to(d),
                              text.to(d), gate_threshold=1e6,
                              in_lens=in_lens.to(d))[0].cpu()

    mel_fp = run(model, cpu)
    model.to(dev)
    scale = float(mel_fp.abs().mean())
    out = {}
    for mode in ("w8", "w8a8", "w4"):
        q = quantize_flows_for_inference(model, mode=mode)
        mel_card = run(q, dev)
        mel_cpu = run(q, cpu)
        del q
        err = float((mel_card - mel_cpu).abs().max())
        quality = float((mel_cpu - mel_fp).abs().mean()) / scale
        check(err <= QUANT_TOL[mode], f"{mode} card vs cpu mel err {err}")
        check(quality < QUALITY_BAR[mode], f"{mode} quality {quality}")
        out[mode] = {"max_abs_err_card_vs_cpu": err,
                     "mae_over_fp32_scale": quality}
    torch.cuda.empty_cache()
    emit("quant_vs_cpu", N=N, B=B, fp32_scale=scale, **out)


def rel_err(a, ref):
    """max |a - ref| over ref's largest magnitude, on the host in fp64."""
    a = torch.as_tensor(a).detach().cpu().double()
    ref = torch.as_tensor(ref).detach().cpu().double()
    check(a.shape == ref.shape, f"shapes {tuple(a.shape)} {tuple(ref.shape)}")
    return float((a - ref).abs().max()) / max(1e-12, float(ref.abs().max()))


def phase_stft(wg, wg_cfg, kernels, dev):
    """The audio tail on the card against the CPU on 400 frames of audio:
    ``MelSpectrogram.magnitude``, ``InverseSTFT`` and ``griffin_lim`` from
    the same initial phases; the ``Denoiser`` (its bias pass is a vocoder
    pass: K2 on the card) and its output; then the host
    ``StreamingDenoiser``'s chunks against the card's ``Denoiser``. Each
    within STFT_TOL of its scale. Returns the launches of the card's
    denoiser set-up and call."""
    import copy

    from flowtron_tpu_torch.audio.griffin_lim import InverseSTFT, griffin_lim
    from flowtron_tpu_torch.audio.stft import MelSpectrogram
    from flowtron_tpu_torch.vocoder.denoiser import (
        Denoiser, StreamingDenoiser)

    g = torch.Generator().manual_seed(31)
    T = N_FRAMES * HOP
    t = torch.arange(T) / SR
    audio = (0.4 * torch.sin(2 * math.pi * 220 * t)
             + 0.1 * torch.randn(1, T, generator=g)).clamp(-1, 1)
    ms, istft = MelSpectrogram(), InverseSTFT()
    spec = ms.stft(audio)
    mag, phase = spec.abs(), spec.angle()
    angles = (torch.rand(mag.shape, generator=g) * 2 - 1) * math.pi
    cpu = torch.device("cpu")
    out, ms_card = {}, {}
    for where, d in (("card", dev), ("cpu", cpu)):
        x, m, p, a = (v.to(d) for v in (audio, mag, phase, angles))
        fns = {"magnitude": lambda: ms.magnitude(x),
               "istft": lambda: istft(m, p),
               "griffin_lim_8": lambda: griffin_lim(m, ms.stft, istft,
                                                    n_iters=8, angles=a)}
        for name, fn in fns.items():
            if where == "card":
                fn()
                ms_card[name], out[name, where] = cuda_ms(fn, 5)
            else:
                out[name, where] = fn()
    errs = {name: rel_err(out[name, "card"], out[name, "cpu"])
            for name in ms_card}
    check(all(e <= STFT_TOL for e in errs.values()), f"stft card vs cpu "
          f"{errs}")

    torch.cuda.synchronize()
    reset_launches(kernels)
    den = Denoiser(wg, wg_cfg)
    x = audio.to(dev)
    den(x, strength=0.1)
    den_ms, denoised = cuda_ms(lambda: den(x, strength=0.1), 5)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    den_cpu = Denoiser(copy.deepcopy(wg).cpu(), wg_cfg)
    errs["bias_spec"] = rel_err(den.bias_spec, den_cpu.bias_spec)
    errs["denoised"] = rel_err(denoised, den_cpu(audio, strength=0.1))
    sd = StreamingDenoiser(den, strength=0.1)
    step = STREAM["chunk_frames"] * HOP
    chunks = [sd.feed(audio[0, i:i + step].numpy())
              for i in range(0, T, step)] + [sd.flush()]
    errs["streaming_denoiser"] = rel_err(torch.from_numpy(
        np.concatenate(chunks))[None], denoised)
    check(float(den.bias_spec.abs().max()) > 0, "the bias spectrum is zero")
    check(all(e <= STFT_TOL for e in errs.values()),
          f"denoiser: {errs}")
    check(launches["wn_layer"] > 0 and launches["fused_flow_infer"] == 0,
          f"denoiser launches {launches}")
    emit("stft", frames=N_FRAMES, samples=T, rel_err=errs,
         card_ms=ms_card, denoise_ms=den_ms, launches=launches)
    return launches


def stream_once(model, cfg, wg, wg_cfg, text, sids, thresh, kernels):
    """One ``stream_tts`` (the first request's seed) with its launches
    counted; returns (chunks, the mel chunks the vocoder took, the window
    widths, ms to the first chunk, wall seconds, the seconds spent in the
    vocoder's ``push`` (its windows, synchronised by the copy to the
    host), launches)."""
    from flowtron_tpu_torch.infer import streaming as S

    seen, widths, push_s = [], [], []
    push, window_spec = S.StreamingVocoder.push, S.window_spec

    def push_spy(self, mel_chunk):
        seen.append(mel_chunk.clone())
        t0 = time.perf_counter()
        out = push(self, mel_chunk)
        push_s.append(time.perf_counter() - t0)
        return out

    def window_spy(*a, **k):
        w0, w1 = window_spec(*a, **k)
        widths.append(w1 - w0)
        return w0, w1

    S.StreamingVocoder.push, S.window_spec = push_spy, window_spy
    chunks, t_first = [], None
    try:
        torch.cuda.synchronize()
        reset_launches(kernels)
        t0 = time.perf_counter()
        for a in S.stream_tts(model, cfg, wg, wg_cfg, REQ_SEED, sids, text,
                              sigma=SIGMA, gate_threshold=thresh, **STREAM):
            if t_first is None:
                t_first = time.perf_counter() - t0
            chunks.append(a)
        wall = time.perf_counter() - t0
        launches = read_launches(kernels)
    finally:
        S.StreamingVocoder.push, S.window_spec = push, window_spec
    return chunks, seen, widths, 1e3 * t_first, wall, sum(push_s), launches


def phase_stream(model, cfg, wg, wg_cfg, ids, sid, stop, kernels, dev):
    """The streaming path: ``stream_tts`` at B=1 on the first request's
    text and, seeded alike, its latents; max 400 frames, chunks of 40,
    context 24, lookahead 16. Twice: the gate as drawn at the threshold
    phase_k1 found (it stops at the same frame), then at a threshold it
    never reaches (all 400 frames, the gate still runs). Each stream's mel
    against the offline ``flowtron_infer`` on the card (K1 on both flows;
    the stream runs flow 0 through the loop) within K1_TOL, its audio
    against one vocoder pass over that mel with the same positional
    latents within SEAM_TOL; then K2 at the widest window's shape against
    its plain version. Returns the full stream's launches."""
    from flowtron_tpu_torch.infer import streaming as S
    from flowtron_tpu_torch.models.flowtron import flowtron_infer
    from flowtron_tpu_torch.ops.wavenet import wn_layer, wn_layer_reference
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_infer_z

    text = torch.as_tensor(ids[0], device=dev)[None]
    sids = torch.tensor([sid], device=dev)
    for _ in S.stream_tts(model, cfg, wg, wg_cfg, REQ_SEED, sids, text,
                          **dict(STREAM, max_frames=80)):
        pass                                # warm-up: cuBLAS/cuDNN set-up
    ng = wg_cfg["n_group"]
    runs, all_widths = {}, set()
    for case, thresh, n_expect in (("gate", *stop), ("full", 1e6, N_FRAMES)):
        chunks, seen, widths, ttfa, wall, push_s, launches = stream_once(
            model, cfg, wg, wg_cfg, text, sids, thresh, kernels)
        audio = torch.from_numpy(np.concatenate(chunks, axis=1))
        mel = torch.cat(seen, dim=2)
        n = mel.shape[2]
        check(n == n_expect, f"stream {case}: n_valid {n}, expected "
              f"{n_expect}")
        check(tuple(audio.shape) == (1, n * HOP)
              and bool(torch.isfinite(audio).all()), f"stream {case} audio")
        check(launches["fused_flow_infer"] > 0 and launches["wn_layer"] > 0
              and launches["quantized_matmul_w8"] == 0
              and launches["quantized_matmul_w8a8"] == 0,
              f"stream {case} launches {launches}")
        g_mel, g_voc = S.stream_generators(REQ_SEED)
        residual = SIGMA * torch.randn(1, 80, N_FRAMES, generator=g_mel)
        mel_off, _, nv = flowtron_infer(model, cfg, residual.to(dev), sids,
                                        text, gate_threshold=thresh)
        mel_err = float((mel - mel_off[:, :, :n]).abs().max())
        check(int(nv[0]) == n and mel_err <= K1_TOL,
              f"stream {case} mel vs offline: n_valid {int(nv[0])}, err "
              f"{mel_err}")
        z_main, z_early = S.positional_z(
            g_voc, wg_cfg, 1, N_FRAMES * HOP // ng, 0.8, dev)(0, n * HOP // ng)
        seam = rel_err(audio, waveglow_infer_z(wg, wg_cfg, mel, z_main,
                                               z_early))
        check(seam <= SEAM_TOL, f"stream {case} audio vs one vocoder pass "
              f"{seam}")
        all_widths |= set(widths)
        runs[case] = dict(gate_threshold=thresh, n_valid=n, ttfa_ms=ttfa,
                          wall_s=wall, rtf=wall / (n * HOP / SR),
                          # the vocoder's pushes; the rest is the mel
                          # (encoder, prelude, flow 0's chunks) and the
                          # flush's window
                          push_s=push_s,
                          chunks=len(chunks), mel_chunks=len(seen),
                          window_frames=sorted(set(widths)),
                          windows=len(widths),
                          mel_max_abs_err_vs_offline=mel_err,
                          audio_rel_err_vs_offline=seam, launches=launches)

    # K2 at the widest window's shape (80 frames: 2560 rows), layer 3
    W = max(all_widths)
    Tp = W * HOP // ng
    wn = wg.WN[0]
    C = wn.n_channels
    gk = torch.Generator().manual_seed(33)
    w_cat, b, w_rs, b_rs = wn.packed_layers()[3]
    args = (torch.randn(1, Tp, C, generator=gk).to(dev), 8,
            torch.randn(1, Tp, 2 * C, generator=gk).to(dev), w_cat, b, w_rs,
            b_rs, Tp)
    with torch.no_grad():
        k_ms, p_ms, k2_runs, out_k, out_p = paired_ms(
            lambda: wn_layer(*args), lambda: wn_layer_reference(*args),
            reps=20, plain_reps=20)
    k2_err = max(rel_err(a, r) for a, r in zip(out_k, out_p))
    check(k2_err <= K2_TOL, f"K2 at the window shape: {k2_err}")
    emit("stream", B=1, text_len=len(ids[0]), **runs,
         k2_window=dict(W=W, Tp=Tp, C=C, layer=3, kernel_ms=k_ms,
                        plain_ms=p_ms, max_rel_err=k2_err,
                        runs_plain_kernel_kernel_plain_ms=k2_runs))
    return runs["full"]["launches"]


def read_stream(url, body):
    """POST /stream; returns (ms to the first PCM byte, the 44-byte
    header, the PCM)."""
    req = urllib.request.Request(url + "/stream",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.headers["Transfer-Encoding"] == "chunked",
              "/stream is not chunked")
        header = r.read(44)
        first = r.read(2)
        ttfa = time.perf_counter() - t0
        pcm = first + r.read()
    return 1e3 * ttfa, header, pcm


def read_stream_ws(url, body):
    """GET /stream-ws with ``body`` as the one text frame; returns (ms to
    the first binary frame, the frames (opcode, payload) to the close)."""
    import base64
    import socket
    import struct
    host, port = url.replace("http://", "").split(":")
    key = base64.b64encode(os.urandom(16)).decode()
    with socket.create_connection((host, int(port)), timeout=600) as s:
        t0 = time.perf_counter()
        s.sendall((f"GET /stream-ws HTTP/1.1\r\nHost: {host}\r\n"
                   "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                   f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13"
                   "\r\n\r\n").encode())
        f = s.makefile("rb")
        check(b"101" in f.readline(), "/stream-ws did not upgrade")
        while f.readline().strip():
            pass
        payload, mask = json.dumps(body).encode(), os.urandom(4)
        s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + bytes(
            c ^ mask[i % 4] for i, c in enumerate(payload)))
        frames, ttfa = [], None
        while not frames or frames[-1][0] != 8:
            h = f.read(2)
            n = h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", f.read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", f.read(8))[0]
            frames.append((h[0] & 0x0F, f.read(n)))
            if frames[-1][0] == 2 and ttfa is None:
                ttfa = 1e3 * (time.perf_counter() - t0)
    return ttfa, frames


def phase_serve_stream(ft_path, wg_path, kernels):
    """Streams from the server: ``build_server`` with --stream-workers 2,
    -d 0.1 and no ARPAbet substitutions; two concurrent ``POST /stream``
    (one with the engine's strength, one with its own) beside a wave of
    four ``POST /synthesize``, and a ``GET /stream-ws`` beside a second
    wave as soon as a streamer pair is free (two workers). Each stream's
    PCM is its n_frames cap x 256 samples (the gate is biased off) with
    well-formed framing. Then one stream alone, its launches counted.
    Returns them, and that stream's body and PCM."""
    import struct

    from flowtron_tpu_torch.serve.cli import build_server

    server, engines = build_server(
        ["-c", "config.json", "-p", NO_ARPABET, "-f", ft_path, "-w", wg_path,
         "--port", "0", "--stream-workers", "2", "-d", "0.1"],
        host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    streams = [{"text": TEXTS[0], "seed": 300, "n_frames": 200},
               {"text": TEXTS[1], "seed": 301, "n_frames": 160,
                "denoise": 0.3}]
    ws_body = {"text": TEXTS[2], "seed": 302, "n_frames": 120}
    wave_bodies = [{"text": t, "seed": REQ_SEED + 60 + i}
                   for i, t in enumerate(TEXTS)]
    try:
        get_json(url, "/healthz")
        with ThreadPoolExecutor(5) as pool:
            # two streams beside a wave; the socket stream (and a second
            # wave) as soon as one of them returns its streamer pair
            t0 = time.perf_counter()
            futs = [pool.submit(read_stream, url, b) for b in streams]
            waves = [pool.submit(wave_of, url, wave_bodies)]
            wait(futs, return_when=FIRST_COMPLETED)
            ws = pool.submit(read_stream_ws, url, ws_body)
            waves.append(pool.submit(wave_of, url, wave_bodies))
            got = [f.result() for f in futs]
            ws_ttfa, frames = ws.result()
            waves = [w.result() for w in waves]
            wall = time.perf_counter() - t0
        for results, _ in waves:
            check_answers("serve_stream wave", wave_bodies, results,
                          N_FRAMES)
        for body, (_, header, pcm) in zip(streams, got):
            check(header[:4] == b"RIFF" and header[8:16] == b"WAVEfmt "
                  and struct.unpack("<I", header[4:8])[0] == 0xFFFFFFFF
                  and struct.unpack("<I", header[24:28])[0] == SR
                  and header[36:40] == b"data", f"/stream header {header}")
            check(len(pcm) == 2 * body["n_frames"] * HOP,
                  f"/stream {len(pcm) // 2} samples for {body}")
        check(frames[0][0] == 1 and json.loads(frames[0][1]) ==
              {"sample_rate": SR, "format": "pcm16"}
              and frames[-1] == (8, b"\x03\xe8"),
              f"/stream-ws framing {frames[0]} {frames[-1]}")
        ws_bytes = sum(len(p) for op, p in frames[1:-1] if op == 2)
        check(ws_bytes == 2 * ws_body["n_frames"] * HOP,
              f"/stream-ws {ws_bytes // 2} samples")
        metrics = get_json(url, "/metrics")
        check(metrics["stream_requests"] == 3 and metrics["errors"] == 0,
              f"serve_stream metrics {metrics}")
        torch.cuda.synchronize()
        reset_launches(kernels)
        alone_ms, _, alone = read_stream(url, streams[0])
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        check(len(alone) == 2 * streams[0]["n_frames"] * HOP
              and launches["fused_flow_infer"] > 0
              and launches["wn_layer"] > 0
              and launches["quantized_matmul_w8"] == 0
              and launches["quantized_matmul_w8a8"] == 0,
              f"serve_stream alone: launches {launches}")
    finally:
        server.shutdown()
        server.server_close()
        for eng in engines.values():
            eng.shutdown()
        torch.cuda.empty_cache()
    emit("serve_stream", stream_workers=2, denoise=0.1, wall_s=wall,
         stream_ttfa_ms=[g[0] for g in got], ws_ttfa_ms=ws_ttfa,
         stream_samples=[len(g[2]) // 2 for g in got],
         ws_samples=ws_bytes // 2, wave_wall_s=[w for _, w in waves],
         wave_latency_s=[[r[1] for r in results] for results, _ in waves],
         alone_ttfa_ms=alone_ms,
         alone_launches=launches)
    return launches, streams[0], alone


def solo_stream(model, cfg, wg, wg_cfg, seed, sid, ids, temperature=1.0,
                cap=None):
    """``pump_stream`` at B=1 with the mux's settings (text padded to TK
    with its length, the stream's generators): the stream a muxed one
    must equal. Returns (audio (n,), mel (80, n), wall seconds)."""
    from flowtron_tpu_torch.infer import streaming as S

    g_mel, g_voc = S.stream_generators(seed)
    mel_s = S.StreamingMelSynthesizer(
        model, cfg, chunk_frames=MUX["chunk_frames"],
        gate_threshold=MUX["gate_threshold"], max_frames=N_FRAMES,
        temperature=temperature)
    voc = S.StreamingVocoder(wg, wg_cfg, context=MUX["context"],
                             lookahead=MUX["lookahead"], max_frames=N_FRAMES,
                             generator=g_voc)
    seen, push = [], voc.push

    def push_spy(mel_chunk):
        seen.append(mel_chunk.cpu())
        return push(mel_chunk)

    voc.push = push_spy
    text = torch.zeros(1, TK, dtype=torch.long)
    text[0, :len(ids)] = torch.as_tensor(ids)
    dev = next(model.parameters()).device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunks = list(S.pump_stream(
        mel_s, voc, g_mel, torch.tensor([sid], device=dev), text.to(dev),
        in_lens=torch.tensor([len(ids)], device=dev), max_frames=cap))
    wall = time.perf_counter() - t0
    return (np.concatenate([c[0] for c in chunks]),
            torch.cat(seen, dim=2)[0].numpy(), wall)


def run_mux(mux, opens, late=(), at_tick=0, kernels=None):
    """Drive ``mux``: ``opens`` (seed, sid, ids, temperature, cap) join at
    once, ``late`` after ``at_tick`` ticks; tick until all are done. Each
    step's tick is timed (synchronised around ``ar_step_infer``) with its
    live lanes; K1's count is read around every join and every step.
    Returns per stream (in order) its audio, mel and ms from its open() to
    its first audio, then the ticks [(live lanes, ms)], the K1 launches of
    the joins and of the steps with the joins' ms, and the wall
    seconds."""
    from flowtron_tpu_torch.infer import multistream as MS

    ticks, k1 = [], {"joins": 0, "steps": 0, "join_ms": []}
    fused = kernels["fused_flow_infer"][0] if kernels else None
    ar_step_infer = MS.ar_step_infer

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ar_step_infer(*a, **k)
        torch.cuda.synchronize()
        ticks[-1][1] = 1e3 * (time.perf_counter() - t0)
        return out

    def k1_now():
        return fused.launches if fused is not None else 0

    handles, t_open, slots = [], {}, {}

    def open_all(streams):
        for seed, sid, ids, temp, cap in streams:
            before = k1_now()
            t_open_h = time.perf_counter()
            h = mux.open(seed, sid, ids, temperature=temp, max_frames=cap)
            k1["join_ms"].append(1e3 * (time.perf_counter() - t_open_h))
            k1["joins"] += k1_now() - before
            handles.append(h)
            t_open[h] = t_open_h
        slots.update({s.handle: s for s in mux._slots if s is not None})

    out, first, done = {}, {}, set()
    MS.ar_step_infer = timed
    try:
        t0 = time.perf_counter()
        open_all(opens)
        n = 0
        while n < 1000 and (mux.active or n < at_tick):
            if n == at_tick:
                open_all(late)
            with mux._lock:
                live = sum(s is not None and s.joined and not s.done_mel
                           for s in mux._slots)
            ticks.append([live, None])
            before = k1_now()
            events = mux.step()
            k1["steps"] += k1_now() - before
            now = time.perf_counter()
            for h, audio, fin in events:
                out.setdefault(h, []).append(audio)
                if audio.size and h not in first:
                    first[h] = 1e3 * (now - t_open[h])
                if fin:
                    done.add(h)
            n += 1
        wall = time.perf_counter() - t0
    finally:
        MS.ar_step_infer = ar_step_infer
    check(done == set(handles), f"mux: streams {set(handles) - done} never "
          "finished")
    return ([(np.concatenate(out[h]), slots[h].mel_buf, first.get(h))
             for h in handles], [t for t in ticks if t[1] is not None],
            k1, wall)


def phase_mux(model, cfg, wg, wg_cfg, ids, sid, kernels, dev):
    """The multistream mux (infer/multistream.py) at full width, the gate
    biased off: 8 slots, chunks of 40, context 24, lookahead 16, 400
    frames. One stream alone first (its ticks at 1 live lane), then six
    streams join at once and two before the third tick (which runs all 8
    lanes); one is capped at 120
    frames, one runs at temperature 0.7. Each held against its solo
    ``pump_stream`` on the card: mel within MUX_TOL max-abs, audio within
    MUX_TOL of its scale. K1 launches once a join (the prelude) and never
    in a tick; K2 at the widest group's shape against its plain version.
    Then two w8a8 streams (80 frames) against the w8a8 solo stream: K4
    launches, K1 does not. Returns the 8-stream run's launches."""
    from flowtron_tpu_torch.infer import multistream as MS
    from flowtron_tpu_torch.infer.quantize import (
        quantize_flows_for_inference)
    from flowtron_tpu_torch.ops.wavenet import wn_layer, wn_layer_reference

    def mux_of(m, slots=8):
        return MS.MultiStreamTTS(m, cfg, wg, wg_cfg, slots=slots, **MUX)

    streams = [(MUX_SEED + i, sid, ids[i % len(ids)],
                0.7 if i == 5 else 1.0, 120 if i == 2 else None)
               for i in range(8)]
    run_mux(mux_of(model), streams[:1], kernels=kernels)   # warm-up
    (alone,), alone_ticks, _, alone_wall = run_mux(
        mux_of(model), [streams[0][:4] + (200,)], kernels=kernels)

    groups, window = [], MS.MultiStreamTTS._window_audio

    def window_spy(self, members, W):
        t0 = time.perf_counter()
        out = window(self, members, W)      # ends in a copy to the host
        groups.append((len(members), W, 1e3 * (time.perf_counter() - t0)))
        return out

    MS.MultiStreamTTS._window_audio = window_spy
    try:
        torch.cuda.synchronize()
        reset_launches(kernels)
        got, ticks, k1, wall = run_mux(mux_of(model), streams[:6],
                                       streams[6:], at_tick=2,
                                       kernels=kernels)
        torch.cuda.synchronize()
        launches = read_launches(kernels)
    finally:
        MS.MultiStreamTTS._window_audio = window
    check(k1["joins"] == len(streams) and k1["steps"] == 0
          and launches["fused_flow_infer"] == len(streams)
          and launches["wn_layer"] > 0
          and launches["quantized_matmul_w8a8"] == 0,
          f"mux launches {launches}, K1 {k1}")

    errs, solo_wall, audio_s = [], [], 0.0
    for (seed, s_id, s_ids, temp, cap), (audio, mel, _) in zip(streams, got):
        want, want_mel, w = solo_stream(model, cfg, wg, wg_cfg, seed, s_id,
                                        s_ids, temp, cap)
        n = min(cap or N_FRAMES, N_FRAMES)
        check(mel.shape == want_mel.shape == (80, n)
              and audio.shape == want.shape == (n * HOP,)
              and bool(np.isfinite(audio).all()),
              f"mux stream {seed}: mel {mel.shape} {want_mel.shape} audio "
              f"{audio.shape} {want.shape}")
        errs.append((float(np.abs(mel - want_mel).max()),
                     rel_err(torch.from_numpy(audio),
                             torch.from_numpy(want))))
        check(errs[-1][0] <= MUX_TOL and errs[-1][1] <= MUX_TOL,
              f"mux stream {seed} vs solo: mel, audio {errs[-1]}")
        solo_wall.append(w)
        audio_s += n * HOP / SR

    # K2 at the widest group's shape, layer 3, against its plain version
    G, W, _ = max(groups, key=lambda g: g[0] * g[1])
    wn, ng = wg.WN[0], wg_cfg["n_group"]
    C, Tp = wn.n_channels, W * HOP // ng
    gk = torch.Generator().manual_seed(34)
    w_cat, b, w_rs, b_rs = wn.packed_layers()[3]
    args = (torch.randn(G, Tp, C, generator=gk).to(dev), 8,
            torch.randn(G, Tp, 2 * C, generator=gk).to(dev), w_cat, b, w_rs,
            b_rs, Tp)
    with torch.no_grad():
        k_ms, p_ms, _, out_k, out_p = paired_ms(
            lambda: wn_layer(*args), lambda: wn_layer_reference(*args),
            reps=20, plain_reps=20)
    k2_err = max(rel_err(a, r) for a, r in zip(out_k, out_p))
    check(k2_err <= K2_TOL, f"K2 at the mux group shape: {k2_err}")

    # w8a8: the tick's and the prelude's dots through K4
    qmodel = quantize_flows_for_inference(model, mode="w8a8")
    q_streams = [(MUX_SEED + 20 + i, sid, ids[i], 1.0, 80) for i in range(2)]
    torch.cuda.synchronize()
    reset_launches(kernels)
    q_got, _, q_k1, _ = run_mux(mux_of(qmodel, slots=2), q_streams,
                                kernels=kernels)
    torch.cuda.synchronize()
    q_launches = read_launches(kernels)
    check(q_launches["quantized_matmul_w8a8"] > 0
          and q_launches["fused_flow_infer"] == 0 and q_k1["joins"] == 0,
          f"w8a8 mux launches {q_launches}")
    q_errs = []
    for (seed, s_id, s_ids, temp, cap), (audio, _, _) in zip(q_streams,
                                                           q_got):
        want, _, _ = solo_stream(qmodel, cfg, wg, wg_cfg, seed, s_id, s_ids,
                                 temp, cap)
        check(audio.shape == want.shape, f"w8a8 mux stream {seed} shape")
        q_errs.append(rel_err(torch.from_numpy(audio),
                              torch.from_numpy(want)))
    check(max(q_errs) <= MUX_TOL, f"w8a8 mux vs solo {q_errs}")
    del qmodel
    torch.cuda.empty_cache()

    def tick_ms(ts, lanes):
        sel = [ms for n, ms in ts if n == lanes]
        return statistics.median(sel) if sel else None

    emit("mux", slots=8, streams=len(streams), caps=[s[4] for s in streams],
         temperatures=[s[3] for s in streams],
         tick_ms_1_live=tick_ms(alone_ticks, 1),
         tick_ms_8_live=tick_ms(ticks, 8),
         tick_ms_by_live={n: tick_ms(ticks, n)
                          for n in sorted({n for n, _ in ticks})},
         ticks=len(ticks), first_audio_ms=[g[2] for g in got],
         alone_first_audio_ms=alone[2], alone_wall_s=alone_wall,
         wall_s=wall, audio_s=audio_s,
         audio_s_per_wall_s=audio_s / wall,
         solo_wall_s=solo_wall,
         solo_audio_s_per_wall_s=audio_s / sum(solo_wall),
         mel_max_abs_err_vs_solo=[e[0] for e in errs],
         audio_rel_err_vs_solo=[e[1] for e in errs],
         # where the 8-stream run's wall time went: joins, ticks, window
         # groups (each synchronised), the rest on the host
         split_ms=dict(joins=sum(k1["join_ms"]),
                       ticks=sum(ms for _, ms in ticks),
                       windows=sum(g[2] for g in groups), wall=1e3 * wall),
         groups=[g[:2] for g in groups],
         group_ms={f"{G}x{W}": statistics.median(
             g[2] for g in groups if g[:2] == (G, W))
             for G, W in sorted({g[:2] for g in groups})},
         launches=launches, k1_launches=k1,
         k2_group=dict(G=G, W=W, Tp=Tp, layer=3, kernel_ms=k_ms,
                       plain_ms=p_ms, max_rel_err=k2_err),
         w8a8=dict(streams=len(q_streams), audio_rel_err_vs_solo=q_errs,
                   launches=q_launches))
    return launches


def phase_serve_mux(ft_path, wg_path, kernels, pooled_body, pooled_pcm):
    """Streams through the server's mux: ``build_server`` with --stream-mux
    4 --mux-joins-per-tick 2 -d 0.1, no ARPAbet substitutions. Four ``POST
    /stream`` beside a wave of ``POST /synthesize``; once the four hold
    every slot, a fifth stream gets 429; a ``GET /stream-ws`` as soon as a
    slot frees. Every PCM is its n_frames cap x 256 samples; the stream of
    ``pooled_body`` is held against the pooled server's PCM of the same
    request (phase serve_stream) within 1e-3 of full scale. Returns the
    launches."""
    import urllib.error

    from flowtron_tpu_torch.serve.cli import build_server

    server, engines = build_server(
        ["-c", "config.json", "-p", NO_ARPABET, "-f", ft_path, "-w", wg_path,
         "--port", "0", "--stream-mux", "4", "--mux-joins-per-tick", "2",
         "-d", "0.1"], host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    streams = [pooled_body,
               {"text": TEXTS[1], "seed": 311, "n_frames": 400},
               {"text": TEXTS[2], "seed": 312, "n_frames": 320},
               {"text": TEXTS[3], "seed": 313, "n_frames": 400,
                "temperature": 0.7}]
    ws_body = {"text": TEXTS[0], "seed": 314, "n_frames": 160}
    wave_bodies = [{"text": t, "seed": REQ_SEED + 90 + i}
                   for i, t in enumerate(TEXTS)]
    try:
        get_json(url, "/healthz")
        # one stream to set up cuBLAS/cuDNN and the vocoder's shapes
        read_stream(url, {"text": TEXTS[3], "seed": 1, "n_frames": 80})
        torch.cuda.synchronize()
        reset_launches(kernels)
        with ThreadPoolExecutor(6) as pool:
            t0 = time.perf_counter()
            futs = [pool.submit(read_stream, url, b) for b in streams]
            wave = pool.submit(wave_of, url, wave_bodies)
            deadline = time.time() + 30
            while get_json(url, "/metrics")["mux_active_streams"] < 4:
                check(time.time() < deadline and not any(
                    f.done() for f in futs), "the four streams never held "
                      "the four slots at once")
                time.sleep(0.005)
            try:
                read_stream(url, {"text": TEXTS[0], "seed": 315})
                refused = None
            except urllib.error.HTTPError as e:
                refused = e.code
            check(refused == 429, f"the stream past the slots: {refused}")
            wait(futs, return_when=FIRST_COMPLETED)
            ws = pool.submit(read_stream_ws, url, ws_body)
            got = [f.result() for f in futs]
            ws_ttfa, frames = ws.result()
            wave_results, wave_wall = wave.result()
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        check_answers("serve_mux wave", wave_bodies, wave_results, N_FRAMES)
        for body, (_, _, pcm) in zip(streams, got):
            check(len(pcm) == 2 * body["n_frames"] * HOP,
                  f"/stream through the mux: {len(pcm) // 2} samples for "
                  f"{body}")
        ws_bytes = sum(len(p) for op, p in frames[1:-1] if op == 2)
        check(frames[-1] == (8, b"\x03\xe8")
              and ws_bytes == 2 * ws_body["n_frames"] * HOP,
              f"/stream-ws through the mux: {ws_bytes // 2} samples")
        muxed = np.frombuffer(got[0][2], "<i2").astype(np.int32)
        pooled = np.frombuffer(pooled_pcm, "<i2").astype(np.int32)
        vs_pool = float(np.abs(muxed - pooled).max()) / 32767 \
            if len(muxed) == len(pooled) else None
        check(vs_pool is not None and vs_pool <= MUX_TOL,
              f"muxed PCM vs pooled: lengths {len(muxed)} {len(pooled)}, "
              f"err {vs_pool}")
        metrics = get_json(url, "/metrics")
        check(metrics["mux_slots"] == 4 and metrics["rejected_overload"] == 1
              and metrics["errors"] == 0 and metrics["stream_requests"] == 6
              and metrics["mux_active_streams"] == 0,
              f"serve_mux metrics {metrics}")
        check(launches["fused_flow_infer"] > 0 and launches["wn_layer"] > 0
              and launches["quantized_matmul_w8a8"] == 0,
              f"serve_mux launches {launches}")
    finally:
        server.shutdown()
        server.server_close()
        for eng in engines.values():
            eng.shutdown()
        torch.cuda.empty_cache()
    emit("serve_mux", stream_mux=4, mux_joins_per_tick=2, denoise=0.1,
         wall_s=wall, stream_ttfa_ms=[g[0] for g in got],
         ws_ttfa_ms=ws_ttfa, stream_samples=[len(g[2]) // 2 for g in got],
         ws_samples=ws_bytes // 2, refused=refused, wave_wall_s=wave_wall,
         wave_latency_s=[r[1] for r in wave_results],
         pcm_max_abs_err_vs_pool=vs_pool, launches=launches)
    return launches


def phase_serve_staged(ft_path, wg_path, kernels):
    """Staged vocoding: ``build_server`` with --vocode-buckets 120,240.
    Waves of four requests capped at 100 frames (bucket 120) and at 200
    (bucket 240), staged, then the same waves with staging off on the same
    engine (the one-pass chain at 400 frames), twice in turns; each
    request its cap x 256 samples, every staged batch counted at its
    bucket. Returns the first staged waves' launches."""
    from flowtron_tpu_torch.serve.cli import build_server

    server, engines = build_server(
        ["-c", "config.json", "-f", ft_path, "-w", wg_path, "--port", "0",
         "--vocode-buckets", "120,240"], host="127.0.0.1")
    eng = engines["default"]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    buckets = eng._vocode_buckets
    waves = {cap: [{"text": t, "seed": REQ_SEED + 100 + i, "n_frames": cap}
                   for i, t in enumerate(TEXTS)] for cap in (100, 200)}
    runs = {(cap, staged): [] for cap in waves for staged in (True, False)}
    try:
        check(buckets == (120, 240, N_FRAMES), f"buckets {buckets}")
        served = 0

        def wave(bodies):
            """A wave, then wait until the completion thread has recorded
            its batches (it answers the requests first)."""
            nonlocal served
            out = wave_of(url, bodies)
            served += len(bodies)
            deadline = time.time() + 30
            while eng.metrics()["requests"] < served:
                check(time.time() < deadline, "staged wave never recorded")
                time.sleep(0.005)
            return out

        for cap in waves:                  # set-up: each bucket once
            wave(waves[cap][:1])
        m0 = get_json(url, "/metrics")
        launches = None
        torch.cuda.synchronize()
        reset_launches(kernels)
        for staged in (True, False, False, True):
            eng._vocode_buckets = buckets if staged else None
            for cap, bodies in waves.items():
                n_before = len(eng._recent_batch_ms)
                results, wall = wave(bodies)
                for body, (status, _, rate, n, peak) in zip(bodies, results):
                    check(status == 200 and n == cap * HOP and peak > 0,
                          f"staged wave: {n} samples for {body}")
                runs[(cap, staged)].append(
                    dict(wall_s=wall,
                         batch_ms=eng._recent_batch_ms[n_before:]))
            if launches is None:
                torch.cuda.synchronize()
                launches = read_launches(kernels)
        m1 = get_json(url, "/metrics")
    finally:
        server.shutdown()
        server.server_close()
        for e in engines.values():
            e.shutdown()
        torch.cuda.empty_cache()
    hits = {b: m1["vocode_bucket_hits"][b] - m0["vocode_bucket_hits"][b]
            for b in m1["vocode_bucket_hits"]}
    staged_batches = m1["staged_batches"] - m0["staged_batches"]
    n_staged = {cap: sum(len(r["batch_ms"]) for r in runs[(cap, True)])
                for cap in waves}
    check(staged_batches == sum(n_staged.values())
          and hits == {"120": n_staged[100], "240": n_staged[200],
                       str(N_FRAMES): 0},
          f"staged batches {staged_batches}, hits {hits}, {n_staged}")
    check(launches["fused_flow_infer"] > 0 and launches["wn_layer"] > 0,
          f"staged launches {launches}")

    def med(cap, staged):
        return statistics.median(ms for r in runs[(cap, staged)]
                                 for ms in r["batch_ms"])

    emit("serve_staged", buckets=list(buckets), caps=list(waves),
         staged_batches=staged_batches, vocode_bucket_hits=hits,
         batch_ms={f"{cap}_{'staged' if st else 'one_pass'}": med(cap, st)
                   for cap in waves for st in (True, False)},
         vocoded_frames={f"{cap}": [min(b for b in buckets if b >= cap),
                                    N_FRAMES] for cap in waves},
         runs={f"{cap}_{'staged' if st else 'one_pass'}": r
               for (cap, st), r in runs.items()},
         launches=launches)
    return launches


def phase_griffin_lim_serve(ft_path, kernels):
    """The server without a vocoder: ``build_server`` without -w, four
    concurrent requests capped at 120-400 frames. The flows run on the
    card (K1), each request's mel is vocoded by Griffin-Lim (20
    iterations) on the host in the completion thread, so K2 launches 0
    times; n frames give (n - 1) x 256 samples. Returns the launches."""
    from flowtron_tpu_torch.serve.cli import build_server

    server, engines = build_server(
        ["-c", "config.json", "-f", ft_path, "--port", "0"],
        host="127.0.0.1")
    eng = engines["default"]
    vocode, host_s = eng._vocode, []

    def timed(mel):
        t0 = time.perf_counter()
        out = vocode(mel)
        host_s.append(time.perf_counter() - t0)
        return out

    eng._vocode = timed
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    bodies = [{"text": TEXTS[i], "seed": REQ_SEED + 80 + i, "n_frames": nf}
              for i, nf in enumerate((120, 200, 300, 400))]
    try:
        get_json(url, "/healthz")
        check(not get_json(url, "/models")["models"][0]["can_stream"],
              "a server without a vocoder says it can stream")
        torch.cuda.synchronize()
        reset_launches(kernels)
        results, wall = wave_of(url, bodies)
        torch.cuda.synchronize()
        launches = read_launches(kernels)
        for body, (status, _, rate, n, peak) in zip(bodies, results):
            check(status == 200 and rate == SR and peak > 0
                  and n == (body["n_frames"] - 1) * HOP,
                  f"griffin_lim_serve: {n} samples for {body}")
        check(launches["fused_flow_infer"] > 0 and launches["wn_layer"] == 0,
              f"griffin_lim_serve launches {launches}")
    finally:
        server.shutdown()
        server.server_close()
        for e in engines.values():
            e.shutdown()
        torch.cuda.empty_cache()
    emit("griffin_lim_serve", requests=len(bodies), wall_s=wall,
         latency_s=[r[1] for r in results], samples=[r[3] for r in results],
         host_vocode_s=host_s, launches=launches)
    return launches


def reset_launches(kernels):
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)


def read_launches(kernels):
    """Each counter, K4's split by body: quantized_matmul counts both
    bodies' launches, quantized_matmul_w8a8 the W8A8 body's; the _bf16
    counters the bf16 bodies' alone (of K4 both modes, then W8A8)."""
    out = {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}
    out["quantized_matmul_w8"] = out.pop("quantized_matmul") \
        - out["quantized_matmul_w8a8"]
    out["quantized_matmul_w8_bf16"] = out.pop("quantized_matmul_bf16") \
        - out["quantized_matmul_w8a8_bf16"]
    return out


def train_args(corpus, out_dir, fp16_run):
    """cli.train_main's argv: config.json with only the filelists, the
    output directory, one epoch, the checkpoint period, TensorBoard off
    and the precision policy overridden."""
    train_fl, val_fl = corpus
    return ["-c", "config.json", "-p",
            f"data_config.training_files={train_fl}",
            f"data_config.validation_files={val_fl}",
            f"train_config.output_directory={out_dir}",
            "train_config.epochs=1", "train_config.iters_per_checkpoint=9",
            "train_config.with_tensorboard=False",
            f"train_config.fp16_run={fp16_run}"]


def k3_inputs(b, tq, tk, D, dtype, guarded, g, dev):
    """Q, K, v and ds of one K3 case; ``guarded`` puts a share of Q and K
    values beyond the fast form's |x| <= 20 (every 7th query row over the
    first 100 columns, every 5th key row over columns 50-199, drawn at
    scale 30)."""
    q = 0.5 * torch.randn(b, tq, D, generator=g)
    k = 0.5 * torch.randn(b, tk, D, generator=g)
    if guarded:
        q[:, ::7, :100] = 30 * torch.randn(q[:, ::7, :100].shape, generator=g)
        k[:, ::5, 50:200] = 30 * torch.randn(k[:, ::5, 50:200].shape,
                                             generator=g)
    v = 0.1 * torch.randn(D, generator=g)
    ds = torch.randn(b, tq, tk, generator=g)
    return tuple(x.to(dev, dtype) for x in (q, k, v, ds))


def k3_guarded_share(q, k):
    """The share of the forward's (16 query, 64 key rows, 32-deep chunk)
    tiles that hold a value beyond |x| <= 20 (or a NaN), as the kernel
    stages them."""
    def big(x, rows):
        b, t, d = x.shape
        pad = torch.nn.functional.pad(~(x.float().abs() <= 20),
                                      (0, -d % 32, 0, -t % rows))
        return pad.reshape(b, -1, rows, pad.shape[2] // 32, 32).any(4).any(2)
    return float((big(q, 16)[:, :, None] | big(k, 64)[:, None]).float()
                 .mean())


def phase_k3(shape, D, dev):
    """K3 forward and backward against their plain versions at the padded
    (B, T, Tk) of the first batch the training path drew (from its log)
    and the flagship D, in fp32 and bf16: as drawn, and with a share of Q
    and K values beyond |x| <= 20 (the kernel's guarded chunks); near
    LJSpeech's longest utterance (~10 s, ~190 symbols: B=6, Tq=864,
    Tk=192) in fp32; and at one unaligned shape. Each case: the forward
    within K3_TOL of the output scale, each gradient within K3_TOL of its
    largest value, two backward runs bitwise equal. Times are device
    times in CUDA graphs (a call takes tens of microseconds, less than
    Python needs to launch it), the eager call's beside them. Returns
    the kernel table's fields of the fp32 training batch."""
    from flowtron_tpu_torch.ops.attention import (
        attention_scores_backward_reference, attention_scores_bwd,
        attention_scores_fwd, attention_scores_reference)

    B, T, Tk = shape
    g = torch.Generator().manual_seed(13)
    side = torch.cuda.Stream()
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((B, T, Tk), "train_batch", dt, False) for dt in (f32, bf16)]
    cases += [((B, T, Tk), "guarded", dt, True) for dt in (f32, bf16)]
    cases += [((6, 864, 192), "ljspeech_longest", f32, False)]
    cases += [((3, 19, 7), "unaligned", dt, False) for dt in (f32, bf16)]
    table = {}
    temp = 1.0
    for (b, tq, tk), tag, dtype, guarded in cases:
        q, k, v, ds = k3_inputs(b, tq, tk, D, dtype, guarded, g, dev)
        with torch.no_grad():
            (f_ms, fp_ms), (out_k, out_p), f_runs = graph_times([
                lambda: attention_scores_fwd(q, k, v, temp),
                lambda: attention_scores_reference(q, k, v, temp)], side,
                reps=10)
            (b_ms, bp_ms), (grads_k, grads_p), b_runs = graph_times([
                lambda: attention_scores_bwd(q, k, v, ds, temp),
                lambda: attention_scores_backward_reference(
                    q, k, v, ds, temp)], side, reps=10)
            # eager calls, after one warm-up call that takes the
            # allocator's first blocks off the clock
            f_eager = warm_eager_ms(
                lambda: attention_scores_fwd(q, k, v, temp))
            b_eager = warm_eager_ms(
                lambda: attention_scores_bwd(q, k, v, ds, temp))
            again = attention_scores_bwd(q, k, v, ds, temp)
            # the kernel accumulates in fp32: hold it against the plain
            # math on the same inputs, accumulated in fp32
            ref = attention_scores_reference(q.float(), k.float(),
                                             v.float(), temp)
        scale = float(ref.abs().max())
        fwd_err = float((out_k.float() - ref).abs().max())
        fwd_err_plain = float((out_k.float() - out_p.float()).abs().max())
        bwd_abs = [float((a.float() - r.float()).abs().max())
                   for a, r in zip(grads_k, grads_p)]
        bwd_rel = [e / float(r.float().abs().max())
                   for e, r in zip(bwd_abs, grads_p)]
        bitwise = all(torch.equal(a, c) for a, c in zip(grads_k, again))
        name = f"K3 {tag} {str(dtype)[6:]} B={b} Tq={tq} Tk={tk}"
        tol = K3_TOL[dtype]
        check(math.isfinite(fwd_err) and fwd_err <= tol * scale,
              f"{name} forward err {fwd_err} (scale {scale})")
        check(all(math.isfinite(e) and e <= tol for e in bwd_rel),
              f"{name} backward rel errs {bwd_rel}")
        check(bitwise, f"{name} backward runs differ")
        # q, k, v (and ds) read once, scores (or dq, dk, dv) written once;
        # per (b, q, t, d) one reciprocal (the tanh), forward and backward,
        # and FMA-pipe instructions: 2 forward (1 + E_a E_b, acc + v r),
        # 6 backward (1 + E_a E_b, g r, g r - g r r, the dQ, dK and
        # sum g r adds)
        n = q.element_size()
        qkv = b * tq * D + b * tk * D + D
        elems = b * tq * tk * D
        f_bound = k3_bound(n * (qkv + b * tq * tk), 2 * elems, elems)
        b_bound = k3_bound(n * (2 * qkv + b * tq * tk), 6 * elems, elems)
        emit("k3", shape=tag, dtype=str(dtype)[6:], B=b, Tq=tq, Tk=tk,
             D=D, fwd_guarded_tile_share=k3_guarded_share(q, k),
             fwd_max_abs_err=fwd_err, fwd_scale=scale,
             fwd_max_abs_err_vs_plain_same_dtype=fwd_err_plain,
             bwd_max_abs_err_dq_dk_dv=bwd_abs,
             bwd_max_rel_err_dq_dk_dv=bwd_rel, bwd_bitwise_repeat=bitwise,
             fwd_kernel_ms=f_ms, fwd_plain_ms=fp_ms,
             bwd_kernel_ms=b_ms, bwd_plain_ms=bp_ms,
             fwd_runs_kernel_plain_ms=f_runs, bwd_runs_kernel_plain_ms=b_runs,
             fwd_bound_ms=f_bound[0], bwd_bound_ms=b_bound[0],
             fwd_eager_call_ms=f_eager, bwd_eager_call_ms=b_eager)
        if tag == "train_batch" and dtype == f32:
            table = {"fwd": (fwd_err, f_ms, fp_ms) + f_bound,
                     "bwd": (max(bwd_abs), b_ms, bp_ms) + b_bound}
        del q, k, v, ds, out_k, out_p, grads_k, grads_p, again, ref
        torch.cuda.empty_cache()
    return table


def run_train(argv, out_dir, kernels, dev, tag, min_steps, untimed=()):
    """cli.train_main(argv) with every launch count set to 0 just before
    and read just after. Checks that at least ``min_steps`` steps ran with
    finite losses; returns the log's steps and validations, the launches,
    the peak memory and the median step time over the steps after the
    first (warm-up) that are not in ``untimed``."""
    from flowtron_tpu_torch.cli import train_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)    # by earlier phases
    reset_launches(kernels)
    t0 = time.perf_counter()
    train_main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    steps = [r for r in log if "loss" in r]
    losses = [r["loss"] for r in steps]
    check(len(steps) >= min_steps, f"train {tag}: {len(steps)} steps")
    check(all(math.isfinite(x) for x in losses),
          f"train {tag}: loss not finite {losses}")
    timed = [r for r in steps[1:] if r["iteration"] not in untimed]
    frames = sum(r["frames"] for r in timed)
    seconds = sum(r["step_s"] for r in timed)
    return dict(steps=steps, losses=losses,
                vals=[r for r in log if "validation" in r],
                launches=launches, peak=peak, held=held, wall=wall,
                ms_median=1e3 * statistics.median(r["step_s"]
                                                  for r in timed),
                frames_per_s=frames / seconds)


def emit_train(phase, run, **extra):
    steps = run["steps"]
    emit(phase, steps=len(steps), loss=run["losses"],
         nll=[r["nll"] for r in steps], gate=[r["gate"] for r in steps],
         grad_norm=[r["grad_norm"] for r in steps],
         padded_shapes=[r["padded_shape"] for r in steps],
         step_ms=[1e3 * r["step_s"] for r in steps],
         ms_per_step_median=run["ms_median"],
         mel_frames_per_s=run["frames_per_s"],
         peak_memory_allocated_bytes=run["peak"],
         allocated_before_run_bytes=run["held"],
         validation=[{"iteration": r["iteration"], **r["validation"]}
                     for r in run["vals"]],
         wall_s=run["wall"], launches=run["launches"], **extra)


def check_training_kernels(tag, launches):
    """K3 forward and backward launched; no inference kernel."""
    check(launches["attention_scores_fwd"] > 0
          and launches["attention_scores_bwd"] > 0,
          f"train {tag}: K3 not launched {launches}")
    check(launches["fused_flow_infer"] == 0 and launches["wn_layer"] == 0
          and launches["quantized_matmul_w8a8"] == 0
          and launches["quantized_matmul_w8"] == 0,
          f"train {tag}: inference kernels launched {launches}")


def phase_train(corpus, tmp, kernels, dev):
    """The training path: cli.train_main from config.json, once with its
    bf16 policy (fp16_run true) and once in fp32, 10 flagship-width steps
    each. Returns the fp32 run's output directory and its run (launches,
    losses, peak memory, step times), and the padded (B, T, Tk) of the
    first batch, from the training log."""
    runs = {}
    for fp16_run in (True, False):
        tag = "bf16" if fp16_run else "fp32"
        out_dir = os.path.join(tmp, tag)
        run = run_train(train_args(corpus, out_dir, fp16_run), out_dir,
                        kernels, dev, tag, 10)
        losses = run["losses"]
        check(losses[-1] < losses[0],
              f"train {tag}: last loss {losses[-1]} not below the first "
              f"{losses[0]}")
        check_training_kernels(tag, run["launches"])
        check(os.path.exists(os.path.join(out_dir, "model_9.pt")),
              f"train {tag}: no checkpoint model_9.pt")
        emit_train("train", run, policy=tag)
        runs[tag] = run
    return os.path.join(tmp, "fp32"), runs["fp32"], \
        tuple(runs["fp32"]["steps"][0]["padded_shape"])


def phase_train_vs_cpu(config, dev, phase="train_vs_cpu"):
    """One flagship-width step (B=2, T=32, fp32, CTC on, dropout off) of
    ``config``'s model (with its Gaussian-mixture NLL where it has the
    head) on the card against the plain path on the CPU: loss and
    gradient norm."""
    from flowtron_tpu_torch.data.prior import beta_binomial_prior
    from flowtron_tpu_torch.models.flowtron import (
        flowtron_forward, flowtron_init)
    from flowtron_tpu_torch.train.loss import flowtron_loss

    model, cfg = flowtron_init(77, **config["model_config"])
    perturb_flow_heads(model, torch.Generator().manual_seed(3))
    B, T, Tk = 2, 32, 12
    g = torch.Generator().manual_seed(21)
    out_lens, in_lens = torch.tensor([32, 27]), torch.tensor([12, 9])
    mel = torch.randn(B, 80, T, generator=g) - 5.0
    text = torch.randint(1, 185, (B, Tk), generator=g)
    prior = torch.zeros(B, T, Tk)
    gate = torch.zeros(B, T)
    for b in range(B):
        mel[b, :, out_lens[b]:] = 0
        text[b, in_lens[b]:] = 0
        prior[b, :out_lens[b], :in_lens[b]] = torch.from_numpy(
            beta_binomial_prior(int(in_lens[b]), int(out_lens[b])))
        gate[b, out_lens[b] - 1:] = 1
    sids = torch.zeros(B, dtype=torch.long)
    tc = config["train_config"]
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model.to(d)
        model.zero_grad(set_to_none=True)
        out = flowtron_forward(model, cfg, mel.to(d), sids.to(d),
                               text.to(d), in_lens.to(d), out_lens.to(d),
                               attn_prior=prior.to(d))
        nll, gl, ctc = flowtron_loss(
            out, gate.to(d), in_lens.to(d), out_lens.to(d),
            sigma=tc["sigma"], use_ctc_loss=True,
            gm_loss=cfg["n_components"] > 1,
            blank_logprob=float(tc["blank_logprob"]))
        total = nll + gl + ctc
        total.backward()
        gnorm = torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters()
             if p.grad is not None]))
        res[where] = [float(x.detach()) for x in (total, nll, gl, ctc, gnorm)]
    loss_rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    gn_rel = abs(res["card"][4] - res["cpu"][4]) / res["cpu"][4]
    check(loss_rel <= LOSS_TOL and gn_rel <= GNORM_TOL,
          f"train step card vs cpu: loss rel {loss_rel}, grad norm rel "
          f"{gn_rel}")
    emit(phase, B=B, T=T, Tk=Tk, n_components=cfg["n_components"],
         card_loss_nll_gate_ctc_gradnorm=res["card"],
         cpu_loss_nll_gate_ctc_gradnorm=res["cpu"],
         loss_rel_err=loss_rel, grad_norm_rel_err=gn_rel)


def phase_train_to_infer(config, ckpt, ids, sid, dev):
    """The fp32 run's last checkpoint, loaded for inference with
    strict=True: one request through K1, then the invertibility oracle on
    the card (K1 inverse, K3 forward), on the checkpoint as trained and
    again with its coupling heads perturbed. Ten steps leave the heads
    near zero, where mel is close to z whatever K1 and K3 compute; the
    perturbed heads make both kernels' outputs count in the oracle."""
    from flowtron_tpu_torch.infer.sampling import (
        load_model_for_inference, synthesize)
    from flowtron_tpu_torch.models.flowtron import flowtron_test_invertibility

    model, cfg = load_model_for_inference(config, ckpt, dev)
    mel, _, n = synthesize(model, cfg, ids[1], sid, n_frames=N_FRAMES,
                           sigma=SIGMA, seed=REQ_SEED)
    check(n > 0 and bool(torch.isfinite(mel).all()),
          f"request from the trained checkpoint: n_valid {n}")
    g = torch.Generator().manual_seed(31)
    residual = (SIGMA * torch.randn(2, 80, 64, generator=g)).to(dev)
    text = torch.as_tensor(ids[0][None]).repeat(2, 1).to(dev)
    errs, heads = [], []
    for perturbed in (False, True):
        if perturbed:
            perturb_flow_heads(model, torch.Generator().manual_seed(32))
        heads.append(max(float(f.conv.weight.detach().abs().max())
                          for f in (model.flows[0], model.flows[1].ar_step)))
        errs.append(float(flowtron_test_invertibility(
            model, cfg, residual, torch.full((2,), sid, device=dev), text)))
        check(errs[-1] <= INV_TOL,
              f"invertibility {errs[-1]} (heads perturbed: {perturbed})")
    emit("train_to_infer", checkpoint=os.path.basename(ckpt),
         invertibility_mean_abs_trained_perturbed=errs,
         coupling_head_max_abs_trained_perturbed=heads,
         request_n_valid=n, request_text_len=len(ids[1]))


GM_CONFIG = "configs/config_libritts2k_gm.json"
GM_STEPS = 16          # steps of the GM run: the trace window is 10..14
CUMM_STEPS = 3         # steps of the cumulative-attention run
K3_KERNELS = ("scores_fwd_kernel", "scores_bwd_kernel")   # csrc/attention.cu


def filelist_of(src, n, path):
    """A filelist of ``src``'s first ``n`` lines, from the top again where
    it has fewer."""
    with open(src) as f:
        lines = f.read().splitlines()
    with open(path, "w") as f:
        f.write("\n".join((lines * (1 + n // len(lines)))[:n]) + "\n")
    return path


def gm_args(train_fl, val_fl, out_dir, *extra):
    """cli.train_main's argv for configs/config_libritts2k_gm.json (its
    bf16 policy, B=6, 8 components): the filelists, no random ARPAbet
    substitution (its draws advance with every pass over the validation
    set, so a later pass would read other text ids), the output directory,
    one epoch, a checkpoint at the last step, TensorBoard off and CTC from
    the first step."""
    return ["-c", GM_CONFIG, "-p",
            f"data_config.training_files={train_fl}",
            f"data_config.validation_files={val_fl}", NO_ARPABET,
            f"train_config.output_directory={out_dir}",
            "train_config.epochs=1",
            f"train_config.iters_per_checkpoint={GM_STEPS - 1}",
            "train_config.with_tensorboard=False",
            "train_config.ctc_loss_start_iter=0", *extra]


def trace_kernels(path):
    """From a Chrome trace: the K3 kernels' launches by name, all GPU
    kernels' summed duration and the window from the first to the last
    event (us)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "ts" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k3 = {n: sum(n in e.get("name", "") for e in kernels)
          for n in K3_KERNELS}
    span = max(e["ts"] + e.get("dur", 0) for e in events) \
        - min(e["ts"] for e in events)
    return k3, sum(e.get("dur", 0) for e in kernels), span, len(events)


def phase_train_gm(corpus, tmp, kernels, dev):
    """The Gaussian-mixture model of configs/config_libritts2k_gm.json at
    its full width (2 flows, n_hidden 1024, 2311 speakers, 8 components,
    a mel encoder of 512), B=6, its bf16 policy, CTC on: GM_STEPS steps
    through cli.train_main over the corpus' training utterances and the
    first ones again (96 in all), with ``profile_dir`` set. Returns the
    run and the checkpoint of its last step."""
    train_fl, val_fl = corpus
    gm_fl = filelist_of(train_fl, 6 * GM_STEPS,
                        os.path.join(tmp, "gm_train.txt"))
    out_dir, prof = (os.path.join(tmp, n) for n in ("gm", "gm_trace"))
    run = run_train(gm_args(gm_fl, val_fl, out_dir,
                            f"train_config.profile_dir={prof}"),
                    out_dir, kernels, dev, "gm", GM_STEPS,
                    untimed=range(10, 15))
    losses = run["losses"]
    check(len(losses) == GM_STEPS, f"train gm: {len(losses)} steps")
    check(losses[-1] < losses[0],
          f"train gm: last loss {losses[-1]} not below the first "
          f"{losses[0]}")
    check_training_kernels("gm", run["launches"])
    ckpt = os.path.join(out_dir, f"model_{GM_STEPS - 1}.pt")
    check(os.path.exists(ckpt), f"train gm: no checkpoint {ckpt}")
    trace = os.path.join(prof, "trace.json")
    check(os.path.exists(trace), f"train gm: no trace {trace}")
    k3, busy_us, span_us, n_events = trace_kernels(trace)
    check(all(n > 0 for n in k3.values()),
          f"train gm: the trace names no K3 kernel {k3}")
    emit_train("train_gm", run, config=GM_CONFIG,
               timed_steps="1-9 and 15 (10-14 traced)",
               trace_bytes=os.path.getsize(trace), trace_events=n_events,
               trace_k3_kernels=k3,
               trace_device_busy_share=busy_us / span_us,
               trace_window_ms=span_us / 1e3)
    return run, ckpt


def phase_train_remat(corpus, tmp, kernels, dev, fp32_run):
    """config.json in fp32 with ``remat: true``, 10 steps: each step's
    loss against the ``train`` phase's fp32 run (same data, dropout and
    weights), peak memory and step time beside that run's."""
    out_dir = os.path.join(tmp, "remat")
    run = run_train(train_args(corpus, out_dir, False)
                    + ["train_config.remat=True"], out_dir, kernels, dev,
                    "remat", 10)
    check_training_kernels("remat", run["launches"])
    rel = [abs(a - b) / abs(b)
           for a, b in zip(run["losses"], fp32_run["losses"])]
    check(len(rel) == len(fp32_run["losses"]) and max(rel) <= LOSS_TOL,
          f"remat losses vs fp32: rel {rel}")
    emit_train("train_remat", run, loss_rel_err_vs_fp32=rel,
               fp32_ms_per_step_median=fp32_run["ms_median"],
               fp32_peak_memory_allocated_bytes=fp32_run["peak"],
               fp32_launches=fp32_run["launches"])
    return run["launches"]


def phase_cumm(corpus, tmp, ids, kernels, dev):
    """config.json with ``use_cumm_attention: true`` (its bf16 policy):
    CUMM_STEPS training steps, whose flows run the per-frame pass (no K3),
    then one B=1 request of N_FRAMES frames from the checkpoint, gate off,
    on the loop (no K1)."""
    from flowtron_tpu_torch.config import load_config
    from flowtron_tpu_torch.infer.sampling import (
        load_model_for_inference, synthesize)

    train_fl, val_fl = corpus
    fl = filelist_of(train_fl, 6 * CUMM_STEPS,
                     os.path.join(tmp, "cumm_train.txt"))
    out_dir = os.path.join(tmp, "cumm")
    args = train_args((fl, val_fl), out_dir, True) + [
        "model_config.use_cumm_attention=True",
        f"train_config.iters_per_checkpoint={CUMM_STEPS - 1}"]
    run = run_train(args, out_dir, kernels, dev, "cumm", CUMM_STEPS)
    check(run["launches"]["attention_scores_fwd"] == 0
          and run["launches"]["attention_scores_bwd"] == 0
          and run["launches"]["fused_flow_infer"] == 0,
          f"cumm training launched K3 or K1: {run['launches']}")
    config = load_config("config.json", args[3:])
    model, cfg = load_model_for_inference(
        config, os.path.join(out_dir, f"model_{CUMM_STEPS - 1}.pt"), dev)
    reset_launches(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mel, _, n = synthesize(model, cfg, ids, 0, n_frames=N_FRAMES,
                           sigma=SIGMA, gate_threshold=1e6, seed=REQ_SEED)
    torch.cuda.synchronize()
    request_s = time.perf_counter() - t0
    infer_launches = read_launches(kernels)
    check(n == N_FRAMES and bool(torch.isfinite(mel).all()),
          f"cumm request: n_valid {n}")
    check(infer_launches["fused_flow_infer"] == 0,
          f"cumm request reached K1: {infer_launches}")
    emit_train("cumm", run, request_frames=n, request_s=request_s,
               request_launches=infer_launches)
    return run["launches"], infer_launches


def timed_calls(targets):
    """Wrap each (module, name) so that its calls add their synchronised
    seconds to the returned dict under ``name``; returns the dict and a
    function that restores the originals."""
    seconds, saved = {}, []
    for mod, name in targets:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            seconds[_name] = seconds.get(_name, 0.0) \
                + time.perf_counter() - t0
            return out
        setattr(mod, name, timed)

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return seconds, restore


def phase_evaluate(corpus, tmp, gm_run, ckpt, kernels, dev):
    """``flowtron-torch-evaluate --plots --tone-cer 4`` on the GM run's
    last checkpoint: its nll / gate / ctc against the loop's validation at
    that step, seconds by part, K1 launched (tone-CER's synthesis, the
    oracle's inverse). ``--plots`` needs matplotlib, as in the JAX
    package; where it is not installed the run goes without it and the
    line says so. Then the oracle on the loaded checkpoint with its
    coupling heads perturbed (16 steps leave them near zero, where mel is
    close to z whatever K1 and K3 compute), and GM inference on the
    checkpoint (``phase_gm_infer``)."""
    from flowtron_tpu_torch import cli
    from flowtron_tpu_torch.data import tone_cer
    from flowtron_tpu_torch.models import flowtron
    from flowtron_tpu_torch.train import evaluate as ev
    from flowtron_tpu_torch.train import loop

    import importlib.util
    args = gm_args(*corpus, os.path.join(tmp, "gm"))[:6]   # -c, data
    plots = os.path.join(tmp, "gm_plots") \
        if importlib.util.find_spec("matplotlib") else None
    seconds, restore = timed_calls(
        [(loop, "compute_validation_loss"), (ev, "_save_plots"),
         (tone_cer, "tone_cer_report"),
         (flowtron, "flowtron_test_invertibility")])
    out = io.StringIO()
    reset_launches(kernels)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.evaluate_main(args + ["-f", ckpt, "--tone-cer", "4"]
                              + (["--plots", plots] if plots else []))
    finally:
        restore()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    val = gm_run["vals"][-1]
    check(val["iteration"] == GM_STEPS - 1, f"last validation {val}")
    rel = {k: abs(result[k] - val["validation"][k])
           / max(abs(val["validation"][k]), 1e-12)
           for k in ("nll", "gate", "ctc")}
    check(max(rel.values()) <= 1e-5,
          f"evaluate vs the loop's validation: {rel}")
    check(launches["fused_flow_infer"] > 0
          and launches["attention_scores_fwd"] > 0,
          f"evaluate: K1 or K3 not launched {launches}")
    check(plots is None or all(
        os.path.getsize(os.path.join(plots, n)) > 0
        for n in ("attention.png", "gate.png")), "evaluate: plots")
    # the oracle on the loaded model with its heads perturbed, as
    # evaluate runs it (a seeded residual of 100 frames, TF32 off)
    from flowtron_tpu_torch.config import load_config
    from flowtron_tpu_torch.data.frontend import TextFrontend
    from flowtron_tpu_torch.infer.sampling import load_model_for_inference
    config = load_config(GM_CONFIG, args[3:])
    model, cfg = load_model_for_inference(config, ckpt, dev)
    perturb_flow_heads(model, torch.Generator().manual_seed(33))
    text = torch.as_tensor(TextFrontend.from_config(
        config["data_config"]).get_text(TEXTS[3])[None]).to(dev)
    g = torch.Generator().manual_seed(1234)
    residual = (float(config["train_config"]["sigma"])
                * torch.randn(1, 80, 100, generator=g)).to(dev)
    with ev.tf32_off():
        inv_err = float(flowtron.flowtron_test_invertibility(
            model, cfg, residual, torch.zeros(1, dtype=torch.long,
                                              device=dev), text))
    del model
    check(inv_err <= INV_TOL,
          f"invertibility with the heads perturbed: {inv_err}")
    emit("evaluate", checkpoint=os.path.basename(ckpt), result=result,
         plots="written" if plots else "not run: no matplotlib here",
         loop_validation=val["validation"], rel_err_vs_loop=rel,
         seconds_by_part=seconds, wall_s=wall, launches=launches,
         perturbed_heads_invertibility_err=inv_err)
    phase_gm_infer(args, ckpt, kernels)
    return launches


def phase_gm_infer(args, ckpt, kernels):
    """``flowtron-torch-infer`` with the GM config on ``ckpt`` (Griffin-Lim,
    no -w): the CLI's whole path, with its mel/attention PNG (matplotlib,
    which the card's machine may lack) replaced by a no-op for the
    call."""
    from flowtron_tpu_torch import cli
    from flowtron_tpu_torch.infer import sampling

    res = os.path.join(os.path.dirname(ckpt), "gm_res")
    png = sampling.save_mel_attention_png
    sampling.save_mel_attention_png = lambda *a, **k: None
    reset_launches(kernels)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.inference_main(args + ["-f", ckpt, "-t", TEXTS[3],
                                       "-o", res])
    finally:
        sampling.save_mel_attention_png = png
    seconds = time.perf_counter() - t0
    launches = read_launches(kernels)
    wavs = [f for f in os.listdir(res) if f.endswith(".wav")]
    check(len(wavs) == 1 and os.path.getsize(os.path.join(res, wavs[0])) > 44
          and launches["fused_flow_infer"] > 0,
          f"GM inference (flowtron-torch-infer): {wavs} {launches}")
    emit("gm_infer", route="flowtron-torch-infer (PNG left out)",
         seconds=seconds, launches=launches)


WG_CONFIG = "configs/config_waveglow.json"
WG_STEPS, WG_B = 10, 4      # steps of each precision; the config's batch


def wg_args(train_fl, out_dir, *extra):
    """The vocoder trainer's argv: config_waveglow.json with the filelist,
    the output directory, one epoch and a checkpoint at iteration 0."""
    return ["-c", WG_CONFIG, "-p", f"data_config.training_files={train_fl}",
            f"train_config.output_directory={out_dir}",
            "train_config.epochs=1", f"train_config.batch_size={WG_B}",
            "train_config.iters_per_checkpoint=1000", *extra]


def waveglow_forward_flops(wc, B, seg, hop=HOP):
    """The training forward's products: per flow the start, the one cond
    conv of all layers, the dilated and res/skip convs, the end and the
    1x1 conv over B * seg / n_group rows, and the upsample's matmul."""
    n_group, C, L = wc["n_group"], wc["n_channels"], wc["n_layers"]
    rows = B * (seg // n_group)
    flops, n_rem = 0, n_group
    for f in range(wc["n_flows"]):
        if f % wc["n_early_every"] == 0 and f > 0:
            n_rem -= wc["n_early_size"]
        h = n_rem // 2
        per_row = (2 * h * C + 2 * wc["n_mel_channels"] * n_group * 2 * C * L
                   + L * 2 * 3 * C * 2 * C + (L - 1) * 2 * C * 2 * C
                   + 2 * C * C + 2 * C * 2 * h + 2 * n_rem * n_rem)
        flops += rows * per_row
    n_mel = wc["n_mel_channels"]
    return flops + 2 * B * (seg // hop) * 4 * n_mel * n_mel * hop


def phase_waveglow_train(corpus, tmp, kernels, dev):
    """The vocoder trainer (``flowtron_tpu_torch.scripts.train_waveglow``)
    on config_waveglow.json at full width (12 flows, 8 layers, 256
    channels), B=4, 16000-sample segments of the synthetic corpus, its
    bf16 policy and fp32 (TF32 off), WG_STEPS steps each: ms a step
    (median of steps 1-9) beside the device floor of its products, peak
    memory, and no kernel launched (K2 has no backward; the training WN
    runs on cuDNN's convolutions)."""
    from flowtron_tpu_torch.scripts import train_waveglow

    fl = filelist_of(corpus[0], WG_B * WG_STEPS,
                     os.path.join(tmp, "wg_train.txt"))
    with open(WG_CONFIG) as f:
        wcfg = json.load(f)
    wc, dc = wcfg["waveglow_config"], wcfg["data_config"]
    seg = dc["segment_length"] // HOP * HOP
    step_flops = 3 * waveglow_forward_flops(wc, WG_B, seg)
    for fp16_run in (True, False):
        tag = "bf16" if fp16_run else "fp32"
        out_dir = os.path.join(tmp, f"wg_{tag}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        reset_launches(kernels)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            model, _, hist = train_waveglow.main(
                wg_args(fl, out_dir, f"train_config.fp16_run={fp16_run}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches(kernels)
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [h["loss"] for h in hist]
        check(len(hist) == WG_STEPS and all(map(math.isfinite, losses)),
              f"waveglow_train {tag}: {losses}")
        check(all(v == 0 for v in launches.values()),
              f"waveglow_train {tag}: kernels launched {launches}")
        check(os.path.exists(os.path.join(out_dir, "waveglow_0.pt")),
              f"waveglow_train {tag}: no waveglow_0.pt")
        ms = 1e3 * statistics.median(h["step_s"] for h in hist[1:])
        floor_ms = step_flops / PEAK_OPS_S[tag] * 1e3
        emit("waveglow_train", policy=tag, B=WG_B, segment=seg,
             rows=WG_B * (seg // wc["n_group"]), steps=len(hist),
             loss=losses, step_ms=[1e3 * h["step_s"] for h in hist],
             ms_per_step_median=ms, step_tflop=step_flops / 1e12,
             floor_ms=floor_ms, floor_share=floor_ms / ms,
             peak_memory_allocated_bytes=peak,
             allocated_before_run_bytes=held, wall_s=wall,
             launches=launches)
        del model
        torch.cuda.empty_cache()


def phase_waveglow_train_vs_cpu(corpus, dev):
    """One fp32 step of config_waveglow.json at full width and reduced
    depth (2 flows, 2 layers), its end convs perturbed, on one B=4 batch
    of the trainer's sampler: the card against the CPU, loss and gradient
    norm."""
    from flowtron_tpu_torch.audio.stft import MelSpectrogram
    from flowtron_tpu_torch.scripts import train_waveglow
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_init

    with open(WG_CONFIG) as f:
        wcfg = json.load(f)
    wc, dc = wcfg["waveglow_config"], wcfg["data_config"]
    model, cfg = waveglow_init(5, **dict(wc, n_flows=2, n_layers=2))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for wn in model.WN:
            wn.end.weight.copy_(0.05 * torch.randn(wn.end.weight.shape,
                                                   generator=g))
    ms = MelSpectrogram(dc["filter_length"], HOP, dc["win_length"],
                        wc["n_mel_channels"], dc["sampling_rate"],
                        dc["mel_fmin"], dc["mel_fmax"])
    seg = dc["segment_length"] // HOP * HOP
    mel, audio = train_waveglow.sample_batch(
        np.random.default_rng(0), train_waveglow.training_files(corpus[0]),
        WG_B, seg, dc, ms.mel_numpy)
    sigma = float(wcfg["train_config"]["sigma"])
    res = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model.to(d)
        model.zero_grad(set_to_none=True)
        loss = train_waveglow.waveglow_train_loss(
            model, cfg, torch.from_numpy(mel).to(d),
            torch.from_numpy(audio).to(d), sigma, None)
        loss.backward()
        gnorm = torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters()]))
        res[where] = [float(loss.detach()), float(gnorm)]
    loss_rel = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    gn_rel = abs(res["card"][1] - res["cpu"][1]) / res["cpu"][1]
    check(loss_rel <= LOSS_TOL and gn_rel <= GNORM_TOL,
          f"waveglow step card vs cpu: loss rel {loss_rel}, grad norm rel "
          f"{gn_rel}")
    emit("waveglow_train_vs_cpu", B=WG_B, segment=seg, n_flows=2,
         n_layers=2, n_channels=wc["n_channels"],
         card_loss_gradnorm=res["card"], cpu_loss_gradnorm=res["cpu"],
         loss_rel_err=loss_rel, grad_norm_rel_err=gn_rel)


def phase_waveglow_wide(corpus, tmp, kernels, dev):
    """WaveGlows wider than 256 through K2: for C in K2_WIDE, one trainer
    step at that width (``-p waveglow_config.n_channels=C``) writes
    waveglow_0.pt, which ``load_waveglow`` reads at its width and which
    vocodes a 400-frame mel at B=1 on the card: K2 n_flows * n_layers
    times a pass, the audio within K2_TOL of its scale from the same
    model's plain path on the card (``wn_layer_reference`` in K2's place).
    One step leaves the end convs near zero, where the audio hardly
    depends on the WN stack, so the model is vocoded again with them at
    0.05 * sqrt(256 / C) * normal (``perturb_heads``' 0.05 at 256
    channels, the end conv's output kept at its size), within K2_TOL too.
    At 0.05 whatever the width, a seeded 1024-channel model put kernel and
    plain 4.2e-2 of the audio's scale apart while each layer agreed within
    1.2e-5 (PERF.md §6). Returns {C: launches of the pass}."""
    from flowtron_tpu_torch.ops.wavenet import wn_layer_reference, wn_plan
    from flowtron_tpu_torch.scripts import train_waveglow
    from flowtron_tpu_torch.vocoder import waveglow as wgm

    fl = filelist_of(corpus[0], WG_B, os.path.join(tmp, "wg_one.txt"))
    paths, train_s = {}, {}
    for C in K2_WIDE:
        out_dir = os.path.join(tmp, f"wg_{C}")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train_waveglow.main(wg_args(fl, out_dir,
                                        f"waveglow_config.n_channels={C}"))
        train_s[C] = time.perf_counter() - t0
        paths[C] = os.path.join(out_dir, "waveglow_0.pt")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for C, path in paths.items():
        wg, cfg = wgm.load_waveglow(path, dev)
        check(cfg["n_channels"] == C and wg.WN[0].n_channels == C,
              f"waveglow_wide: {path} loaded at {cfg}")
        gen = torch.Generator().manual_seed(40 + C)
        Tg = N_FRAMES * HOP // cfg["n_group"]
        mel = (torch.randn(1, cfg["n_mel_channels"], N_FRAMES, generator=gen)
               - 5.0).to(dev)
        z_main = (0.8 * torch.randn(1, wgm.waveglow_n_remaining(cfg), Tg,
                                    generator=gen)).to(dev)
        z_early = [(0.8 * torch.randn(1, cfg["n_early_size"], Tg,
                                      generator=gen)).to(dev)
                   if f % cfg["n_early_every"] == 0 and f > 0 else None
                   for f in range(cfg["n_flows"])]
        wgm.waveglow_infer_z(wg, cfg, mel, z_main, z_early)   # warm-up
        torch.cuda.synchronize()
        reset_launches(kernels)
        pass_ms, audio = cuda_ms(
            lambda: wgm.waveglow_infer_z(wg, cfg, mel, z_main, z_early))
        launches = read_launches(kernels)
        n_layers = cfg["n_flows"] * cfg["n_layers"]
        check(launches["wn_layer"] == n_layers
              and sum(launches.values()) == n_layers,
              f"waveglow_wide C={C}: launches {launches}")
        kernel = wgm.wn_layer
        wgm.wn_layer = wn_layer_reference
        try:
            plain_ms, plain = cuda_ms(
                lambda: wgm.waveglow_infer_z(wg, cfg, mel, z_main, z_early))
        finally:
            wgm.wn_layer = kernel
        abs_err = float((audio - plain).abs().max())
        err = abs_err / max(1.0, float(plain.abs().max()))
        check(tuple(audio.shape) == (1, N_FRAMES * HOP)
              and bool(torch.isfinite(audio).all()) and err <= K2_TOL,
              f"waveglow_wide C={C}: audio vs plain {err}")
        g = torch.Generator().manual_seed(C)
        with torch.no_grad():
            for wn in wg.WN:
                wn.end.weight.copy_(0.05 * (256 / C) ** 0.5 * torch.randn(
                    wn.end.weight.shape, generator=g))
        heads = wgm.waveglow_infer_z(wg, cfg, mel, z_main, z_early)
        wgm.wn_layer = wn_layer_reference
        try:
            heads_plain = wgm.waveglow_infer_z(wg, cfg, mel, z_main, z_early)
        finally:
            wgm.wn_layer = kernel
        heads_scale = max(1.0, float(heads_plain.abs().max()))
        heads_err = float((heads - heads_plain).abs().max()) / heads_scale
        check(bool(torch.isfinite(heads).all()) and heads_err <= K2_TOL,
              f"waveglow_wide C={C}, end convs perturbed: audio vs plain "
              f"{heads_err}")
        emit("waveglow_wide", C=C, trainer_s=train_s[C], frames=N_FRAMES,
             plan=wn_plan(1, Tg, C, sms)._asdict(), launches=launches,
             max_abs_err=abs_err, max_rel_err=err, pass_ms=pass_ms,
             plain_pass_ms=plain_ms, heads_perturbed_rel_err=heads_err,
             heads_perturbed_audio_scale=heads_scale)
        out[C] = launches["wn_layer"]
        del wg
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# distribution: data-parallel training and replicas
# --------------------------------------------------------------------------

DDP_STEPS, DDP_B = 4, 6     # steps of the ddp runs; config.json's batch
DDP_CKPT = DDP_STEPS - 1    # their checkpoint period: iterations 0 and 3
PARAM_TOL = 1e-4            # two ranks vs one process: each tensor, of its
                            # largest (at least 1e-6: a conv bias before an
                            # instance norm has no gradient, only noise)
WG_DDP_STEPS = 3
RANKS_MODULE = "chip_smoke"  # where the ranks find ddp_rank, waveglow_rank


def no_dropout(loop):
    """Wrap ``loop.flowtron_forward`` so that the training forward draws no
    dropout (one process and two ranks draw other masks); returns the
    original to put back."""
    forward = loop.flowtron_forward

    def without(*args, **kw):
        kw["generator"] = None
        return forward(*args, **kw)
    loop.flowtron_forward = without
    return forward


def state_digest(model, optimizer=None):
    """sha256 over the model's state and the optimizer's steps and
    moments, in a fixed order: equal digests, bitwise equal states."""
    import hashlib
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    if optimizer is not None:
        for p in (p for g in optimizer.param_groups for p in g["params"]):
            s = optimizer.state.get(p, {})
            h.update(repr(float(s.get("step", -1))).encode())
            for k in ("exp_avg", "exp_avg_sq"):
                if k in s:
                    h.update(s[k].detach().cpu().contiguous().numpy()
                             .tobytes())
    return h.hexdigest()


def phase_entry():
    """``flowtron_tpu_torch.entry.entry()``: the flagship forward and loss
    at full width (B=4, T=128, Tk=48) on the card, once; a finite loss."""
    from flowtron_tpu_torch.entry import entry
    fn, args = entry()
    t0 = time.perf_counter()
    with torch.no_grad():
        loss = float(fn(*args))
    torch.cuda.synchronize()
    check(math.isfinite(loss) and args[1].is_cuda, f"entry: loss {loss}")
    emit("entry", loss=loss, seconds=time.perf_counter() - t0,
         device=str(args[1].device))
    del fn, args
    torch.cuda.empty_cache()


def ddp_rank(config):
    """One rank of phase_ddp (started by parallel/launch.py, gloo, on
    cuda:0): train(config) without dropout, TF32 off, K3's launches
    counted around it; returns them, the digest of the final state and
    rank 0's training log."""
    from flowtron_tpu_torch.ops.attention import (
        attention_scores_bwd, attention_scores_fwd)
    from flowtron_tpu_torch.parallel.mesh import rank, world_size
    from flowtron_tpu_torch.train import loop
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    no_dropout(loop)
    attention_scores_fwd.launches = attention_scores_bwd.launches = 0
    t0 = time.perf_counter()
    model, opt, _ = loop.train(config)
    torch.cuda.synchronize()
    out = {"rank": rank(), "world": world_size(),
           "device": str(next(model.parameters()).device),
           "wall_s": time.perf_counter() - t0,
           "launches": {"attention_scores_fwd": attention_scores_fwd.launches,
                        "attention_scores_bwd": attention_scores_bwd.launches},
           "digest": state_digest(model, opt)}
    if rank() == 0:
        out["log"] = read_log(config["train_config"]["output_directory"])
    return out


def read_log(out_dir):
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def ddp_config(train_fl, val_fl, out_dir, *extra):
    from flowtron_tpu_torch.config import load_config
    return load_config("config.json", [
        f"data_config.training_files={train_fl}",
        f"data_config.validation_files={val_fl}", NO_ARPABET,
        f"train_config.output_directory={out_dir}", "train_config.epochs=1",
        f"train_config.iters_per_checkpoint={DDP_CKPT}",
        "train_config.with_tensorboard=False", "train_config.fp16_run=False",
        f"train_config.batch_size={DDP_B}", *extra])


def rel(a, b):
    return abs(a - b) / abs(b)


def param_err(model, ref_state):
    """The worst tensor of ``model`` against ``ref_state`` (host tensors):
    (max-abs of its largest, at least 1e-6: a conv bias before an
    instance norm has no gradient, only noise; its name)."""
    worst, worst_name = 0.0, None
    for name, ref in ref_state.items():
        got = model.state_dict()[name].detach().cpu()
        scale = max(float(ref.abs().max()), 1e-6)
        err = float((got - ref).abs().max()) / scale
        if err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def at_rest_split(model, opt, M=2):
    """One process's bytes at rest (parameters, buffers, optimizer state)
    and the part of them in the leaves a ``model`` axis of M shards
    (parallel/mesh.py:param_shardings, with their moments)."""
    from flowtron_tpu_torch.parallel.mesh import param_shardings
    dims = param_shardings(model, M)
    state = [v for st in opt.state.values() for v in st.values()
             if torch.is_tensor(v)]
    total = nbytes([*model.parameters(), *model.buffers(), *state])
    sharded = 0
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        if dims[name] is not None:
            st = opt.state.get(t, {})
            sharded += nbytes([t, *(v for v in st.values()
                                    if torch.is_tensor(v) and v.dim())])
    return {"bytes": total, "sharded_bytes": sharded}


def phase_ddp(corpus, tmp, dev):
    """Data-parallel training: config.json's model at full width in fp32,
    dropout off, a global batch of 6 over DDP_STEPS steps of the synthetic
    corpus (its rows hold different frame counts), once in this process
    (``batch_size`` 6) and once over two ranks on cuda:0 (gloo; NCCL
    refuses two ranks on one card), each rank 3 rows (``batch_size`` 3:
    the global batch is ``batch_size`` x world). Losses (1e-4), grad norms (1e-3) and the
    validations against the one process, the final parameters within
    PARAM_TOL, the ranks bitwise equal, K3 launched on each rank; then the
    ranks' last checkpoint, a torch.distributed.checkpoint directory both
    wrote through AsyncSaver, resumed in this process: model and optimizer
    bitwise the ranks'. Gloo stages every all-reduce through the host, so
    the ranks' ms a step stands for no NVLink setup."""
    from flowtron_tpu_torch.models.flowtron import flowtron_init
    from flowtron_tpu_torch.ops.attention import (
        attention_scores_bwd, attention_scores_fwd)
    from flowtron_tpu_torch.parallel.launch import launch
    from flowtron_tpu_torch.train import loop
    from flowtron_tpu_torch.train.checkpoints import load_checkpoint
    from flowtron_tpu_torch.train.radam import (
        build_optimizer, trainable_parameters)

    train_fl = filelist_of(corpus[0], DDP_B * DDP_STEPS,
                           os.path.join(tmp, "ddp_train.txt"))
    one_dir, two_dir = (os.path.join(tmp, d) for d in ("ddp1", "ddp2"))
    forward = no_dropout(loop)
    attention_scores_fwd.launches = attention_scores_bwd.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            model, opt, _ = loop.train(ddp_config(train_fl, corpus[1],
                                                  one_dir))
        torch.cuda.synchronize()
        one_wall = time.perf_counter() - t0
    finally:
        loop.flowtron_forward = forward
    one_launches = attention_scores_fwd.launches
    one_state = {k: v.detach().cpu().clone()
                 for k, v in model.state_dict().items()}
    one = {"state": one_state, "log": read_log(one_dir), "train_fl": train_fl,
           **at_rest_split(model, opt)}
    del model, opt
    one_log = one["log"]

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ranks = launch(f"{RANKS_MODULE}:ddp_rank", 2, dict(config=ddp_config(
            train_fl, corpus[1], two_dir,
            f"train_config.batch_size={DDP_B // 2}",
            "train_config.checkpoint_format=sharded")), timeout_s=600)
    two_wall = time.perf_counter() - t0
    two_log = ranks[0]["log"]
    steps = [[r for r in log if "loss" in r] for log in (one_log, two_log)]
    vals = [[r["validation"] for r in log if "validation" in r]
            for log in (one_log, two_log)]
    check(len(steps[0]) == len(steps[1]) == DDP_STEPS,
          f"ddp: steps {[len(s) for s in steps]}")
    check(all(r["device"] == "cuda:0" and r["world"] == 2 for r in ranks),
          f"ddp: ranks {[(r['device'], r['world']) for r in ranks]}")
    loss_rel = [rel(b["loss"], a["loss"]) for a, b in zip(*steps)]
    gn_rel = [rel(b["grad_norm"], a["grad_norm"]) for a, b in zip(*steps)]
    val_rel = [rel(b["loss"], a["loss"]) for a, b in zip(*vals)]
    check(max(loss_rel) <= LOSS_TOL and max(val_rel) <= LOSS_TOL
          and max(gn_rel) <= GNORM_TOL,
          f"ddp vs one process: loss {loss_rel}, validation {val_rel}, grad "
          f"norm {gn_rel}")
    check(ranks[0]["digest"] == ranks[1]["digest"],
          "ddp: the two ranks' states differ")
    check(all(r["launches"]["attention_scores_fwd"] > 0
              and r["launches"]["attention_scores_bwd"] > 0 for r in ranks)
          and one_launches > 0,
          f"ddp: K3 not launched on every rank {[r['launches'] for r in ranks]}")

    # the ranks' directory, resumed in this process on the card
    cfg = ddp_config(train_fl, corpus[1], two_dir)
    tc = cfg["train_config"]
    model, _ = flowtron_init(int(tc["seed"]) + 1, device=dev,
                             **cfg["model_config"])
    params = [p for _, p in trainable_parameters(model)]
    opt = build_optimizer(params, tc["optim_algo"], float(tc["learning_rate"]),
                          float(tc["weight_decay"]))
    ckpt = os.path.join(two_dir, f"model_{DDP_CKPT}")
    t0 = time.perf_counter()
    it = load_checkpoint(ckpt, model, opt)
    resume_s = time.perf_counter() - t0
    check(it == DDP_CKPT and state_digest(model, opt) == ranks[0]["digest"],
          f"ddp: the directory {ckpt} did not restore the ranks' state "
          "bitwise")
    worst, worst_name = param_err(model, one_state)
    check(worst <= PARAM_TOL, f"ddp: {worst_name} {worst} of its largest "
          "from the one process's")
    files = sorted(os.listdir(ckpt))
    del model, opt
    torch.cuda.empty_cache()
    emit("ddp", world=2, backend="gloo", device="cuda:0", B_global=DDP_B,
         B_rank=DDP_B // 2, steps=DDP_STEPS, policy="fp32",
         frames=[r["frames"] for r in steps[1]],
         loss_one=[r["loss"] for r in steps[0]],
         loss_ranks=[r["loss"] for r in steps[1]], loss_rel_err=loss_rel,
         grad_norm_rel_err=gn_rel, validation_rel_err=val_rel,
         param_rel_err_max=worst, param_rel_err_tensor=worst_name,
         ranks_bitwise_equal=True, resume_bitwise=True,
         resume_s=resume_s, checkpoint_files=files,
         ms_per_step_one=1e3 * statistics.median(
             r["step_s"] for r in steps[0][1:]),
         ms_per_step_ranks=1e3 * statistics.median(
             r["step_s"] for r in steps[1][1:]),
         step_ms_one=[1e3 * r["step_s"] for r in steps[0]],
         step_ms_ranks=[1e3 * r["step_s"] for r in steps[1]],
         wall_s_one=one_wall, wall_s_ranks=two_wall,
         rank_wall_s=[r["wall_s"] for r in ranks],
         launches_one=one_launches,
         launches_ranks=[r["launches"] for r in ranks],
         note="two ranks share one card over gloo, which stages each "
              "all-reduce through the host: no NVLink or NCCL figure")
    return [r["launches"] for r in ranks], one


def waveglow_rank(argv):
    """One rank of phase_waveglow_ddp: the vocoder trainer's main, TF32
    off; its losses and step times."""
    from flowtron_tpu_torch.scripts.train_waveglow import main
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, hist = main(argv)
    return {"losses": [h["loss"] for h in hist],
            "step_s": [h["step_s"] for h in hist]}


def phase_waveglow_ddp(corpus, tmp):
    """The vocoder trainer on config_waveglow.json at full width (256
    channels, a width K2 is built for) in fp32, a global batch of WG_B over
    WG_DDP_STEPS steps: in this process and over two ranks on cuda:0
    (gloo), each rank WG_B // 2 rows of the same draw (``batch_size``
    WG_B // 2: the global batch is ``batch_size`` x world). Each step's loss
    within 1e-4 relative, the ranks' losses equal."""
    from flowtron_tpu_torch.parallel.launch import launch

    fl = filelist_of(corpus[0], WG_B * WG_DDP_STEPS,
                     os.path.join(tmp, "wg_ddp.txt"))
    argv = wg_args(fl, os.path.join(tmp, "wg_ddp"),
                   "train_config.fp16_run=False")
    one = waveglow_rank(argv)
    t0 = time.perf_counter()
    ranks = launch(f"{RANKS_MODULE}:waveglow_rank", 2, dict(
        argv=argv + [f"train_config.batch_size={WG_B // 2}"]), timeout_s=600)
    wall = time.perf_counter() - t0
    losses = [one["losses"]] + [r["losses"] for r in ranks]
    check(all(len(x) == WG_DDP_STEPS for x in losses),
          f"waveglow_ddp: steps {[len(x) for x in losses]}")
    loss_rel = [rel(b, a) for a, b in zip(losses[0], losses[1])]
    check(max(loss_rel) <= LOSS_TOL and losses[1] == losses[2],
          f"waveglow_ddp: loss rel {loss_rel}, ranks {losses[1:]}")
    emit("waveglow_ddp", world=2, backend="gloo", B_global=WG_B,
         B_rank=WG_B // 2, steps=WG_DDP_STEPS, policy="fp32",
         loss_one=losses[0], loss_ranks=losses[1], loss_rel_err=loss_rel,
         step_ms_one=[1e3 * s for s in one["step_s"]],
         step_ms_ranks=[1e3 * s for s in ranks[0]["step_s"]],
         wall_s_ranks=wall,
         note="two ranks share one card over gloo: no NVLink or NCCL "
              "figure")


TP_DIST = ("dist_config.mesh_axis_names=['data','model']",)
TP4_STEPS, TP4_FLOWS = 2, 1  # the (2, 2) grid's run: steps, flows (depth)


def tp_rank(config):
    """One rank of phase_tp_train: ddp_rank's run on a grid with a
    ``model`` axis, plus this rank's bytes at rest (parameters, buffers
    and optimizer state of its slices) as the run's TensorParallel counts
    them at its last gather."""
    from flowtron_tpu_torch.train import loop
    rest = []

    class Counted(loop.TensorParallel):
        def unshard(self):
            if self.sharded:
                rest.append(self.at_rest_bytes())
            super().unshard()
    loop.TensorParallel = Counted
    out = ddp_rank(config)
    out["at_rest_bytes"] = rest[-1]
    return out


def tp_run(config, world, tag):
    """``world`` ranks of ``tp_rank`` on cuda:0 (gloo) and their wall
    seconds."""
    from flowtron_tpu_torch.parallel.launch import launch
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        ranks = launch(f"{RANKS_MODULE}:tp_rank", world, dict(config=config),
                       timeout_s=600)
    check(all(r["device"] == "cuda:0" and r["world"] == world for r in ranks),
          f"{tag}: ranks {[(r['device'], r['world']) for r in ranks]}")
    check(all(r["launches"]["attention_scores_fwd"] > 0
              and r["launches"]["attention_scores_bwd"] > 0 for r in ranks),
          f"{tag}: K3 not launched on every rank "
          f"{[r['launches'] for r in ranks]}")
    check(len({r["digest"] for r in ranks}) == 1,
          f"{tag}: the ranks' final states differ")
    return ranks, time.perf_counter() - t0


def tp_compare(tag, one_log, ranks):
    """Losses, grad norms and validations of rank 0's log against one
    process's; returns their relative errors."""
    logs = (one_log, ranks[0]["log"])
    steps = [[r for r in log if "loss" in r] for log in logs]
    vals = [[r["validation"] for r in log if "validation" in r]
            for log in logs]
    check(len(steps[0]) == len(steps[1]) > 0,
          f"{tag}: steps {[len(x) for x in steps]}")
    err = {"loss": [rel(b["loss"], a["loss"]) for a, b in zip(*steps)],
           "grad_norm": [rel(b["grad_norm"], a["grad_norm"])
                         for a, b in zip(*steps)],
           "validation": [rel(b["loss"], a["loss"]) for a, b in zip(*vals)]}
    check(max(err["loss"]) <= LOSS_TOL and max(err["validation"]) <= LOSS_TOL
          and max(err["grad_norm"]) <= GNORM_TOL, f"{tag} vs one process: "
          f"{err}")
    return err, steps


def tp_resume(tag, cfg, out_dir, it, digest, dev):
    """The ranks' last directory resumed in this process: model and
    optimizer bitwise the ranks' (gathered) state; returns the model."""
    from flowtron_tpu_torch.models.flowtron import flowtron_init
    from flowtron_tpu_torch.train.checkpoints import load_checkpoint
    from flowtron_tpu_torch.train.radam import (
        build_optimizer, trainable_parameters)
    tc = cfg["train_config"]
    model, _ = flowtron_init(int(tc["seed"]) + 1, device=dev,
                             **cfg["model_config"])
    opt = build_optimizer([p for _, p in trainable_parameters(model)],
                          tc["optim_algo"], float(tc["learning_rate"]),
                          float(tc["weight_decay"]))
    ckpt = os.path.join(out_dir, f"model_{it}")
    check(load_checkpoint(ckpt, model, opt) == it
          and state_digest(model, opt) == digest,
          f"{tag}: the directory {ckpt} did not restore the ranks' state "
          "bitwise")
    return model


def phase_tp_train(corpus, tmp, one, dev):
    """Tensor parallelism: config.json's model at full width in fp32,
    dropout off, ddp's global batch of 6 over DDP_STEPS steps, on a (1, 2)
    data x model grid of two gloo ranks on cuda:0, each loading the 6 rows
    (``batch_size`` 3: the global batch is ``batch_size`` x world), against
    phase_ddp's one process: losses and validations 1e-4, grad norms 1e-3,
    the parameters within PARAM_TOL, the ranks' states bitwise alike, K3
    on each rank, each rank's bytes at rest beside one process's and the
    split the code predicts (the sharded leaves' share halved); the ranks'
    directory resumed here bitwise. Then a (2, 2) grid of four ranks at
    TP4_FLOWS flow(s) (the depth cut), TP4_STEPS steps of a global batch of
    4, against one process at that depth, and its directory resumed
    bitwise. Gloo stages each collective through the host: the ms a step
    stand for no NVLink setup."""
    from flowtron_tpu_torch.train import loop
    out_dir = os.path.join(tmp, "tp12")
    cfg = ddp_config(one["train_fl"], corpus[1], out_dir,
                     f"train_config.batch_size={DDP_B // 2}",
                     "dist_config.mesh_shape=[1,2]", *TP_DIST,
                     "train_config.checkpoint_format=sharded")
    ranks, wall = tp_run(cfg, 2, "tp_train")
    err, steps = tp_compare("tp_train", one["log"], ranks)
    model = tp_resume("tp_train", cfg, out_dir, DDP_CKPT, ranks[0]["digest"],
                      dev)
    worst, worst_name = param_err(model, one["state"])
    check(worst <= PARAM_TOL, f"tp_train: {worst_name} {worst} of its "
          "largest from the one process's")
    del model
    torch.cuda.empty_cache()
    predicted = one["bytes"] - one["sharded_bytes"] // 2
    rest = [r["at_rest_bytes"] for r in ranks]
    check(rest == [predicted] * 2, f"tp_train: at rest {rest} bytes a rank, "
          f"predicted {predicted} (one process {one['bytes']})")

    # the (2, 2) grid, four ranks, at reduced depth
    fl4 = filelist_of(corpus[0], 4 * TP4_STEPS, os.path.join(tmp, "tp4.txt"))
    small = (f"model_config.n_flows={TP4_FLOWS}",
             f"train_config.iters_per_checkpoint={TP4_STEPS - 1}")
    one4_dir, out4 = (os.path.join(tmp, d) for d in ("tp4_one", "tp4"))
    forward = no_dropout(loop)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            loop.train(ddp_config(fl4, corpus[1], one4_dir, *small,
                                  "train_config.batch_size=4"))
    finally:
        loop.flowtron_forward = forward
    torch.cuda.empty_cache()
    cfg4 = ddp_config(fl4, corpus[1], out4, *small,
                      "train_config.batch_size=1",
                      "dist_config.mesh_shape=[2,2]", *TP_DIST,
                      "train_config.checkpoint_format=sharded")
    ranks4, wall4 = tp_run(cfg4, 4, "tp_train 2x2")
    err4, steps4 = tp_compare("tp_train 2x2", read_log(one4_dir), ranks4)
    tp_resume("tp_train 2x2", cfg4, out4, TP4_STEPS - 1, ranks4[0]["digest"],
              dev)
    torch.cuda.empty_cache()
    emit("tp_train", grid={"data": 1, "model": 2}, world=2, backend="gloo",
         device="cuda:0", B_global=DDP_B, rows_a_rank=DDP_B,
         steps=DDP_STEPS, policy="fp32",
         loss_one=[r["loss"] for r in steps[0]],
         loss_ranks=[r["loss"] for r in steps[1]],
         loss_rel_err=err["loss"], grad_norm_rel_err=err["grad_norm"],
         validation_rel_err=err["validation"], param_rel_err_max=worst,
         param_rel_err_tensor=worst_name, ranks_bitwise_equal=True,
         resume_bitwise=True, at_rest_bytes_one=one["bytes"],
         at_rest_bytes_ranks=rest, at_rest_bytes_predicted=predicted,
         sharded_share_predicted=one["sharded_bytes"] / one["bytes"],
         ms_per_step_one=1e3 * statistics.median(
             r["step_s"] for r in steps[0][1:]),
         ms_per_step_ranks=1e3 * statistics.median(
             r["step_s"] for r in steps[1][1:]),
         step_ms_ranks=[1e3 * r["step_s"] for r in steps[1]],
         wall_s_ranks=wall, launches_ranks=[r["launches"] for r in ranks],
         grid_2x2=dict(world=4, n_flows=TP4_FLOWS, steps=TP4_STEPS,
                       B_global=4, loss_rel_err=err4["loss"],
                       grad_norm_rel_err=err4["grad_norm"],
                       validation_rel_err=err4["validation"],
                       step_ms_ranks=[1e3 * r["step_s"] for r in steps4[1]],
                       at_rest_bytes_ranks=[r["at_rest_bytes"]
                                            for r in ranks4],
                       wall_s_ranks=wall4, resume_bitwise=True,
                       launches_ranks=[r["launches"] for r in ranks4]),
         note="the ranks share one card over gloo, which stages each "
              "collective through the host: no NVLink or NCCL figure")
    return [r["launches"] for r in ranks]


MESH_B = 4          # serve_mesh: the batch of the (2, 2) engine's chain


def phase_serve_mesh(ft_path, wg_path, kernels, dev):
    """The serving mesh. The CLI with ``--mesh 1,1`` beside ``--replicas
    2 --vocode-buckets 120,240 --fused --warmup``: JAX's three warnings
    print, a wave is answered, K1 launched 0 times and K2 on every
    request. Then an engine at mesh_shape (2, 2) on ``devices=[cuda:0] *
    4`` (the flows' sharded leaves split over four views of the card)
    against the same engine without a mesh, on the same seeds and a
    per-row temperature (so both run the per-frame loop): the mel within
    1e-4 (TF32 off), n_valid identical, the audio within 1e-4 of its
    scale; then a wave through its dispatcher, requests/s, K1 0 and K2
    launched."""
    from flowtron_tpu_torch.config import load_config
    from flowtron_tpu_torch.serve import SynthesisEngine
    from flowtron_tpu_torch.serve.cli import build_server
    from flowtron_tpu_torch.utils.weights import ShardedWeight

    bodies = [{"text": t, "seed": REQ_SEED + 40 + i}
              for i, t in enumerate(TEXTS)]
    argv = ["-c", "config.json", "-f", ft_path, "-w", wg_path, "--port",
            "0", "--n-frames", str(N_FRAMES), "--mesh", "1,1", "--replicas",
            "2", "--vocode-buckets", "120,240", "--fused", "--warmup", "-p",
            NO_ARPABET]
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        server, engines = build_server(argv, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        torch.cuda.synchronize()
        reset_launches(kernels)
        results, cli_wall = wave_of(url, bodies)
        torch.cuda.synchronize()
        cli_launches = read_launches(kernels)
        check_answers("serve_mesh --mesh 1,1", bodies, results, N_FRAMES)
        eng = engines["default"]
        decided = (eng._n_replicas, eng._vocode_buckets, eng.fused)
    finally:
        server.shutdown()
        server.server_close()
        for e in engines.values():
            e.shutdown()
        thread.join(timeout=60)
        torch.cuda.empty_cache()
    warnings_ = [w for w in (
        "WARNING: --replicas is incompatible with --mesh; ignoring replicas",
        "WARNING: --vocode-buckets is not supported with --mesh; using the "
        "one-dispatch chain",
        "WARNING: --fused is incompatible with --mesh (VMEM-resident kernel "
        "vs TP-sharded weights); disabling fused") if w in said.getvalue()]
    check(len(warnings_) == 3 and decided == (1, None, False),
          f"serve_mesh: warnings {said.getvalue()!r}, decisions {decided}")
    check(cli_launches["fused_flow_infer"] == 0
          and cli_launches["wn_layer"] > 0,
          f"serve_mesh --mesh 1,1: {cli_launches}")

    config = load_config("config.json", [NO_ARPABET])
    kw = dict(max_batch=MESH_B, n_frames=N_FRAMES, device=dev)
    flat = SynthesisEngine(config, ft_path, wg_path, **kw)
    mesh = SynthesisEngine(config, ft_path, wg_path, mesh_shape=(2, 2),
                           devices=[dev] * 4, **kw)
    try:
        w = mesh._groups[1].model.flows[0].lstm.weight_ih_l0
        check(isinstance(w, ShardedWeight) and len(w.parts) == 2,
              f"serve_mesh: the flows' LSTM weight is {type(w).__name__}")
        ids = np.asarray(mesh.frontend.get_text(TEXTS[0]))
        B = MESH_B
        text = np.zeros((B, 128), np.int64)
        text[:, :len(ids)] = ids
        args = (np.arange(B) + REQ_SEED, np.full(B, SIGMA, np.float32),
                np.zeros(B, np.int64), text, np.full(B, len(ids)),
                np.ones((B, 1), np.float32), np.full(B, N_FRAMES))
        strengths = np.zeros(B, np.float32)
        reset_launches(kernels)
        mel0, nv0 = flat._synth_mel(*args)
        pcm0 = flat._vocode_norm(mel0, nv0, args[0], strengths)
        n = B // 2
        mels, nvs = [], []
        for g, rep in enumerate(mesh._groups):
            r = slice(g * n, (g + 1) * n)
            m, v = mesh._synth_mel(*(a[r] for a in args), rep)
            mels.append(m.to(dev))
            nvs.append(v.to(dev))
        mel1, nv1 = torch.cat(mels), torch.cat(nvs)
        _, pcm1, nv2 = mesh._mesh_chain(*args, strengths)
        torch.cuda.synchronize()
        chain_launches = read_launches(kernels)
        mel_err = float((mel1 - mel0).abs().max())
        audio_err = float((pcm1.float() - pcm0.float()).abs().max()) / 32767
        check(torch.equal(nv0, nv1) and torch.equal(nv0, nv2)
              and mel_err <= 1e-4 and audio_err <= 1e-4,
              f"serve_mesh (2, 2) vs no mesh: mel {mel_err}, audio "
              f"{audio_err} of its scale, n_valid {nv0.tolist()} / "
              f"{nv1.tolist()} / {nv2.tolist()}")

        torch.cuda.synchronize()
        reset_launches(kernels)
        t0 = time.perf_counter()
        outs = [None] * len(TEXTS)

        def run(i):
            outs[i] = mesh.submit(TEXTS[i], 0, seed=REQ_SEED + 50 + i)
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(TEXTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mesh_launches = read_launches(kernels)
        check(all(o is not None and len(o[0]) > 0 for o in outs)
              and mesh_launches["fused_flow_infer"] == 0
              and mesh_launches["wn_layer"] > 0,
              f"serve_mesh (2, 2) wave: {mesh_launches}")
        metrics = mesh.metrics()
    finally:
        flat.shutdown()
        mesh.shutdown()
        torch.cuda.empty_cache()
    emit("serve_mesh", cli_mesh=[1, 1], cli_warnings=warnings_,
         cli_requests=len(bodies), cli_wall_s=cli_wall,
         cli_requests_per_s=len(bodies) / cli_wall,
         cli_launches=cli_launches, engine_mesh=[2, 2],
         devices="cuda:0 x 4", chain_B=B, mel_max_abs_err=mel_err,
         audio_err_of_scale=audio_err, n_valid=nv0.tolist(),
         chain_launches=chain_launches, requests=len(TEXTS), wall_s=wall,
         requests_per_s=len(TEXTS) / wall, batches=metrics["batches"],
         launches=mesh_launches,
         note="four views of one card: no second-card or NVLink figure")
    return mesh_launches


def post_pcm(url, body):
    """POST /synthesize; the answer's PCM bytes."""
    req = urllib.request.Request(url + "/synthesize",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
    with wave.open(io.BytesIO(data)) as w:
        return w.readframes(w.getnframes())


def phase_serve_replicas(ft_path, wg_path, kernels):
    """The server with ``--replicas auto`` (one replica a visible card):
    a wave of concurrent requests, ``/metrics``' replica_batches summing to
    the batches served, then three requests one at a time; then with
    ``--replicas 2``: the clamp warning where the machine has one card, and
    the same three requests answered bitwise alike."""
    from flowtron_tpu_torch.serve.cli import build_server

    bodies = [{"text": t, "seed": REQ_SEED + 30 + i}
              for i, t in enumerate(TEXTS)]
    singles = bodies[:3]
    out = {}
    for replicas in ("auto", "2"):
        argv = ["-c", "config.json", "-f", ft_path, "-w", wg_path,
                "--port", "0", "--replicas", replicas, "-p", NO_ARPABET]
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            server, engines = build_server(argv, host="127.0.0.1")
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            eng = engines["default"]
            torch.cuda.synchronize()
            reset_launches(kernels)
            t0 = time.perf_counter()
            results, wall = wave_of(url, bodies)
            pcm = [post_pcm(url, b) for b in singles]
            torch.cuda.synchronize()
            launches = read_launches(kernels)
            check_answers(f"serve_replicas {replicas}", bodies, results,
                          N_FRAMES)
            # the completion thread hands out the audio, then counts the
            # batch: wait for the last count
            deadline = time.monotonic() + 30
            metrics = get_json(url, "/metrics")
            while metrics["requests"] < len(bodies) + len(singles) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
                metrics = get_json(url, "/metrics")
        finally:
            server.shutdown()
            server.server_close()
            for e in engines.values():
                e.shutdown()
            thread.join(timeout=60)
            torch.cuda.empty_cache()
        out[replicas] = dict(
            replicas=eng._n_replicas, said=said.getvalue(), pcm=pcm,
            wall_s=wall, latency_s=[r[1] for r in results],
            requests=len(bodies) + len(singles), metrics=metrics,
            launches=launches, seconds=time.perf_counter() - t0)
        check(sum(metrics["replica_batches"]) == metrics["batches"]
              and metrics["requests"] == len(bodies) + len(singles),
              f"serve_replicas {replicas}: {metrics}")
        check(launches["fused_flow_infer"] > 0 and launches["wn_layer"] > 0,
              f"serve_replicas {replicas}: {launches}")
    n = torch.cuda.device_count()
    check(out["auto"]["replicas"] == n and out["2"]["replicas"] == min(2, n),
          f"serve_replicas: {out['auto']['replicas']} / "
          f"{out['2']['replicas']} replicas on {n} cards")
    if n < 2:
        check(f"WARNING: --replicas 2 > {n} local devices; clamping"
              in out["2"]["said"], f"serve_replicas: no clamp warning in "
              f"{out['2']['said']!r}")
    check(out["auto"]["pcm"] == out["2"]["pcm"],
          "serve_replicas: --replicas 2 answered otherwise than auto")
    emit("serve_replicas", cards=n, **{
        f"replicas_{k}": {key: v[key] for key in (
            "replicas", "wall_s", "latency_s", "requests", "launches",
            "seconds")} | {"replica_batches": v["metrics"]["replica_batches"],
                           "batches": v["metrics"]["batches"]}
        for k, v in out.items()},
        clamp_warning=out["2"]["said"].strip().splitlines()[:1],
        answers_bitwise_equal=True)
    return out["auto"]["launches"]


# -- slice 17: style transfer, runtime voices, /profile, the native mel ----
ST_REFS = 4            # style references: the corpus's first utterances
ST_SEED = 1700         # numpy seed of the style-transfer noise
ST_CPU_FRAMES = 64     # frames of the card vs CPU style transfer
MEM_TOL = 64 * 2 ** 20  # device bytes an unloaded voice may leave behind
NATIVE_TOL = 1e-5      # native vs numpy log-mel: 1e-5 plus 1e-5 of the value
NATIVE_WAVS = 16       # corpus wavs the native mel is held on
K1_K2_KERNELS = ("k1_kernel", "wn_layer_kernel")   # decoder.cu, wavenet.cu


def phase_style_transfer(train_fl, config, ids, kernels, smi, dev):
    """Style transfer (infer/style_transfer.py) at config.json's full
    width, seeded weights with the heads perturbed and the gate biased off:
    ST_REFS corpus utterances are the references, TEXTS[1] the target,
    N_FRAMES frames, sigma SIGMA, the noise from a numpy seed. K3's forward
    in ``collect_z``, K1 once a flow in the inversion; the entry point
    against its parts; the card against the CPU's plain path on the same
    noise at ST_CPU_FRAMES frames; the card run's maps fed back through
    ``attns=``: the loop, no K1, mel within K1_TOL of the K1 run."""
    import copy
    from flowtron_tpu_torch.data.collate import DataCollate
    from flowtron_tpu_torch.data.dataset import Data, data_kwargs
    from flowtron_tpu_torch.infer.style_transfer import (
        collect_z, posterior_mean, style_transfer)
    from flowtron_tpu_torch.models.flowtron import (
        flowtron_infer, flowtron_init)

    model, cfg = flowtron_init(1234, **config["model_config"])
    perturb_flow_heads(model, torch.Generator().manual_seed(17))
    # random weights end an utterance within its first frames (the gate
    # fires at once); bias it off, as phase_slice does, so every
    # comparison below spans all the frames. The CPU tests hold a gate
    # that fires against the JAX package.
    with torch.no_grad():
        model.flows[-1].ar_step.gate_layer.linear_layer.bias.fill_(-20.0)
    model.to(dev)
    data = Data(train_fl, **data_kwargs(dict(config["data_config"],
                                             p_arpabet=0.0)))
    batch = DataCollate(use_attn_prior=False)(
        [data[i] for i in range(ST_REFS)])
    noise = np.random.default_rng(ST_SEED).standard_normal(
        (1, 80, N_FRAMES)).astype(np.float32)
    text, sid = ids[1], 0
    refs = [torch.as_tensor(batch[k], device=dev) for k in (
        "mel", "speaker_ids", "text", "in_lens", "out_lens")]
    collect_z(model, cfg, *refs)                 # warm-up: cuDNN, cuBLAS
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    z = collect_z(model, cfg, *refs)
    torch.cuda.synchronize()
    collect_ms = (time.perf_counter() - t0) * 1e3
    collect_launches = read_launches(kernels)
    z = z.cpu().numpy()
    mu = posterior_mean([z[:int(L), b] for b, L in
                         enumerate(batch["out_lens"])], batch["out_lens"],
                        N_FRAMES)
    residual = torch.as_tensor(mu[None] + SIGMA * noise, device=dev)
    sids = torch.tensor([sid], device=dev)
    text_t = torch.as_tensor(text[None], device=dev)
    reset_launches(kernels)
    t0 = time.perf_counter()
    mel, attns, n_valid = flowtron_infer(model, cfg, residual, sids, text_t)
    torch.cuda.synchronize()
    invert_ms = (time.perf_counter() - t0) * 1e3
    invert_launches = read_launches(kernels)
    check(collect_launches["attention_scores_fwd"] > 0
          and collect_launches["fused_flow_infer"] == 0,
          f"style_transfer collect_z: {collect_launches}")
    check(invert_launches["fused_flow_infer"] == 2,
          f"style_transfer inversion: {invert_launches}")
    n = int(n_valid[0])
    check(n == N_FRAMES and bool(torch.isfinite(mel).all()),
          f"style_transfer: n {n}, finite {bool(torch.isfinite(mel).all())}")
    t0 = time.perf_counter()
    st_mel, st_n = style_transfer(model, cfg, batch, text, sid,
                                  n_frames=N_FRAMES, sigma=SIGMA, noise=noise,
                                  device=dev)
    entry_ms = (time.perf_counter() - t0) * 1e3
    entry_err = float(np.abs(st_mel - mel[0, :, :n].cpu().numpy()).max())
    check(st_n == n and entry_err <= K1_TOL,
          f"style_transfer entry point vs its parts: n {st_n} / {n}, "
          f"mel {entry_err}")

    # the card run's maps fed back: the loop (JAX's routing), never K1
    reset_launches(kernels)
    t0 = time.perf_counter()
    fed, _, fed_nv = flowtron_infer(model, cfg, residual, sids, text_t,
                                    attns=list(reversed(attns)))
    torch.cuda.synchronize()
    fed_ms = (time.perf_counter() - t0) * 1e3
    fed_launches = read_launches(kernels)
    fed_err = float((fed - mel).abs().max())
    check(fed_launches["fused_flow_infer"] == 0,
          f"style_transfer with external maps reached K1: {fed_launches}")
    check(torch.equal(fed_nv, n_valid) and fed_err <= K1_TOL,
          f"maps fed back: n_valid {fed_nv.tolist()} / {n_valid.tolist()}, "
          f"mel {fed_err}")

    # card vs the CPU's plain path, on the same noise, short
    Nc = ST_CPU_FRAMES
    outs = {}
    cpu_model = copy.deepcopy(model).cpu()
    for where, m, d in (("card", model, dev),
                        ("cpu", cpu_model, torch.device("cpu"))):
        t0 = time.perf_counter()
        outs[where] = style_transfer(m, cfg, batch, text, sid, n_frames=Nc,
                                     sigma=SIGMA, noise=noise[:, :, :Nc],
                                     device=d) + (time.perf_counter() - t0,)
    scale = max(1.0, float(np.abs(outs["cpu"][0]).max()))
    cpu_err = float(np.abs(outs["card"][0] - outs["cpu"][0]).max()) / scale \
        if outs["card"][1] == outs["cpu"][1] else float("inf")
    check(outs["card"][1] == outs["cpu"][1] == Nc and cpu_err <= SLICE_TOL,
          f"style_transfer card vs cpu: n {outs['card'][1]} / "
          f"{outs['cpu'][1]}, mel {cpu_err}")
    del model, cpu_model
    torch.cuda.empty_cache()
    emit("style_transfer", nvidia_smi=smi, references=ST_REFS,
         reference_frames=[int(x) for x in batch["out_lens"]],
         target_text_len=len(text), n_frames=N_FRAMES, sigma=SIGMA,
         n_valid=n, collect_z_ms=collect_ms, inversion_ms=invert_ms,
         entry_point_ms=entry_ms, maps_fed_back_ms=fed_ms,
         max_abs_err_entry_vs_parts=entry_err,
         max_abs_err_maps_fed_back=fed_err,
         card_vs_cpu=dict(n_frames=Nc, n_valid=outs["cpu"][1],
                          max_err_of_scale=cpu_err,
                          card_s=outs["card"][2], cpu_s=outs["cpu"][2]),
         collect_z_launches=collect_launches,
         inversion_launches=invert_launches,
         maps_fed_back_launches=fed_launches)
    return {k: collect_launches[k] + invert_launches[k]
            for k in collect_launches}


def call_json(url, path, body=None, method="POST"):
    """(status, JSON answer) of one request, error answers included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve_admin(ft_path, wg_path, kernels, smi, tmp):
    """One server built in-process by ``build_server`` with a vocoder, no
    ``--model`` and ``--profiler-port``: ``serve_models`` (runtime loads and
    unloads) then ``serve_profile`` (trace capture, and
    ``--compile-cache`` in two subprocesses). Returns the launches of
    each."""
    from flowtron_tpu_torch.serve.cli import build_server

    port = free_port()
    server, engines = build_server(
        ["-c", "config.json", "-f", ft_path, "-w", wg_path, "--port", "0",
         "--max-batch", "4", "--warmup", "--profiler-port", str(port),
         "-p", NO_ARPABET], host="127.0.0.1")
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        models = phase_serve_models(url, ft_path, wg_path, engines, kernels,
                                    smi)
        profile = phase_serve_profile(url, f"http://127.0.0.1:{port}",
                                      ft_path, kernels, smi, tmp)
    finally:
        server.shutdown()
        server.server_close()
        server.profiler_server.shutdown()
        server.profiler_server.server_close()
        for eng in list(engines.values()):
            eng.shutdown()
        torch.cuda.empty_cache()
    return models, profile


def phase_serve_models(url, ft_path, wg_path, engines, kernels, smi):
    """``POST /models`` of a second voice on the saved files; a request to
    it against the same request to the default voice, bitwise; two
    concurrent loads of a third name (one 200, one 409); ``DELETE`` of both
    gives the device memory back (within MEM_TOL after ``gc.collect()``);
    the last voice 409, an unknown one 404."""
    import gc
    body = {"text": TEXTS[2], "seed": REQ_SEED + 40}
    default_pcm = post_pcm(url, body)            # warm, before the baseline
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    spec = {"config": "config.json", "checkpoint": ft_path,
            "vocoder": wg_path}
    t0 = time.perf_counter()
    loaded = call_json(url, "/models", dict(spec, name="second"))
    load_s = time.perf_counter() - t0
    check(loaded == (200, {"loaded": "second", "can_stream": True}),
          f"serve_models: load {loaded}")
    mem_loaded = torch.cuda.memory_allocated()
    reset_launches(kernels)
    second_pcm = post_pcm(url, dict(body, model="second"))
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    check(second_pcm == default_pcm and len(second_pcm) > 0,
          "serve_models: the loaded voice answered otherwise than the "
          "default on the same checkpoint and seed")
    check(launches["fused_flow_infer"] > 0 and launches["wn_layer"] > 0,
          f"serve_models: {launches}")
    answers = [None, None]

    def load(i):
        answers[i] = call_json(url, "/models", dict(spec, name="third"))

    threads = [threading.Thread(target=load, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(sorted(a[0] for a in answers) == [200, 409],
          f"serve_models: concurrent loads {answers}")
    listed = get_json(url, "/models")
    unloads = [call_json(url, f"/models/{name}", method="DELETE")
               for name in ("third", "second")]
    check([u[0] for u in unloads] == [200, 200], f"serve_models: {unloads}")
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    check(abs(mem1 - mem0) <= MEM_TOL,
          f"serve_models: {mem1 - mem0} bytes left after the unloads")
    last = call_json(url, "/models/default", method="DELETE")
    unknown = call_json(url, "/models/nobody", method="DELETE")
    check(last[0] == 409 and unknown[0] == 404,
          f"serve_models: last {last}, unknown {unknown}")
    check(list(engines) == ["default"], f"serve_models: {list(engines)}")
    emit("serve_models", nvidia_smi=smi, load_s=load_s,
         concurrent_loads=[a[0] for a in answers],
         resident_at_most=[m["name"] for m in listed["models"]],
         memory_allocated_before_mb=mem0 / 2 ** 20,
         memory_allocated_loaded_mb=mem_loaded / 2 ** 20,
         memory_allocated_after_unload_mb=mem1 / 2 ** 20,
         unload_answers=[u[1] for u in unloads], last_voice=last[0],
         unknown_voice=unknown[0], answers_bitwise_equal=True,
         launches=launches)
    return launches


def trace_counts(path, names):
    """From a Chrome trace: the GPU kernels whose names contain each of
    ``names``, counted, and the trace's event count."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {n: sum(n in k for k in kernels) for n in names}, len(events)


def phase_serve_profile(url, purl, ft_path, kernels, smi, tmp):
    """``POST /profile {"seconds": 2}`` during waves of ``/synthesize``: 200
    and a trace naming K1's and K2's kernels; a second capture meanwhile
    409; the same capture through ``--profiler-port`` 200. Then
    ``--compile-cache``: a subprocess with an empty DIR builds decoder.cu
    into it, a second reuses it (its build_seconds 0.0)."""
    stop = threading.Event()
    waves = []

    def traffic():
        while not stop.is_set():
            waves.append(wave_of(url, [{"text": t, "seed": REQ_SEED + 60 + k}
                                       for k, t in enumerate(TEXTS)])[1])

    trace_dir = os.path.join(tmp, "profile")
    captured = []
    capture = threading.Thread(target=lambda: captured.append(call_json(
        url, "/profile", {"seconds": 2, "dir": trace_dir})))
    reset_launches(kernels)
    capture.start()
    time.sleep(0.2)
    load = threading.Thread(target=traffic)
    load.start()
    time.sleep(0.5)
    second = call_json(url, "/profile", {"seconds": 0.1})
    capture.join(120)
    stop.set()
    load.join(600)
    torch.cuda.synchronize()
    launches = read_launches(kernels)
    check(captured and captured[0] == (200, {"trace_dir": trace_dir,
                                              "seconds": 2.0}),
          f"serve_profile: capture {captured}")
    check(second[0] == 409, f"serve_profile: second capture {second}")
    counts, n_events = trace_counts(os.path.join(trace_dir, "trace.json"),
                                    K1_K2_KERNELS)
    check(all(counts[k] > 0 for k in K1_K2_KERNELS),
          f"serve_profile: the trace misses K1 or K2: {counts}")
    port_dir = os.path.join(tmp, "profile_port")
    via_port = call_json(purl, "/profile", {"seconds": 0.5,
                                            "dir": port_dir})
    check(via_port == (200, {"trace_dir": port_dir, "seconds": 0.5})
          and os.path.exists(os.path.join(port_dir, "trace.json")),
          f"serve_profile: --profiler-port {via_port}")

    cache = os.path.join(tmp, "compile_cache")
    code = (
        "import json, sys\n"
        "from flowtron_tpu_torch.ops import _build\n"
        "from flowtron_tpu_torch.serve.cli import build_server\n"
        f"server, engines = build_server(['-c', 'config.json', '-f', "
        f"{ft_path!r}, '--port', '0', '--max-batch', '1', '--n-frames', "
        f"'8', '--warmup', '--compile-cache', {cache!r}], "
        "host='127.0.0.1')\n"
        "server.server_close()\n"
        "[e.shutdown() for e in engines.values()]\n"
        "print(json.dumps({'build_dir': str(_build.BUILD_DIR), "
        "'build_seconds': _build.build_seconds}))\n")
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=600)
        check(r.returncode == 0, f"--compile-cache run: {r.stderr[-2000:]}")
        runs.append(dict(json.loads(r.stdout.strip().splitlines()[-1]),
                         wall_s=time.perf_counter() - t0))
    libs = sorted(os.listdir(cache))
    check(all(os.path.realpath(r["build_dir"]) == os.path.realpath(cache)
              for r in runs)
          and runs[0]["build_seconds"].get("decoder", 0) > 0
          and runs[1]["build_seconds"].get("decoder") == 0.0
          and any(lib.startswith("decoder-") for lib in libs),
          f"--compile-cache: {runs}, {libs}")
    emit("serve_profile", nvidia_smi=smi, seconds=2.0, waves=len(waves),
         wave_wall_s=waves, trace_kernels=counts, trace_events=n_events,
         second_capture=second[0], profiler_port=via_port[0],
         launches=launches, compile_cache=dict(
             libraries=libs, runs=[{k: r[k] for k in (
                 "build_seconds", "wall_s")} for r in runs]))
    return launches


def phase_native_mel(train_fl, config):
    """The port's native library (native/mel.cpp) built with g++ on the
    card machine's host; NativeMel against the numpy mel on NATIVE_WAVS
    corpus wavs, decode_wav against scipy bitwise, Data(use_native=True)
    items against the numpy path's; ms a mel each way (host times)."""
    from scipy.io import wavfile
    from flowtron_tpu_torch import native
    from flowtron_tpu_torch.audio.stft import MelSpectrogram
    from flowtron_tpu_torch.data.dataset import Data, data_kwargs
    from flowtron_tpu_torch.ops import _build

    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    with open(train_fl) as f:
        paths = [line.split("|")[0] for line in f][:NATIVE_WAVS]
    ms = MelSpectrogram()
    nm = native.NativeMel(ms.window, ms.mel_basis)
    mel_err = rel_worst = 0.0
    t_native = t_numpy = 0.0
    for path in paths:
        sr, pcm = wavfile.read(path)
        dec, dsr = native.decode_wav(path)
        check(dsr == sr and np.array_equal(dec, pcm.astype(np.float32)),
              f"native_mel: decode_wav differs from scipy on {path}")
        audio = dec / 32768.0
        t0 = time.perf_counter()
        a = nm(audio)
        t_native += time.perf_counter() - t0
        t0 = time.perf_counter()
        b = ms.mel_numpy(audio)
        t_numpy += time.perf_counter() - t0
        mel_err = max(mel_err, float(np.abs(a - b).max()))
        rel_worst = max(rel_worst, float(
            (np.abs(a - b) / (NATIVE_TOL + NATIVE_TOL * np.abs(b))).max()))
    check(rel_worst <= 1.0, f"native_mel: max abs {mel_err}, bar ratio "
          f"{rel_worst}")
    kw = data_kwargs(dict(config["data_config"], p_arpabet=0.0))
    nat = Data(train_fl, **dict(kw, use_native=True))
    plain = Data(train_fl, **kw)
    check(nat._native_mel is not None, "native_mel: Data fell back to numpy")
    item_err = 0.0
    for i in range(4):
        a, b = nat[i], plain[i]
        check(np.allclose(a[0], b[0], atol=NATIVE_TOL, rtol=NATIVE_TOL)
              and np.array_equal(a[2], b[2]) and a[1] == b[1],
              f"native_mel: Data item {i}")
        item_err = max(item_err, float(np.abs(a[0] - b[0]).max()))
    emit("native_mel", cpu=_build._cpu_model(), cpu_count=os.cpu_count(),
         build_s=build_s, wavs=len(paths), max_abs_err=mel_err,
         bar_ratio=rel_worst, data_items_max_abs_err=item_err,
         native_ms_per_mel=t_native / len(paths) * 1e3,
         numpy_ms_per_mel=t_numpy / len(paths) * 1e3,
         native_threads=nm.n_threads)


def probe_check(tag, out, ref, tol):
    """max |out - ref| within ``tol`` of ref's largest magnitude; returns
    the absolute error."""
    out, ref = out.float(), ref.float()
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    check(math.isfinite(err) and err <= tol * scale,
          f"{tag}: err {err} against {tol} x scale {scale}")
    return err


def probe_bound(n_bytes, n_ops, kind, steps):
    """``bound`` for a whole call of ``steps`` steps, per step."""
    ms, by = bound(n_bytes, n_ops, kind)
    return ms / steps, by


def probes_w4(side, dev):
    """P1's five bodies once each at the script's shape (B=64, 1664 x
    4096), kernel, plain and cuBLAS on the pre-dequantized bf16 weight
    timed in CUDA graphs; P2's two bodies as one scan step (the dot and
    the bf16 carry update) against the plain step and the script's XLA
    baseline for the same quantization (``dot_w4_rows`` takes its group
    from s's rows: 128 for concat, 64 for 2dot). bf16 outputs within
    PROBE_BF16_TOL of their scale over 16 steps. Returns the kernel
    table's fields."""
    from flowtron_tpu_torch.ops.w4 import (
        BODIES, dequantize, w4_matmul, w4_matmul_reference)
    from flowtron_tpu_torch.scripts import _probe
    from flowtron_tpu_torch.scripts import exp_int4_variants as p2
    from flowtron_tpu_torch.scripts import exp_w4_kernel_bisect as p1

    rows = {}
    x, q, s = p1.to_device(p1.make_inputs(), dev)
    B, IN = x.shape
    OUT = q.shape[1]
    for body in ("k1", "k2", "k3", "k4", "k5"):
        # the library call: cuBLAS on the dequantized bf16 weight
        w_deq = dequantize(q, s, body).to(torch.bfloat16)
        n_rows = w_deq.shape[0]
        xin = x[:, :n_rows].contiguous()
        (k_ms, p_ms, lib_ms), (out_k, out_p, _), _ = graph_times([
            lambda: w4_matmul(x, q, s, body),
            lambda: w4_matmul_reference(x, q, s, body),
            lambda: xin @ w_deq], side)
        err = probe_check(f"P1 {body}", out_k, out_p, PROBE_BF16_TOL)
        # the split rows meet in a fixed order: a second call, bit for bit
        check(torch.equal(out_k, w4_matmul(x, q, s, body)),
              f"P1 {body}: two calls differ")
        n_bytes = 2 * B * n_rows + q.numel() + 2 * B * OUT + (
            4 * s.numel() if BODIES[body][0] else 0)
        rows[body] = dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                          bound=probe_bound(n_bytes, 2 * B * n_rows * OUT,
                                            "bf16", 1))
        emit("probe_w4", body=body, B=B, IN=IN, OUT=OUT, max_abs_err=err,
             split=w4_matmul.last_split,
             kernel_ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
             bound_ms=rows[body]["bound"][0],
             sum=float(out_k.float().sum()))
    inputs = p2.make_inputs()
    for body, key in (("concat", "pallas_concat"), ("2dot", "pallas_2dot")):
        x, q, s = inputs[key]
        x = _probe.tensor(x, dev, torch.bfloat16)
        q, s = _probe.tensor(q, dev), _probe.tensor(s, dev)
        check_k = _probe.scan(p2.scan_step(p2.pallas(body), q, s), x,
                              PROBE_STEPS)()
        check_p = _probe.scan(p2.scan_step(
            lambda a, b, c: w4_matmul_reference(a, b, c, body), q, s), x,
            PROBE_STEPS)()
        err = probe_check(f"P2 {body} scan", check_k, check_p, PROBE_BF16_TOL)
        times = []
        for dot in (p2.pallas(body),
                    lambda a, b, c: w4_matmul_reference(a, b, c, body),
                    p2.dot_w4_rows):
            times.append(_probe.time_per_step(
                _probe.scan(p2.scan_step(dot, q, s), x, p2.STEPS),
                p2.STEPS)[0] / 1e3)
        # the whole scan: x in and the carry out once, the weights read
        # once; per step the product
        n_bytes = 2 * B * IN + IN // 2 * OUT + 4 * s.numel() + 2 * B * IN
        rows[body] = dict(err=err, ms=times[0], plain_ms=times[1],
                          library_ms=times[2],
                          bound=probe_bound(n_bytes,
                                            2 * B * IN * OUT * p2.STEPS,
                                            "bf16", p2.STEPS))
        emit("probe_w4_scan", body=body, B=B, steps=p2.STEPS,
             check_steps=PROBE_STEPS, max_abs_err=err,
             kernel_ms_per_step=times[0], plain_ms_per_step=times[1],
             library_ms_per_step=times[2], bound_ms_per_step=rows[body][
                 "bound"][0])
    return rows


def probes_scans(k1_frames, dev):
    """P3, P4 and P5 against their plain versions on the card over 16
    steps at the scripts' shapes (and B=8 for P4, P5), and against a
    second run of themselves, bit for bit; then each timed over the
    script's STEPS or N: the kernel, the plain version (eager, as the
    other kernels' plain versions) and, for P3 and P4, the streamed
    cuBLAS step in a CUDA graph. Also the resident bytes, the L2 bytes an
    access-policy window may pin, each chain's and each P5 variant's time
    by stage (the kernels' clocks), the time of a chain of four tiny dots
    (each step is then mostly its four grid barriers), and K1's frames
    split by P5 (``p5_split``). Returns the kernel table's fields."""
    from flowtron_tpu_torch.ops.decoder import barrier_bench
    from flowtron_tpu_torch.ops.fused_cost import (
        VARIANTS, fused_cost, fused_cost_reference, fused_cost_stage_split,
        pack_weights)
    from flowtron_tpu_torch.ops.resident import (
        max_persisting_l2_bytes, pack_resident_weights, resident_scan,
        resident_scan_reference)
    from flowtron_tpu_torch.scripts import _probe
    from flowtron_tpu_torch.scripts import exp_fused_cost as p5
    from flowtron_tpu_torch.scripts import exp_fused_int8 as p4
    from flowtron_tpu_torch.scripts import exp_resident_weight as p3

    rows = {}

    def per_step(fn, steps, reps=3):
        return _probe.time_per_step(fn, steps, reps)[0] / 1e3

    # P3: the bf16 state (a bf16 rounding may move by one step when the
    # fp32 sums run in another order) and the last product (whose input
    # is that state) within PROBE_BF16_TOL of their scale
    w, x = p3.make_inputs()
    w = _probe.tensor(w, dev, torch.bfloat16)
    x = _probe.tensor(x, dev, torch.bfloat16)
    out = resident_scan("p3", x, [w], steps=PROBE_STEPS)
    ref = resident_scan_reference("p3", x, [w], steps=PROBE_STEPS)
    err = max(probe_check("P3 state", out[0], ref[0], PROBE_BF16_TOL),
              probe_check("P3 product", out[1], ref[1], PROBE_BF16_TOL))
    again = resident_scan("p3", x, [w], steps=PROBE_STEPS)
    check(torch.equal(out[0], again[0]) and torch.equal(out[1], again[1]),
          "P3: two scans differ")
    packed = pack_resident_weights("p3", [w])
    B, S = x.shape
    N = w.shape[1]
    steps = p3.STEPS
    k_ms = per_step(lambda: resident_scan("p3", x, [w], steps=steps,
                                          packed=packed), steps)
    res_bytes = resident_scan.last_resident[0]
    p_ms = per_step(lambda: resident_scan_reference("p3", x, [w], steps=steps),
                    steps, reps=1)
    lib_ms = per_step(_probe.scan(p3.xla_step(w), x, steps), steps)
    n_bytes = 2 * S * N + 2 * B * S + 2 * B * S + 4 * B * N
    rows["p3"] = dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                      bound=probe_bound(n_bytes, 2 * B * S * N * steps,
                                        "bf16", steps))
    emit("probe_p3", B=B, S=S, N=N, steps=steps, check_steps=PROBE_STEPS,
         max_abs_err=err, kernel_us_per_step=1e3 * k_ms,
         plain_us_per_step=1e3 * p_ms,
         cublas_streamed_us_per_step=1e3 * lib_ms,
         bound_us_per_step=1e3 * rows["p3"]["bound"][0],
         resident_bytes=res_bytes,
         max_persisting_l2_bytes=max_persisting_l2_bytes())

    # P4: the fp32 state within PROBE_FP32_TOL of its scale
    for body in ("bf16", "w8a8"):
        for B in (1, 8):
            args = p4.to_device(body, p4.make_inputs(body, B), dev)
            out = resident_scan(body, *args, steps=PROBE_STEPS)
            ref = resident_scan_reference(body, *args, steps=PROBE_STEPS)
            err = max(probe_check(f"P4 {body} B={B} state", out[0], ref[0],
                                  PROBE_FP32_TOL),
                      probe_check(f"P4 {body} B={B} gates", out[1], ref[1],
                                  PROBE_FP32_TOL))
            again = resident_scan(body, *args, steps=PROBE_STEPS)
            check(torch.equal(out[0], again[0])
                  and torch.equal(out[1], again[1]),
                  f"P4 {body} B={B}: two scans differ")
            packed = pack_resident_weights(body, args[1], args[2])
            steps = p4.STEPS
            k_ms = per_step(lambda: resident_scan(body, *args, steps=steps,
                                                  packed=packed), steps)
            res_bytes, resident = resident_scan.last_resident
            lib_ms = per_step(_probe.scan(p4.library_step(args[1], args[2]),
                                          args[0].float(), steps), steps)
            n_dots = len(args[1])
            clock = torch.zeros(steps * n_dots, dtype=torch.int64, device=dev)
            resident_scan(body, *args, steps=steps, packed=packed,
                          clock=clock)
            dot_us = (clock.double().diff()[n_dots - 1:]
                      .view(steps - 1, n_dots).mean(dim=0) / 1e3).tolist()
            fields = dict(body=body, B=B, steps=steps,
                          check_steps=PROBE_STEPS, max_abs_err=err,
                          kernel_us_per_step=1e3 * k_ms,
                          cublas_streamed_us_per_step=1e3 * lib_ms,
                          resident_bytes=res_bytes, resident_dots=resident,
                          dot_us_per_step=dot_us)
            if B == 1:
                p_ms = per_step(lambda: resident_scan_reference(
                    body, *args, steps=steps), steps, reps=1)
                # weights (and scales) and x0 read once, the state and the
                # last gates written once
                x0, ws = args[0], args[1]
                n_w = sum(t.numel() for t in ws)
                n_bytes = (ws[0].element_size() * n_w
                           + x0.element_size() * x0.numel()
                           + 4 * x0.numel() + 4 * B * ws[-1].shape[1] // 4
                           + (4 * sum(t.numel() for t in args[2])
                              if body == "w8a8" else 0))
                rows[body] = dict(
                    err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                    bound=probe_bound(n_bytes, 2 * B * n_w * steps,
                                      "int8" if body == "w8a8" else "bf16",
                                      steps))
                fields.update(plain_us_per_step=1e3 * p_ms,
                              bound_us_per_step=1e3 * rows[body]["bound"][0])
            emit("probe_p4", **fields)
    # four tiny dependent dots a step: mostly the four grid barriers (the
    # counter barrier of csrc/grid_sync.cuh, timed alone beside them)
    tiny = [(256, 1024)] * 4
    args = p4.to_device("bf16", p4.make_inputs("bf16", 1, tiny), dev)
    tiny_ms = per_step(lambda: resident_scan("bf16", *args, steps=p4.STEPS),
                       p4.STEPS)
    barrier_bench(0, 100, dev)
    bar_ms, _ = cuda_ms(lambda: barrier_bench(0, 5000, dev))
    barrier_us = 1e3 * bar_ms / 5000
    emit("probe_p4_barriers", shapes=tiny, B=1, steps=p4.STEPS,
         us_per_step=1e3 * tiny_ms, us_per_dot=1e3 * tiny_ms / len(tiny),
         barrier_us=barrier_us)
    # a dependent chain's latency floor: its barriers a step, at the
    # measured barrier (a floor beside the bound, not a bound)
    for body in ("bf16", "w8a8"):
        rows[body]["floor_us"] = len(p4.SHAPES) * barrier_us

    # P5: the fp32 mel within PROBE_FP32_TOL of its scale, and bitwise
    # over two calls
    p5_us = {}
    for variant in VARIANTS:
        for B in (1, 8):
            ws, z, kv = p5.to_device(p5.make_inputs(variant, B, PROBE_STEPS),
                                     dev)
            out = fused_cost(variant, z, kv, ws)
            err = probe_check(f"P5 {variant} B={B}", out,
                              fused_cost_reference(variant, z, kv, ws),
                              PROBE_FP32_TOL)
            check(torch.equal(out, fused_cost(variant, z, kv, ws)),
                  f"P5 {variant} B={B}: two calls differ")
            ws, z, kv = p5.to_device(p5.make_inputs(variant, B), dev)
            packed = pack_weights(variant, ws)
            N = z.shape[0]
            k_ms = per_step(lambda: fused_cost(variant, z, kv, ws, packed), N)
            stage_us, _ = fused_cost_stage_split(variant, z, kv, ws, packed)
            fields = dict(variant=variant, B=B, N=N, check_steps=PROBE_STEPS,
                          max_abs_err=err, kernel_us_per_step=1e3 * k_ms,
                          stage_us_per_step=stage_us)
            if B == 1:
                p_ms = per_step(lambda: fused_cost_reference(variant, z, kv,
                                                             ws), N, reps=1)
                # weights, z and kv read once, mel written once; per step
                # 2 operations a weight element and stream at the bf16
                # rate (bf16 products, fp32 sums), and for the attention
                # 6 per (text position, channel) as K1's bound counts
                # them, at the fp32 rate (tanh, softmax and context sums)
                n_w = sum(t.numel() for t in ws)
                M = z.shape[2]
                n_bytes = 2 * n_w + 4 * 2 * z.numel() + 2 * kv.numel()
                n_ops = {"bf16": 2 * B * n_w * N}
                if variant == "attn":
                    n_ops["fp32"] = 6 * B * kv.shape[1] * kv.shape[2] * N
                rows[variant] = dict(err=err, ms=k_ms, plain_ms=p_ms,
                                     library_ms=None,
                                     bound=probe_bound(n_bytes, n_ops,
                                                       "bf16", N),
                                     floor_us=len(stage_us) * barrier_us)
                p5_us[variant] = (1e3 * k_ms, 2 * n_w, stage_us)
                fields.update(
                    M=M, plain_us_per_step=1e3 * p_ms,
                    bound_us_per_step=1e3 * rows[variant]["bound"][0])
            emit("probe_p5", **fields)
    for shape, frame in k1_frames.items():
        emit("p5_split", k1_frame=shape, **p5_split(frame, p5_us))
    return rows


def p5_split(frame, p5_us):
    """K1's B=1 flow-frame (its ``stage_us_per_frame``, summed) divided
    as PR 4 divided the old one, by P5's B=1 times a step: streaming =
    K1's fp32 weight bytes at the rate P5's dots variant streams its bf16
    weights (an estimate: P5's 25.8 MB stay in L2, K1's 107 MB come from
    HBM); LSTM = P5 lstm - P5 dots (the cells' nonlinearities); attention
    = P5 attn (query, scores, softmax and context); unattributed = the
    rest. Shares of the frame; a negative rest means the estimates
    overshoot. Beside it, what P5's stage clock says of a stage's fixed
    cost: the dots variant's fastest stage (its weights brought in behind
    the barrier, so mostly its barrier and round trips), times K1's
    stages a frame."""
    frame_us = sum(frame["stage_us_per_frame"].values())
    dots_us, dots_bytes, dots_stages = p5_us["dots"]
    parts = {"streaming": frame["weight_bytes"] * dots_us / dots_bytes,
             "lstm": p5_us["lstm"][0] - dots_us,
             "attention": p5_us["attn"][0]}
    parts["unattributed"] = frame_us - sum(parts.values())
    fixed = min(dots_stages.values())
    n_stages = len(frame["stage_us_per_frame"])
    return dict(frame_us=frame_us,
                k1_stage_us_per_frame=frame["stage_us_per_frame"],
                dots_tb_per_s=dots_bytes / dots_us / 1e6,
                us=parts, share={k: v / frame_us for k, v in parts.items()},
                p5_fixed_us_per_stage=fixed,
                k1_stages_at_p5_fixed_cost_share=n_stages * fixed / frame_us)


def phase_probes(kernels, k1_frames, dev):
    """The probes of scripts/exp_*.py on the card: each kernel against its
    plain version (probes_w4, probes_scans), then the probes' own entry
    points, each module's ``main`` at the script's default B and, for P4
    and P5, at the serving engine's B=8, with every launch count set to 0
    just before and read just after. The kernels' scans run eagerly there
    (only the library baselines replay CUDA graphs), so each count is the
    launches the run made: one a step for P1's and P2's scans, one a scan
    for P3 and P4, one a recurrence for P5 (one cooperative launch, as
    K1's a flow). Returns the table's fields
    and the entry points' launches."""
    from flowtron_tpu_torch.scripts import (
        exp_fused_cost, exp_fused_int8, exp_int4_variants,
        exp_resident_weight, exp_w4_kernel_bisect)

    side = torch.cuda.Stream()
    rows = probes_w4(side, dev)
    rows.update(probes_scans(k1_frames, dev))
    torch.cuda.synchronize()
    reset_launches(kernels)
    t0 = time.perf_counter()
    results = {
        "exp_w4_kernel_bisect": exp_w4_kernel_bisect.main([]),
        "exp_int4_variants": exp_int4_variants.main([]),
        "exp_resident_weight": exp_resident_weight.main([]),
        "exp_fused_int8": exp_fused_int8.main(["1"]),
        "exp_fused_int8 B=8": exp_fused_int8.main(["8"]),
        "exp_fused_cost": exp_fused_cost.main(["1"]),
        "exp_fused_cost B=8": exp_fused_cost.main(["8"]),
    }
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    probe_names = [n for n in kernels if n.startswith(PROBE_KERNELS)]
    check(all(launches[n] > 0 for n in probe_names),
          f"probe entry points: {launches}")
    check(all(launches[n] == 0 for n in launches
              if not n.startswith(PROBE_KERNELS)),
          f"probe entry points launched other kernels: {launches}")
    # each scan's us a step (exp_w4_kernel_bisect's single calls give sums)
    us = {name: {k: v[0] for k, v in res.items()
                 if name != "exp_w4_kernel_bisect" or k.endswith("scan")}
          for name, res in results.items()}
    emit("probes", wall_s=wall, us_per_step=us, launches=launches)
    return rows, launches


# ---- bf16 serving: the JAX server's --bf16 and the kernels' bf16 bodies

K1_BF16_RATIO = 1.5   # K1 bf16 mel vs the fp32 kernel's: at most this x
BF16_SCALE = 1e-3     # the plain bf16 version's distance, plus this of the
                      # mel's scale (the kernel sums in another order)
K1_BF16_MEL_TOL = 2e-3   # K1 bf16 vs its plain bf16 version: the mel within
K1_BF16_ATTN_TOL = 1.5e-3  # this of its scale, attention weights within this
                      # (both bodies round at the same points; the sums'
                      # order moves a rounding, which the 400 frames carry)
K2_BF16_TOL = 1e-2    # K2 bf16 vs plain, of the output scale: each output
                      # is one bf16 rounding, which the sums' order moves
K1_BF16_N = 2         # K1 bf16 launches of one request: one a flow
K2_BF16_N = 96        # K2 bf16 launches of one vocoder pass: 12 flows x 8
SERVE_WAVES = 4       # main waves a serve phase times
SERVE_RPS = {}        # (quantize, bf16) -> each main wave's requests/s


def bf16_copy(module):
    """A copy of ``module`` under the serving engine's cast rule."""
    import copy

    from flowtron_tpu_torch.utils.weights import to_bf16
    return to_bf16(copy.deepcopy(module))


def bf16_ulp(r):
    """One bf16 ulp of each |r| (its spacing at r's binade)."""
    return torch.exp2(torch.floor(torch.log2(r.abs().clamp(min=2.0 ** -126)))
                      - 7)


def k1_bf16_bound(weights, N, B, Tk, D, M=80):
    """K1's bf16 body's floor for one flow over N frames: the packed bf16
    matrices and fp32 vectors, bf16 keys and values, fp32 latents and key
    mask read once, mel, attention and gates written once; its operations
    at the peak of their operands' type: 2 a bf16 weight element a frame
    and stream at the bf16 rate, and the attention's 6 a (text position,
    attention channel), whose sums and softmax are fp32, at the fp32
    rate."""
    from flowtron_tpu_torch.ops.decoder import _with_matrices

    tensors = [t for v in _with_matrices(weights).values()
               for t in ([v] if torch.is_tensor(v) else
                         [x for pair in v for x in pair])]
    n_w = {dt: sum(t.numel() for t in tensors if t.dtype == dt)
           for dt in (torch.bfloat16, torch.float32)}
    n_bytes = (sum(t.numel() * t.element_size() for t in tensors)
               + 2 * 2 * B * Tk * D
               + 4 * (2 * N * B * M + B * Tk + N * B * Tk + N * B))
    return bound(n_bytes, {
        "bf16": N * B * 2 * n_w[torch.bfloat16],
        "fp32": N * B * (2 * n_w[torch.float32] + 6 * Tk * D)})


def phase_k1_bf16(model, model16, cfg, ids, sid, dev):
    """K1's bf16 body on the card at the main path's shapes: both flows of
    the first request (B=1, its latents), of the four texts (B=4, key
    mask) and of the four texts twice (B=8, key mask, other latents), each
    against its plain bf16 version (the same n_valid, the mel within
    K1_BF16_MEL_TOL of its scale, attention within K1_BF16_ATTN_TOL) and
    the fp32 kernel on the same inputs (the bf16 kernel's mel at most
    K1_BF16_RATIO x the plain bf16 version's distance from it, plus
    BF16_SCALE of its scale), two calls bitwise equal with early exit off
    and on; where its rows lie (k1_launch_info: resident bytes, streamed
    bytes a frame, those through the ring, the K1 pack's bytes as it lies
    on the card; no L2 window, which was timed and taken out), the K1
    packs the flow holds after the case (one a layout, ``k1_pack_for``)
    and the ms it took to build the case's layout at its first launch
    (null when the flow held it already), and its stage split
    (k1_stage_split) on every case; the gated flow at B=1 timed against its
    plain version in turns, and at B=1 and B=8 against the fp32 kernel in
    turns (bf16, fp32, fp32, bf16). ``fp32_sha256`` hashes the fp32
    kernel's outputs, to hold them bitwise against another checkout's.
    Returns the max error and (ms, plain ms, bound, bound_by)."""
    import hashlib

    from flowtron_tpu_torch.models.attention import attention_precompute
    from flowtron_tpu_torch.models.flowtron import _encode_text
    from flowtron_tpu_torch.ops.decoder import (
        fused_flow_infer, fused_flow_infer_reference, k1_launch_info,
        k1_pack_for, k1_stage_split)

    batch_text, batch_lens = pad_ids(ids)
    z_req = SIGMA * torch.randn(1, 80, N_FRAMES, generator=torch.Generator()
                                .manual_seed(REQ_SEED))
    g = torch.Generator().manual_seed(41)
    cases = [("request", batch_text[:1, :len(ids[0])], None,
              z_req.permute(2, 0, 1).flip(0)),
             ("batch", batch_text, batch_lens,
              SIGMA * torch.randn(N_FRAMES, 4, 80, generator=g)),
             ("batch8", batch_text.repeat(2, 1), batch_lens.repeat(2),
              SIGMA * torch.randn(N_FRAMES, 8, 80, generator=g))]
    max_err, times = 0.0, None
    for shape, text, lens, res in cases:
        B, Tk = text.shape
        mask = None if lens is None else \
            (torch.arange(Tk)[None] < lens[:, None]).to(dev)
        km = (torch.ones(B, Tk, device=dev) if mask is None
              else mask.to(torch.float32)).contiguous()
        for fi in (len(model.flows) - 1, 0):
            args = {}
            for tag, m, dt in (("fp32", model, torch.float32),
                               ("bf16", model16, torch.bfloat16)):
                flow = getattr(m.flows[fi], "ar_step", m.flows[fi])
                with torch.no_grad():
                    enc = _encode_text(m, cfg, torch.full((B,), sid,
                                                          device=dev),
                                       text.to(dev), mask)
                    kp, vals = attention_precompute(flow.attention_layer,
                                                    enc, enc)
                args[tag] = (flow.packed_weights(),
                             res.to(dev, dt).contiguous(), kp, vals, km, 1.0)
            w16 = args["bf16"][0]
            tag = f"K1 bf16 {shape} flow {fi} B={B}"
            check(w16.get("k1") is not None
                  and args["bf16"][2].dtype == torch.bfloat16,
                  f"{tag}: not a bf16 pack for the card")
            timed = fi != 0 and shape in ("request", "batch8")
            fields = dict(shape=shape, flow=fi, B=B, N=N_FRAMES, Tk=Tk)
            # this B's layout of the K1 pack, built where the flow lacks it
            held = len(w16["k1"])
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            k1_pack_for(w16, B)
            torch.cuda.synchronize(dev)
            fields["k1_pack_build_ms"] = (
                1e3 * (time.perf_counter() - t0)
                if len(w16["k1"]) > held else None)
            if timed:
                if shape == "request":
                    k_ms, p_ms, runs, out_k, out_p = paired_ms(
                        lambda: fused_flow_infer(*args["bf16"]),
                        lambda: fused_flow_infer_reference(*args["bf16"]),
                        reps=3)
                    times = (k_ms, p_ms) + k1_bf16_bound(
                        w16, N_FRAMES, B, Tk, kp.shape[2])
                    fields.update(plain_ms=p_ms,
                                  runs_plain_kernel_kernel_plain_ms=runs,
                                  bound_ms=times[2], bound_by=times[3])
                else:
                    out_p = fused_flow_infer_reference(*args["bf16"])
                # the fp32 kernel in turns with the bf16 one
                f32_ms, k_ms, runs32, out_32, out_k = paired_ms(
                    lambda: fused_flow_infer(*args["fp32"]),
                    lambda: fused_flow_infer(*args["bf16"]), reps=3,
                    plain_reps=3)
                fields.update(kernel_ms=k_ms, fp32_kernel_ms=f32_ms,
                              kernel_us_per_frame=1e3 * k_ms / N_FRAMES,
                              bf16_over_fp32=k_ms / f32_ms,
                              runs_bf16_fp32_fp32_bf16_ms=runs32)
            else:
                out_k = fused_flow_infer(*args["bf16"])
                out_p = fused_flow_infer_reference(*args["bf16"])
                out_32 = fused_flow_infer(*args["fp32"])
            check(all(torch.equal(a, b) for a, b in zip(
                out_k, fused_flow_infer(*args["bf16"]))),
                f"{tag}: two calls differ")
            errs = [float((a - b).abs().max()) for a, b in zip(out_k, out_p)]
            e_k = float((out_k[0] - out_32[0]).abs().max())
            e_p = float((out_p[0] - out_32[0]).abs().max())
            scale = float(out_32[0].abs().max())
            nv_k, nv_p = n_valid_of(out_k[2], 0.5), n_valid_of(out_p[2], 0.5)
            check(all(math.isfinite(e) for e in errs + [e_k]),
                  f"{tag} not finite")
            check(torch.equal(nv_k, nv_p), f"{tag} n_valid {nv_k} {nv_p}")
            check(errs[0] <= K1_BF16_MEL_TOL * scale
                  and errs[1] <= K1_BF16_ATTN_TOL,
                  f"{tag}: vs plain bf16 mel {errs[0]}, attn {errs[1]}")
            check(e_k <= K1_BF16_RATIO * e_p + BF16_SCALE * scale,
                  f"{tag}: vs fp32 kernel {e_k}, plain bf16 {e_p}")
            # early exit on: where every stream's gate first passes 0.5
            e_args = args["bf16"] + (True, 0.5)
            out_e = fused_flow_infer(*e_args)
            check(all(torch.equal(a, b) for a, b in zip(
                out_e, fused_flow_infer(*e_args))),
                f"{tag} early: two calls differ")
            stop = int(nv_p.max())
            check(all(torch.equal(a[:stop], b[:stop])
                      for a, b in zip(out_e, out_k)),
                  f"{tag} early: frames before the stop differ")
            max_err = max(max_err, errs[0])
            sha = hashlib.sha256()
            for o in out_32:
                sha.update(o.cpu().numpy().tobytes())
            fields.update(max_abs_err_mel=errs[0], max_abs_err_attn=errs[1],
                          max_abs_err_gate=errs[2],
                          mel_err_vs_fp32_kernel=e_k,
                          plain_mel_err_vs_fp32_kernel=e_p, mel_scale=scale,
                          n_valid=nv_k.tolist(), fp32_sha256=sha.hexdigest(),
                          stage_us_per_frame=k1_stage_split(*args["bf16"]),
                          k1_packs=len(w16["k1"]),
                          k1_packs_bytes=sum(k.pack.numel() * 2
                                             for k in w16["k1"].values()),
                          **k1_launch_info(w16, B, Tk, dev))
            emit("k1_bf16", **fields)
    return max_err, times


# a stream window: context 24 + chunk 40 + lookahead 16 frames
K2_WINDOW = (24 + 40 + 16) * HOP // 8
# phase_k2_bf16's cases: (tag, C, layer, B, T, Tp), C = 256 on the bf16
# vocoder's weights, 512 and 1024 on init-scaled random ones
K2_BF16_CASES = (("layer3_B1", 256, 3, 1, 12800, 12800),
                 ("layer7_B1", 256, 7, 1, 12800, 12800),
                 ("layer3_B8", 256, 3, 8, 12800, 12800),
                 ("layer3_B1_pad96", 256, 3, 1, 12800, 12896),
                 ("window_B1", 256, 3, 1, K2_WINDOW, K2_WINDOW),
                 ("mux_B7", 256, 3, 7, K2_WINDOW, K2_WINDOW),
                 ("C512_B1", 512, 3, 1, 12800, 12800),
                 ("C1024_B1", 1024, 3, 1, 12800, 12800))


def k2_bf16_args(g, C, layer, B, T, Tp, wn16, dev):
    """One bf16 WN layer's arguments: x (B, Tp, C) from ``g``, zero on pad
    rows, and a cond slice of row stride 2CL (L = 8), drawn after it; the
    weights of layer ``layer`` of ``wn16`` (the bf16 vocoder's first WN)
    when C is its width, else init-scaled random ones."""
    L = 8
    x = torch.randn(B, Tp, C, generator=g)
    x[:, T:] = 0
    cond_all = torch.randn(B, Tp, 2 * C * L, generator=g)
    if wn16 is not None and wn16.n_channels == C:
        w = tuple(wn16.packed_layers()[layer])
    else:
        n_rs = C if layer == L - 1 else 2 * C
        w = tuple(t.to(dev, torch.bfloat16) for t in (
            torch.randn(3 * C, 2 * C, generator=g) * (3 * C) ** -0.5,
            0.1 * torch.randn(2 * C, generator=g),
            torch.randn(C, n_rs, generator=g) * C ** -0.5,
            0.1 * torch.randn(n_rs, generator=g)))
    cond = cond_all.to(dev, torch.bfloat16)[
        ..., 2 * C * layer:2 * C * (layer + 1)]
    return (x.to(dev, torch.bfloat16), 2 ** layer, cond) + w + (T,)


def phase_k2_bf16(wg, wg16, dev):
    """K2's bf16 body against its plain bf16 version at the vocoder's
    shapes (K2_BF16_CASES: layers 3 (d = 8) and 7 (the last) at B=1,
    T=12800, layer 3 at B=8, with 96 pad rows, at the stream window (B=1,
    2560 rows) and a mux group (B=7), and C = 512 and 1024 at B=1): within
    K2_BF16_TOL of the output scale, pad rows zero, two calls bitwise
    equal. Each case timed in CUDA graphs (device time; a call is faster
    than Python launches it) and eagerly; layer 3 at B=1 also beside its
    plain version, the fp32 body (the fp32 vocoder's weights, the same
    inputs), the two products alone in bf16 cuBLAS (a yardstick), the
    host's us a call and a launch, and at B=1 and B=8 every build of the
    plan in turns. Then the fp32 body's outputs hashed at
    phase_k2's cases. Run in a checkout whose ops/wavenet.py has no
    ``wn_bf16_plan`` (before this body), it times that checkout's body
    and leaves out what it lacks. Returns the max error and (ms, plain
    ms, bound, bound_by) of layer 3 at B=1."""
    from flowtron_tpu_torch.ops import wavenet as W

    own = hasattr(W, "wn_bf16_plan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    side = torch.cuda.Stream()
    g = torch.Generator().manual_seed(43)
    max_err, times = 0.0, None
    for tag, C, layer, B, T, Tp in K2_BF16_CASES:
        a16 = k2_bf16_args(g, C, layer, B, T, Tp, wg16.WN[0], dev)
        check(a16[3].dtype == torch.bfloat16, "K2 bf16: not bf16 weights")
        with torch.no_grad():
            out_k, out_p = W.wn_layer(*a16), W.wn_layer_reference(*a16)
            again = W.wn_layer(*a16)
            errs = []
            for a, r in zip(out_k, out_p):
                if r is not None:
                    check(a.dtype == torch.bfloat16, "K2 bf16 output dtype")
                    errs.append(float((a.float() - r.float()).abs().max())
                                / max(1.0, float(r.float().abs().max())))
            del out_p
            check(all(e <= K2_BF16_TOL for e in errs),
                  f"K2 bf16 {tag} err {errs}")
            check(all(a is None or torch.equal(a, b)
                      for a, b in zip(out_k, again)),
                  f"K2 bf16 {tag}: two calls differ")
            if out_k[0] is not None and Tp > T:
                check(bool((out_k[0][:, T:] == 0).all()),
                      f"K2 bf16 {tag}: pad rows not zero")
            max_err = max(max_err, max(errs))
            flops, n_bytes32 = k2_work(B, Tp, C, a16[5].shape[1])
            # every tensor bf16: x, cond, weights and biases read once, x'
            # and skip written once; one bf16 pass of each product
            bnd = bound(n_bytes32 // 2, {"bf16": flops})
            (k_ms,), _, k_runs = graph_times([lambda: W.wn_layer(*a16)],
                                             side)
            eager_ms, _ = cuda_ms(lambda: W.wn_layer(*a16), 20)
            fields = dict(case=tag, layer=layer, C=C, B=B, T=T, Tp=Tp,
                          max_rel_err=max(errs), kernel_ms=k_ms,
                          kernel_runs_ms=k_runs, eager_ms=eager_ms,
                          bound_ms=bnd[0], bound_by=bnd[1],
                          of_bound=bnd[0] / k_ms,
                          kernel_tflops_bf16=flops / k_ms / 1e9)
            if own:
                fields["plan"] = W.wn_bf16_plan(B, Tp, C, sms)._asdict()
            if tag == "layer3_B1":
                # warm, then the median of three rounds: the plain
                # version's temporaries are large and a cold round pays
                # their allocation
                W.wn_layer_reference(*a16)
                p_ms = statistics.median(
                    cuda_ms(lambda: W.wn_layer_reference(*a16), 3)[0]
                    for _ in range(3))
                a32 = (a16[0].float(), a16[1], a16[2].float()) + tuple(
                    wg.WN[0].packed_layers()[layer]) + (T,)
                (f32_ms,), _, _ = graph_times([lambda: W.wn_layer(*a32)],
                                              side)
                # the two products alone, bf16 cuBLAS: what a library
                # reaches on the same shapes (a yardstick, not the layer)
                M = B * Tp
                p1 = (torch.randn(M, 3 * C, device=dev).bfloat16(),
                      a16[3])
                p2 = (torch.randn(M, C, device=dev).bfloat16(), a16[5])
                (mm_ms,), _, mm_runs = graph_times(
                    [lambda: (p1[0] @ p1[1], p2[0] @ p2[1])], side)
                n = 200
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    W.wn_layer(*a16)
                host_call = (time.perf_counter() - t0) / n * 1e6
                torch.cuda.synchronize()
                fields.update(plain_ms=p_ms, fp32_kernel_ms=f32_ms,
                              bf16_over_fp32=k_ms / f32_ms,
                              cublas_products_ms=mm_ms,
                              cublas_products_runs_ms=mm_runs,
                              over_cublas_products=k_ms / mm_ms,
                              host_us_per_call=host_call)
                if own:
                    # the C entry alone: six tensor maps encoded, a launch
                    lib, plan = W._lib(), W.wn_bf16_plan(B, Tp, C, sms)
                    w1, w2 = W._packed(a16[3], a16[5], 0)
                    xo, sk = torch.empty_like(a16[0]), \
                        torch.empty_like(a16[0])
                    ldc = a16[2].stride(1)
                    st = torch.cuda.current_stream(dev).cuda_stream
                    args = (1, a16[0].data_ptr(), a16[1],
                            a16[2].data_ptr(), ldc, w1.data_ptr(),
                            a16[4].data_ptr(), w2.data_ptr(),
                            a16[6].data_ptr(), xo.data_ptr(), sk.data_ptr(),
                            B, Tp, T, C, plan.bm, 0, st, plan.grid)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(n):
                        check(lib.wn_layer_launch(*args) == 0,
                              "K2 bf16 launch")
                    host_launch = (time.perf_counter() - t0) / n * 1e6
                    torch.cuda.synchronize()
                    check(torch.equal(xo, out_k[0]) and torch.equal(
                        sk, out_k[1]), "K2 bf16: the C entry differs")
                    fields["host_us_per_launch"] = host_launch
                times = (k_ms, p_ms) + bnd
            if own and tag in ("layer3_B1", "layer3_B8"):
                # every build of the plan, in turns, bitwise alike
                builds = list(W.WN_BF16_BUILDS[C])
                fns = [lambda bm=bm: W.wn_layer(*a16, bm=bm)
                       for bm in builds]
                for f in fns:
                    check(all(a is None or torch.equal(a, o) for a, o in
                              zip(out_k, f())), f"K2 bf16 {tag}: builds")
                ms, _, _ = graph_times(fns, side, reps=10)
                fields["builds_ms"] = {f"bm{bm}": m
                                       for bm, m in zip(builds, ms)}
        emit("k2_bf16", **fields)
        del a16, out_k, again
        torch.cuda.empty_cache()
    emit("k2_fp32_sha256", **k2_fp32_sha256(wg, dev))
    return max_err, times


def k4_frame_chain(dtype, a8, g, side, dev, M=8):
    """One flow-frame's nine K4 calls in their order (K4_FRAME_KN) at the
    serving batch, each with its own weight, each call's x made from the
    previous output by one elementwise op (x = base + out[:, :1], as the
    loop's LSTM cell feeds each dot from the last), in one CUDA graph;
    beside it the same chain through the library product (cuBLAS on each
    dequantized weight in x's dtype) and the elementwise ops alone, in
    turns. Neither back-to-back identical calls nor one shape's L2 reuse
    flatter the number. Returns the kernel's and the library's frame ms,
    each less the ops' chain, the ops' ms, an eager frame's ms (host
    launches included) and every graph run."""
    from flowtron_tpu_torch.infer.quantize import _quantize_matrix
    from flowtron_tpu_torch.ops.qmm import quantized_matmul

    leaves = [_quantize_matrix(0.05 * torch.randn(N, K, generator=g), a8=a8)
              for K, N in K4_FRAME_KN]
    qs = [(lf.q.to(dev), lf.s.to(dev)) for lf in leaves]
    ws = [(q.float() * s[:, None]).to(dtype) for q, s in qs]
    bases = [torch.randn(M, K, generator=g).to(dev, dtype)
             for K, _ in K4_FRAME_KN]

    def chain(dot):
        out = bases[0]
        for i in range(len(bases)):
            out = dot(i, bases[i] + out[:, :1])
        return out

    def kernel():
        return chain(lambda i, x: quantized_matmul(x, *qs[i], a8=a8))

    def library():
        return chain(lambda i, x: torch.nn.functional.linear(x, ws[i]))

    (k_ms, l_ms, o_ms), _, runs = graph_times(
        [kernel, library, lambda: chain(lambda i, x: x)], side, rounds=5)
    eager_ms, _ = cuda_ms(kernel, reps=20)
    return dict(kernel_ms=k_ms - o_ms, library_ms=l_ms - o_ms,
                elementwise_ms=o_ms, eager_ms=eager_ms,
                runs_kernel_library_ops_ms=runs)


def phase_k4_bf16(dev):
    """K4's bf16 bodies (bf16 x, bf16 out) against their plain versions at
    every (K, N) of the flagship path at M = 1, 8 and 64 and at (3, 100,
    200): W8A8 bitwise, weight-only within one bf16 ulp of each output
    (plus 2^-16 of the scale where a sum cancels), both bitwise
    repeatable; the frame's (K, N) at M=8 timed in CUDA graphs beside the
    bf16 cuBLAS product on the dequantized bf16 weight; then the frame's
    nine calls in order (k4_frame_chain), bf16 and, in the same run, the
    fp32 bodies' frame. Returns per body the max error and the frame's
    nine calls summed: (ms, plain ms, bound, bound_by, library ms)."""
    from flowtron_tpu_torch.infer.quantize import _quantize_matrix
    from flowtron_tpu_torch.ops.qmm import (
        quantized_matmul, quantized_matmul_reference)

    g = torch.Generator().manual_seed(44)
    side = torch.cuda.Stream()
    table = {}
    for a8 in (True, False):
        body = "w8a8" if a8 else "w8"
        cases, max_err = {}, 0.0
        for K, N in K4_KN + [(100, 200)]:
            leaf = _quantize_matrix(0.05 * torch.randn(N, K, generator=g),
                                    a8=a8)
            q, s = leaf.q.to(dev), leaf.s.to(dev)
            x64 = torch.randn(64, K, generator=g).to(dev, torch.bfloat16)
            for M in ((3,) if K == 100 else (1, 8, 64)):
                x = x64[:M].contiguous()
                out_k = quantized_matmul(x, q, s, a8=a8)
                out_p = quantized_matmul_reference(x, q, s, a8=a8)
                tag = f"K4 bf16 {body} M={M} K={K} N={N}"
                check(out_k.dtype == torch.bfloat16, f"{tag} dtype")
                check(torch.equal(out_k, quantized_matmul(x, q, s, a8=a8)),
                      f"{tag} not bitwise repeatable")
                d = (out_k.float() - out_p.float()).abs()
                if a8:
                    check(torch.equal(out_k, out_p), f"{tag} not bitwise")
                else:
                    check(bool((d <= bf16_ulp(out_p.float()) + 2.0 ** -16
                                * float(out_p.float().abs().max())).all()),
                          f"{tag} ulp")
                max_err = max(max_err, float(d.max()))
                if M != 8 or (K, N) not in K4_FRAME_KN:
                    continue
                w = (q.float() * s[:, None]).to(torch.bfloat16)
                (k_ms, p_ms, lib_ms), _, _ = graph_times([
                    lambda: quantized_matmul(x, q, s, a8=a8),
                    lambda: quantized_matmul_reference(x, q, s, a8=a8),
                    lambda: torch.nn.functional.linear(x, w)], side)
                n_bytes = 2 * M * K + N * K + 4 * N + 2 * M * N
                ops = {"int8" if a8 else "bf16": 2 * M * K * N}
                cases[K, N] = dict(kernel_ms=k_ms, plain_ms=p_ms,
                                   library_ms=lib_ms,
                                   bound=bound(n_bytes, ops))
                emit("k4_bf16", body=body, M=M, K=K, N=N,
                     max_abs_err=float(d.max()), kernel_ms=k_ms,
                     plain_ms=p_ms, library_ms=lib_ms,
                     bound_ms=cases[K, N]["bound"][0],
                     bound_by=cases[K, N]["bound"][1])
        emit("k4_bf16_checked", body=body, shapes=len(K4_KN) * 3 + 1,
             max_abs_err=max_err)
        frame = [cases[kn] for kn in K4_FRAME_KN]
        sums = {k: sum(f[k] for f in frame)
                for k in ("kernel_ms", "plain_ms", "library_ms")}
        b_ms = sum(f["bound"][0] for f in frame)
        by = "bytes" if all(f["bound"][1] == "bytes" for f in frame) \
            else "operations"
        emit("k4_bf16_flow_frame", body=body, M=8, calls=len(frame), **sums,
             bound_ms=b_ms, bound_by=by)
        table[body] = (max_err, sums["kernel_ms"], sums["plain_ms"], b_ms,
                       by, sums["library_ms"])
        for dtype in (torch.bfloat16, torch.float32):
            res = k4_frame_chain(dtype, a8, g, side, dev)
            check(res["kernel_ms"] > 0 and res["library_ms"] > 0,
                  f"K4 {body} chain times")
            emit("k4_frame_chain", body=body, x=str(dtype).split(".")[-1],
                 M=8, calls=len(frame), **res)
    return table


def phase_bf16_slice(model, model16, cfg, wg, wg16, wg_cfg, ids, sid,
                     kernels, dev):
    """The bf16 request chain at full width, as the serving engine runs it
    (latents drawn in fp32 and cast, both flows through K1's bf16 body,
    the bf16 vocoder through K2's, audio back in fp32), the gate biased off
    (phase_slice): a B=1 and a B=4 400-frame request, each beside the fp32
    chain on the same latents, in turns. The bf16 request's launches: K1
    bf16 once a flow, K2 bf16 96 times a vocoder pass, no fp32 body.
    Returns the B=1 request's launches."""
    from flowtron_tpu_torch.models.flowtron import flowtron_infer
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_infer_z

    def request(m, w, dt, res, text, lens, zs):
        mel, _, nv = flowtron_infer(
            m, cfg, res.to(dev, dt), torch.full((res.shape[0],), sid,
                                                device=dev),
            text.to(dev), gate_threshold=0.5,
            in_lens=None if lens is None else lens.to(dev), fused="early")
        audio = waveglow_infer_z(w, wg_cfg, mel, zs[0].to(dev, dt),
                                 [None if z is None else z.to(dev, dt)
                                  for z in zs[1]]).float()
        return mel, nv, audio

    text, lens = pad_ids(ids)
    out_launches = None
    for B in (1, 4):
        g = torch.Generator().manual_seed(50 + B)
        res = SIGMA * torch.randn(B, 80, N_FRAMES, generator=g)
        Tg = N_FRAMES * HOP // 8
        zs = (0.8 * torch.randn(B, 4, Tg, generator=g),
              [0.8 * torch.randn(B, 2, Tg, generator=g)
               if f % 4 == 0 and f > 0 else None for f in range(12)])
        t_b, l_b = (text[:1, :len(ids[0])], None) if B == 1 else (text, lens)
        with torch.no_grad():
            request(model16, wg16, torch.bfloat16, res, t_b, l_b, zs)
            walls = {"fp32": [], "bf16": []}
            outs = {}
            for tag in ("fp32", "bf16", "bf16", "fp32"):
                m, w = (model16, wg16) if tag == "bf16" else (model, wg)
                dt = torch.bfloat16 if tag == "bf16" else torch.float32
                torch.cuda.synchronize()
                if tag == "bf16" and B == 1 and not walls["bf16"]:
                    reset_launches(kernels)
                t0 = time.perf_counter()
                outs[tag] = request(m, w, dt, res, t_b, l_b, zs)
                torch.cuda.synchronize()
                walls[tag].append(time.perf_counter() - t0)
                if tag == "bf16" and B == 1 and len(walls["bf16"]) == 1:
                    out_launches = read_launches(kernels)
        mel16, nv16, audio16 = outs["bf16"]
        mel32, nv32, audio32 = outs["fp32"]
        check(mel16.dtype == torch.bfloat16, "bf16 slice: mel not bf16")
        check(bool(torch.isfinite(audio16).all()), "bf16 slice: audio")
        n = int(torch.minimum(nv16, nv32).min())
        mel_dev = float((mel16.float() - mel32)[..., :n].abs().max())
        audio_dev = float((audio16 - audio32)[:, :n * HOP].abs().max()) \
            / max(1.0, float(audio32.abs().max()))
        ms = {k: 1e3 * statistics.median(v) for k, v in walls.items()}
        audio_s = N_FRAMES * HOP / SR
        emit("bf16_slice", B=B, N=N_FRAMES, n_valid_bf16=nv16.tolist(),
             n_valid_fp32=nv32.tolist(), request_ms=ms,
             rtf={k: v / 1e3 / audio_s for k, v in ms.items()},
             bf16_over_fp32=ms["bf16"] / ms["fp32"],
             mel_max_abs_dev=mel_dev, audio_max_rel_dev=audio_dev,
             runs_ms={k: [1e3 * t for t in v] for k, v in walls.items()},
             **({"launches": out_launches} if B == 1 else {}))
    L = out_launches
    check(L["fused_flow_infer_bf16"] == K1_BF16_N
          and L["fused_flow_infer"] == K1_BF16_N
          and L["wn_layer_bf16"] == K2_BF16_N and L["wn_layer"] == K2_BF16_N
          and L["quantized_matmul_w8a8"] == 0
          and L["quantized_matmul_w8"] == 0,
          f"bf16 slice launches {L}")
    return out_launches


def bf16_only(tag, launches, k4=False):
    """The bf16 bodies launched and no fp32 body: K1 and K2 (and with
    ``k4`` K4's W8A8) each had launches, all of them bf16."""
    names = ["wn_layer"] + (["quantized_matmul_w8a8"] if k4
                            else ["fused_flow_infer"])
    check(all(launches[n] > 0 and launches[n] == launches[n + "_bf16"]
              for n in names)
          and launches["quantized_matmul_w8"] == launches[
              "quantized_matmul_w8_bf16"], f"{tag}: launches {launches}")


def phase_serve_bf16_streams(ft_path, wg_path, kernels):
    """Streams from --bf16 servers: --bf16 --quantize w8a8 with one
    streamer pair (one POST /stream, its launches counted), then --bf16
    --stream-mux 2 (two POST /stream through the 2-slot mux at once). Every
    PCM its n_frames cap x 256 samples. Returns the pooled stream's
    launches and the mux's."""
    from flowtron_tpu_torch.serve.cli import build_server

    out = {}
    for tag, extra in (("pooled_w8a8", ["--quantize", "w8a8",
                                        "--stream-workers", "1"]),
                       ("mux", ["--stream-mux", "2"])):
        server, engines = build_server(
            ["-c", "config.json", "-p", NO_ARPABET, "-f", ft_path, "-w",
             wg_path, "--port", "0", "--bf16"] + extra, host="127.0.0.1")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        bodies = [{"text": TEXTS[0], "seed": 700, "n_frames": 200}]
        if tag == "mux":
            bodies.append({"text": TEXTS[1], "seed": 701, "n_frames": 160})
        try:
            get_json(url, "/healthz")
            read_stream(url, bodies[0])          # the first call's set-up
            torch.cuda.synchronize()
            reset_launches(kernels)
            with ThreadPoolExecutor(len(bodies)) as pool:
                got = list(pool.map(lambda b: read_stream(url, b), bodies))
            torch.cuda.synchronize()
            launches = read_launches(kernels)
        finally:
            server.shutdown()
            server.server_close()
            for eng in engines.values():
                eng.shutdown()
            torch.cuda.empty_cache()
        for body, (_, _, pcm) in zip(bodies, got):
            check(len(pcm) == 2 * body["n_frames"] * HOP,
                  f"bf16 {tag} /stream {len(pcm) // 2} samples")
        # the pooled stream's prelude flow runs K1 and its loop K4; the
        # mux's ticks run the loop, its joins K1's prelude
        check(launches["wn_layer"] > 0
              and launches["wn_layer"] == launches["wn_layer_bf16"]
              and launches["fused_flow_infer"]
              == launches["fused_flow_infer_bf16"]
              and (tag == "mux" or launches["quantized_matmul_w8a8"]
                   == launches["quantized_matmul_w8a8_bf16"] > 0),
              f"bf16 {tag} stream launches {launches}")
        emit("serve_bf16_stream", server=tag, streams=len(bodies),
             first_audio_ms=[g[0] for g in got],
             samples=[len(g[2]) // 2 for g in got], launches=launches)
        out[tag] = launches
    return out


def phase_serve_bf16_modes(ft_path, wg_path, kernels):
    """The --bf16 server with the modes serve_bf16's waves leave out:
    --quantize w8, and --quantize w4 with --vocode-buckets 120,240 (no
    warmup). Two concurrent requests each (capped at 100 and 200 frames):
    answered, and only K2's bf16 body launched (w8 and w4 leaves run the
    loop on bf16 weights, never K1 or K4). Returns the launches by mode."""
    from flowtron_tpu_torch.serve.cli import build_server

    out = {}
    for tag, extra in (("w8", ["--quantize", "w8"]),
                       ("w4_buckets", ["--quantize", "w4",
                                       "--vocode-buckets", "120,240"])):
        server, engines = build_server(
            ["-c", "config.json", "-f", ft_path, "-w", wg_path, "--port",
             "0", "--bf16"] + extra, host="127.0.0.1")
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        bodies = [{"text": TEXTS[0], "seed": 800, "n_frames": 100},
                  {"text": TEXTS[1], "seed": 801, "n_frames": 200}]
        try:
            get_json(url, "/healthz")
            torch.cuda.synchronize()
            reset_launches(kernels)
            results, wall = wave_of(url, bodies)
            torch.cuda.synchronize()
            launches = read_launches(kernels)
        finally:
            server.shutdown()
            server.server_close()
            for eng in engines.values():
                eng.shutdown()
            torch.cuda.empty_cache()
        check_answers(f"bf16 {tag}", bodies, results, N_FRAMES)
        check(launches["wn_layer"] == launches["wn_layer_bf16"] > 0
              and launches["fused_flow_infer"] == 0
              and launches["quantized_matmul_w8"] == 0
              and launches["quantized_matmul_w8a8"] == 0,
              f"bf16 {tag} launches {launches}")
        emit("serve_bf16_mode", server=tag, wall_s=wall,
             latency_s=[r[1] for r in results],
             samples=[r[3] for r in results], launches=launches)
        out[tag] = launches
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k4", action="store_true",
                    help="only K4's bf16 bodies (phase_k4_bf16)")
    ap.add_argument("--k1-bf16", action="store_true",
                    help="only K1's bf16 body (phase_k1_bf16)")
    ap.add_argument("--k2-bf16", action="store_true",
                    help="only K2's bf16 body (phase_k2_bf16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU and has no CPU fallback",
              file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowtron_tpu_torch.data.frontend import TextFrontend
    from flowtron_tpu_torch.data.synth import make_aligned_corpus
    from flowtron_tpu_torch.models.flowtron import flowtron_init
    from flowtron_tpu_torch.ops import _build
    from flowtron_tpu_torch.ops.attention import (
        attention_scores_bwd, attention_scores_fwd)
    from flowtron_tpu_torch.ops.decoder import fused_flow_infer
    from flowtron_tpu_torch.ops.fused_cost import fused_cost
    from flowtron_tpu_torch.ops.qmm import quantized_matmul
    from flowtron_tpu_torch.ops.resident import resident_scan
    from flowtron_tpu_torch.ops.w4 import w4_matmul
    from flowtron_tpu_torch.ops.wavenet import wn_layer
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_init

    # name -> (wrapper, counter attribute); read_launches splits K4's total
    # into its two bodies
    kernels = {"fused_flow_infer": (fused_flow_infer, "launches"),
               "wn_layer": (wn_layer, "launches"),
               "attention_scores_fwd": (attention_scores_fwd, "launches"),
               "attention_scores_bwd": (attention_scores_bwd, "launches"),
               "quantized_matmul": (quantized_matmul, "launches"),
               "quantized_matmul_w8a8": (quantized_matmul, "launches_w8a8"),
               # the bf16 bodies alone (each also counts in its total)
               "fused_flow_infer_bf16": (fused_flow_infer, "launches_bf16"),
               "wn_layer_bf16": (wn_layer, "launches_bf16"),
               "quantized_matmul_bf16": (quantized_matmul, "launches_bf16"),
               "quantized_matmul_w8a8_bf16": (quantized_matmul,
                                              "launches_w8a8_bf16")}
    # the probes' kernels, one counter per Pallas body
    for body in P_W4_BODIES:
        kernels[f"w4_matmul_{body}"] = (w4_matmul, f"launches_{body}")
    for body in ("p3", "bf16", "w8a8"):
        kernels[f"resident_scan_{body}"] = (resident_scan, f"launches_{body}")
    for variant in ("dots", "lstm", "attn"):
        kernels[f"fused_cost_{variant}"] = (fused_cost, f"launches_{variant}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))
    if args.k4:
        phase_k4_bf16(dev)
        return 0
    if args.k1_bf16:
        t0 = time.perf_counter()
        _build.load_library("decoder")
        emit("build", seconds=time.perf_counter() - t0,
             nvcc_seconds={"decoder": _build.build_seconds["decoder"]})
        with open("config.json") as f:
            config = json.load(f)
        frontend = TextFrontend.from_config(config["data_config"])
        model, cfg = flowtron_init(1234, **config["model_config"])
        # the flows' heads as the full run perturbs them (its seed's draws)
        perturb_flow_heads(model, torch.Generator().manual_seed(2))
        model.to(dev)
        phase_k1_bf16(model, bf16_copy(model), cfg,
                      [frontend.get_text(t) for t in TEXTS],
                      int(frontend.get_speaker_id(0)), dev)
        return 0
    if args.k2_bf16:
        t0 = time.perf_counter()
        _build.load_library("wavenet")
        emit("build", seconds=time.perf_counter() - t0,
             nvcc_seconds={"wavenet": _build.build_seconds["wavenet"]})
        with open("configs/config_waveglow.json") as f:
            wg, _ = waveglow_init(1, **json.load(f)["waveglow_config"])
        wg.to(dev)
        phase_k2_bf16(wg, bf16_copy(wg), dev)
        emit("run", seconds=time.perf_counter() - t_run)
        return 0

    names = ("decoder", "wavenet", "attention", "qmm", "w4", "resident",
             "fused_cost")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per source
        list(pool.map(_build.load_library, names))
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds={n: _build.build_seconds[n] for n in names},
         flags=" ".join(_build.NVCC_FLAGS))

    with open("config.json") as f:
        config = json.load(f)
    with open("configs/config_waveglow.json") as f:
        wg_config = json.load(f)
    frontend = TextFrontend.from_config(config["data_config"])
    sid = int(frontend.get_speaker_id(0))
    ids = [frontend.get_text(t) for t in TEXTS]
    model, cfg = flowtron_init(1234, **config["model_config"])
    wg, wg_cfg = waveglow_init(1, **wg_config["waveglow_config"])
    perturb_heads(model, wg, seed=2)
    model.to(dev), wg.to(dev)

    k1_err, k1_times, stop, k1_frames = phase_k1(model, cfg, ids, sid, dev)
    k2_err, k2_times = phase_k2(wg, dev)
    k2_wide = phase_k2_wide(dev)
    phase_waveglow_split(wg, wg_cfg, dev)
    k4 = phase_k4(dev)
    # the audio tail and the streaming path, the gate as drawn
    stft_launches = phase_stft(wg, wg_cfg, kernels, dev)
    stream_launches = phase_stream(model, cfg, wg, wg_cfg, ids, sid, stop,
                                   kernels, dev)

    reset_launches(kernels)                  # the inference path
    phase_slice(model, cfg, wg, wg_cfg, ids, sid, stop, dev)
    infer_launches = read_launches(kernels)
    check(infer_launches["fused_flow_infer"] > 0
          and infer_launches["wn_layer"] > 0
          and infer_launches["quantized_matmul_w8a8"] == 0,
          f"inference path: {infer_launches}")
    phase_cpu_agreement(model, cfg, wg, wg_cfg, dev)
    # the mux at full width, the gate biased off by phase_slice
    mux_launches = phase_mux(model, cfg, wg, wg_cfg, ids, sid, kernels, dev)
    # bf16 serving: the kernels' bf16 bodies against their plain versions,
    # then the bf16 chain beside the fp32 one
    t0 = time.perf_counter()
    model16, wg16 = bf16_copy(model), bf16_copy(wg)
    k1_16 = phase_k1_bf16(model, model16, cfg, ids, sid, dev)
    k2_16 = phase_k2_bf16(wg, wg16, dev)
    k4_16 = phase_k4_bf16(dev)
    slice16 = phase_bf16_slice(model, model16, cfg, wg, wg16, wg_cfg, ids,
                               sid, kernels, dev)
    del model16, wg16
    torch.cuda.empty_cache()
    bf16_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        # the model as phase_slice left it: heads perturbed, the gate
        # biased off, so served requests run to their n_frames caps
        ft_path, wg_path = (os.path.join(tmp, n) for n in ("ft.pt", "wg.pt"))
        torch.save(model.state_dict(), ft_path)
        torch.save(wg.state_dict(), wg_path)
        phase_quant_vs_cpu(model, cfg, dev)
        del model, wg
        torch.cuda.empty_cache()
        serve, mixed = phase_serve(ft_path, wg_path, kernels, "")
        check(serve["fused_flow_infer"] > 0 and serve["wn_layer"] > 0
              and serve["quantized_matmul_w8a8"] == 0
              and serve["quantized_matmul_w8"] == 0,
              f"fp32 serving path: {serve}")
        check(mixed["fused_flow_infer"] == 0 and mixed["wn_layer"] > 0,
              f"mixed-temperature wave went through K1: {mixed}")
        q_serve, _ = phase_serve(ft_path, wg_path, kernels, "w8a8")
        check(q_serve["quantized_matmul_w8a8"] > 0
              and q_serve["wn_layer"] > 0
              and q_serve["fused_flow_infer"] == 0
              and q_serve["quantized_matmul_w8"] == 0,
              f"w8a8 serving path: {q_serve}")
        # --bf16: the bf16 bodies and no fp32 body, alone and with w8a8,
        # then a stream and the 2-slot mux
        t0 = time.perf_counter()
        serve16, mixed16 = phase_serve(ft_path, wg_path, kernels, "",
                                       bf16=True)
        bf16_only("serve bf16", serve16)
        check(mixed16["fused_flow_infer"] == 0 and mixed16["wn_layer"]
              == mixed16["wn_layer_bf16"] > 0,
              f"bf16 mixed-temperature wave: {mixed16}")
        q_serve16, _ = phase_serve(ft_path, wg_path, kernels, "w8a8",
                                   bf16=True)
        bf16_only("serve bf16 w8a8", q_serve16, k4=True)
        check(q_serve16["fused_flow_infer"] == 0,
              f"bf16 w8a8 serving path went through K1: {q_serve16}")
        streams16 = phase_serve_bf16_streams(ft_path, wg_path, kernels)
        modes16 = phase_serve_bf16_modes(ft_path, wg_path, kernels)
        # the ratio of the waves' medians, and its range over the waves
        # (the slowest bf16 wave over the fastest fp32 one, and back)
        rps = {k: (statistics.median(v), min(v), max(v))
               for k, v in SERVE_RPS.items()}
        emit("serve_bf16", seconds=time.perf_counter() - t0 + bf16_s,
             waves=SERVE_WAVES,
             requests_per_s_median_min_max={f"{q} {d}": v
                                            for (q, d), v in rps.items()},
             bf16_over_fp32={q: rps[q, "bf16"][0] / rps[q, "fp32"][0]
                             for q in ("float", "w8a8")},
             bf16_over_fp32_range={
                 q: (rps[q, "bf16"][1] / rps[q, "fp32"][2],
                     rps[q, "bf16"][2] / rps[q, "fp32"][1])
                 for q in ("float", "w8a8")},
             launches=serve16, w8a8_launches=q_serve16,
             mixed_launches=mixed16)
        serve_stream, pooled_body, pooled_pcm = phase_serve_stream(
            ft_path, wg_path, kernels)
        serve_mux = phase_serve_mux(ft_path, wg_path, kernels, pooled_body,
                                    pooled_pcm)
        serve_staged = phase_serve_staged(ft_path, wg_path, kernels)
        gl_serve = phase_griffin_lim_serve(ft_path, kernels)
        serve_replicas = phase_serve_replicas(ft_path, wg_path, kernels)
        serve_mesh = phase_serve_mesh(ft_path, wg_path, kernels, dev)
        serve_models, serve_profile = phase_serve_admin(
            ft_path, wg_path, kernels, smi, tmp)
    paths = dict(inference=infer_launches, stream=stream_launches,
                 denoiser=stft_launches, serve=serve,
                 serve_stream=serve_stream, griffin_lim_serve=gl_serve,
                 serve_w8a8=q_serve, mux=mux_launches, serve_mux=serve_mux,
                 serve_staged=serve_staged, serve_replicas=serve_replicas,
                 serve_mesh=serve_mesh,
                 serve_models=serve_models, serve_profile=serve_profile,
                 bf16_slice=slice16, serve_bf16=serve16,
                 serve_bf16_w8a8=q_serve16,
                 serve_bf16_stream=streams16["pooled_w8a8"],
                 serve_bf16_mux=streams16["mux"],
                 serve_bf16_w8=modes16["w8"],
                 serve_bf16_w4_buckets=modes16["w4_buckets"])

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        corpus = make_aligned_corpus(os.path.join(tmp, "corpus"),
                                     n_utterances=N_UTTS, seed=0,
                                     val_count=N_VAL)
        emit("corpus", utterances=N_UTTS, validation=N_VAL,
             seconds=time.perf_counter() - t0)
        out_dir, fp32_run, shape = phase_train(corpus, tmp, kernels, dev)
        train_launches = fp32_run["launches"]
        k3 = phase_k3(shape, config["model_config"]["n_attn_channels"], dev)
        phase_train_vs_cpu(config, dev)
        phase_train_to_infer(config, os.path.join(out_dir, "model_9.pt"),
                             ids, sid, dev)
        style_launches = phase_style_transfer(corpus[0], config, ids,
                                              kernels, smi, dev)
        phase_native_mel(corpus[0], config)
        gm_run, gm_ckpt = phase_train_gm(corpus, tmp, kernels, dev)
        with open(GM_CONFIG) as f:
            phase_train_vs_cpu(json.load(f), dev, "train_gm_vs_cpu")
        remat_launches = phase_train_remat(corpus, tmp, kernels, dev,
                                           fp32_run)
        cumm_launches, cumm_infer = phase_cumm(corpus, tmp, ids[3], kernels,
                                               dev)
        eval_launches = phase_evaluate(corpus, tmp, gm_run, gm_ckpt, kernels,
                                       dev)
        phase_waveglow_train(corpus, tmp, kernels, dev)
        phase_waveglow_train_vs_cpu(corpus, dev)
        wide_launches = phase_waveglow_wide(corpus, tmp, kernels, dev)
        phase_entry()
        ddp_launches, one = phase_ddp(corpus, tmp, dev)
        tp_launches = phase_tp_train(corpus, tmp, one, dev)
        del one
        phase_waveglow_ddp(corpus, tmp)
    emit("launches_by_path", **paths, train_fp32=train_launches,
         train_gm=gm_run["launches"], train_remat=remat_launches,
         cumm_train=cumm_launches, cumm_request=cumm_infer,
         evaluate=eval_launches, waveglow_wide=wide_launches,
         ddp_ranks=ddp_launches, tp_train_ranks=tp_launches,
         style_transfer=style_launches)
    probes, probe_launches = phase_probes(kernels, k1_frames, dev)
    loaded = [m for m in sys.modules if m in ("jax", "optax", "flowtron_tpu")
              or m.startswith(("jax.", "optax.", "flowtron_tpu."))]
    check(not loaded, f"the JAX package, jax or optax was imported: "
          f"{loaded}")

    def row(name, source, replaces, launches, err, times, library_ms=None):
        ms, plain_ms, bound_ms, bound_by = times[:4]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    # K1: one gated flow of the first request (B=1, 400 frames); K2: one
    # WN layer (layer 3) at B=1, T=12800, its bound the three bf16 passes
    # of its products (C=256; by_width: 512 and 1024); K3: the first
    # training batch, fp32; K4: one flow-frame's nine calls at B=8, summed
    # (the library call is the fp32 cuBLAS product on the pre-dequantized
    # weight). K4's launches
    # are the w8a8 server's main wave: JAX routes only a8 leaves to the
    # kernel, so the weight-only body launches 0 times on any path.
    # each kernel's launches on the paths of style transfer, runtime
    # voices and the /profile capture, beside its main path's
    def launches_on(name):
        return {p: launches[name] for p, launches in (
            ("style_transfer", style_launches),
            ("serve_models", serve_models), ("serve_profile", serve_profile))}

    emit("run", seconds=time.perf_counter() - t_run)
    print(json.dumps({"kernels": [
        dict(row("fused_flow_infer", "flowtron_tpu_torch/csrc/decoder.cu",
                 "flowtron_tpu/ops/decoder_pallas.py:229",
                 infer_launches["fused_flow_infer"], k1_err, k1_times),
             launches_on=launches_on("fused_flow_infer")),
        dict(row("wn_layer", "flowtron_tpu_torch/csrc/wavenet.cu",
                 "flowtron_tpu/ops/wavenet_pallas.py:57",
                 infer_launches["wn_layer"], k2_err, k2_times),
             launches_on=launches_on("wn_layer"),
             # the wide builds: layer 3 at B=1, T=12800; launches of one
             # 400-frame pass of a WaveGlow that wide (waveglow_wide)
             by_width={C: dict(row(
                 "wn_layer", "flowtron_tpu_torch/csrc/wavenet.cu",
                 "flowtron_tpu/ops/wavenet_pallas.py:57", wide_launches[C],
                 k2_wide[C][0], k2_wide[C][1:5]), bm=k2_wide[C][5])
                 for C in K2_WIDE}),
        dict(row("attention_scores_fwd",
                 "flowtron_tpu_torch/csrc/attention.cu",
                 "flowtron_tpu/ops/attention_pallas.py:46",
                 train_launches["attention_scores_fwd"], k3["fwd"][0],
                 k3["fwd"][1:]),
             launches_on=launches_on("attention_scores_fwd")),
        row("attention_scores_bwd", "flowtron_tpu_torch/csrc/attention.cu",
            "flowtron_tpu/ops/attention_pallas.py:92",
            train_launches["attention_scores_bwd"], k3["bwd"][0],
            k3["bwd"][1:]),
        row("quantized_matmul_w8a8", "flowtron_tpu_torch/csrc/qmm.cu",
            "flowtron_tpu/ops/qmm_pallas.py:37",
            q_serve["quantized_matmul_w8a8"], k4["w8a8"][0],
            k4["w8a8"][1:5], k4["w8a8"][5]),
        row("quantized_matmul_w8", "flowtron_tpu_torch/csrc/qmm.cu",
            "flowtron_tpu/ops/qmm_pallas.py:31",
            q_serve["quantized_matmul_w8"], k4["w8"][0], k4["w8"][1:5],
            k4["w8"][5]),
        # the bf16 bodies (the JAX server's --bf16): K1 one gated flow of
        # the first request (B=1, 400 frames); K2 layer 3 at B=1, T=12800,
        # one bf16 pass, device time in CUDA graphs; K4 one flow-frame's
        # nine calls at B=8 beside the bf16 cuBLAS product. Launches: the --bf16 server's main wave (K4:
        # the --bf16 --quantize w8a8 server's)
        row("fused_flow_infer_bf16", "flowtron_tpu_torch/csrc/decoder.cu",
            "flowtron_tpu/ops/decoder_pallas.py:229",
            serve16["fused_flow_infer_bf16"], k1_16[0], k1_16[1]),
        row("wn_layer_bf16", "flowtron_tpu_torch/csrc/wavenet.cu",
            "flowtron_tpu/ops/wavenet_pallas.py:57",
            serve16["wn_layer_bf16"], k2_16[0], k2_16[1]),
        row("quantized_matmul_w8a8_bf16", "flowtron_tpu_torch/csrc/qmm.cu",
            "flowtron_tpu/ops/qmm_pallas.py:37",
            q_serve16["quantized_matmul_w8a8_bf16"], k4_16["w8a8"][0],
            k4_16["w8a8"][1:5], k4_16["w8a8"][5]),
        row("quantized_matmul_w8_bf16", "flowtron_tpu_torch/csrc/qmm.cu",
            "flowtron_tpu/ops/qmm_pallas.py:31",
            q_serve16["quantized_matmul_w8_bf16"], k4_16["w8"][0],
            k4_16["w8"][1:5], k4_16["w8"][5]),
    ] + [
        # the probes: P1 one call at B=64; P2 one step of its 2000-step
        # scan at B=64; P3 a step at B=64, P4 and P5 a step at B=1 (B=8 in
        # the probe lines); launches: the probes' entry points (a launch
        # of P3-P5 runs a whole scan or recurrence)
        dict(row(name, f"flowtron_tpu_torch/csrc/{src}.cu", replaces,
                 probe_launches[name], probes[key]["err"],
                 (probes[key]["ms"], probes[key]["plain_ms"])
                 + probes[key]["bound"], probes[key]["library_ms"]),
             per="call" if key.startswith("k") else "step",
             # a dependent chain's latency floor (its barriers a step at the
             # measured barrier), beside the bound, not a bound
             **({"latency_floor_ms": probes[key]["floor_us"] / 1e3}
                if "floor_us" in probes[key] else {}))
        for name, src, replaces in PROBE_ROWS
        for key in [name.rsplit("_", 1)[1]]
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
