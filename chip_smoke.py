"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``flowtron_tpu_torch/csrc/`` (into
``build/torch_kernels/``, one ``nvcc`` per source, all started together),
holds each against its plain PyTorch version at its path's shapes, then
drives the port's three paths at the full width of the repo's
``config.json`` model, on seeded random weights:

- inference (text -> mel -> audio) through
  ``flowtron_tpu_torch.infer.sampling`` with the
  ``configs/config_waveglow.json`` vocoder (kernels K1, K2);
- batch serving: the HTTP server of ``flowtron_tpu_torch.serve``, built
  in-process by ``serve/cli.py:build_server`` from the model saved to
  ``.pt`` files, first unquantized (K1, K2), then with ``--quantize
  w8a8`` (K4, K2), each answering concurrent ``POST /synthesize``
  requests; then the quantized modes (w8, w8a8, w4) card against CPU;
- training through ``flowtron_tpu_torch.cli.train_main`` on a synthetic
  coded-tone corpus written to a temporary directory: one epoch of 10
  steps with ``config.json``'s bf16 policy, then one in fp32 (kernel K3,
  forward and backward); the fp32 run's checkpoint is then loaded for
  inference and put through the invertibility oracle;
- the TPU probes of ``scripts/exp_*.py`` (P1-P5) through their ports in
  ``flowtron_tpu_torch/scripts/``: the int4 dequant matmuls (``w4.cu``),
  the resident-weight scans (``resident.cu``) and K1 stripped for cost
  attribution (``fused_cost.cu``), each kernel first held against its
  plain version over the first 16 steps, then each module's ``main``
  driven at the script's default batch (and B=8 for P4 and P5).

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
"""

import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave
from concurrent.futures import ThreadPoolExecutor

import torch

N_FRAMES = 400      # the reference's inference operating point
TK = 128            # text length of the random-text kernel checks
HOP, SR = 256, 22050
SIGMA = 0.5         # the latents' scale in infer/sampling.py:synthesize
REQ_SEED = 100      # latents seed of the first request
K1_TOL = 1e-3       # mel / attn / gate max-abs, kernel vs plain, fp32
K2_TOL = 1e-4       # max-abs relative to the output scale, fp32
K3_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # of the output scale
SLICE_TOL = 1e-3    # card slice vs CPU plain slice, fp32
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
PEAK_OPS_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
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


def graph_times(fns, side, reps=20, rounds=3):
    """Device time per call of each fn in ``fns``: ``reps`` calls captured
    in one CUDA graph each and replayed in turns (the first fn, the
    second, ... then the reverse), ``rounds`` times; host dispatch does
    not count. Returns each fn's median ms per call and its last output.
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
    return [statistics.median(r) for r in runs], outs


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
        fused_flow_infer, fused_flow_infer_reference)

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
    fields = dict(gated=gated, B=B, N=N_FRAMES, Tk=Tk,
                  key_mask=in_lens is not None, max_abs_err_mel=errs[0],
                  max_abs_err_attn=errs[1], max_abs_err_gate=errs[2],
                  n_valid=nv_k.tolist(), kernel_ms=k_ms, plain_ms=p_ms,
                  runs_plain_kernel_kernel_plain_ms=runs,
                  kernel_us_per_frame=1e3 * k_ms / N_FRAMES,
                  early_threshold=thresh, early_n_valid=expect.tolist(),
                  early_kernel_ms=ke_ms, early_max_abs_err=max(errs_e))
    return fields, max(errs + errs_e), out_k[2], expect


def k1_bound(weights, N, B, Tk, D, M=80):
    """K1's floor for one flow over N frames: the packed weights, latents,
    keys, values and key mask read once, mel, attention and gates written
    once, fp32; per frame and stream 2 operations per weight element and
    6 per (text position, attention channel) of the attention."""
    tensors = [t for v in weights.values()
               for t in ([v] if torch.is_tensor(v) else
                         [x for pair in v for x in pair])]
    n_w = sum(t.numel() for t in tensors)
    n_bytes = 4 * (n_w + 2 * N * B * M + 2 * B * Tk * D + B * Tk
                   + N * B * Tk + N * B)
    return bound(n_bytes, N * B * (2 * n_w + 6 * Tk * D))


def phase_k1(model, cfg, ids, sid, dev):
    """K1 on the card: the gated last flow (run first on the main path) at
    Tk=128, then both flows at the main path's own shapes: the first
    request's text at B=1 with the latents that request draws, and the
    four texts padded with their key mask at B=4. The ungated flow gets
    the gated flow's early n_valid, as on the main path. Returns the max
    error, the gated flow's B=1 request-shape times, and the threshold
    and n_valid at which the first request's gate stops it."""
    gated, ungated = model.flows[-1].ar_step, model.flows[0]
    g = torch.Generator().manual_seed(11)
    rand_text = torch.randint(1, 185, (4, TK), generator=g)
    batch_text, batch_lens = pad_ids(ids)
    # synthesize's latents, flipped as the backward (gated) flow sees them
    z_req = SIGMA * torch.randn(1, 80, N_FRAMES, generator=torch.Generator()
                                .manual_seed(REQ_SEED))
    cases = [
        ("random_text", rand_text[:1], None,
         0.5 * torch.randn(N_FRAMES, 1, 80, generator=g)),
        ("random_text", rand_text, torch.tensor([TK, 100, 77, 50]),
         0.5 * torch.randn(N_FRAMES, 4, 80, generator=g)),
        ("request", batch_text[:1, :len(ids[0])], None,
         z_req.permute(2, 0, 1).flip(0)),
        ("batch", batch_text, batch_lens,
         0.5 * torch.randn(N_FRAMES, 4, 80, generator=g)),
    ]
    max_err, times, stop = 0.0, None, None
    for shape, text, in_lens, res in cases:
        flows = [gated] if shape == "random_text" else [gated, ungated]
        nv_in = None
        for flow in flows:
            fields, err, gates, nv_in = k1_case(
                model, cfg, flow, sid, text, in_lens, res, nv_in, dev)
            max_err = max(max_err, err)
            emit("k1", shape=shape, **fields)
            if shape == "request" and flow is gated:
                times = (fields["kernel_ms"], fields["plain_ms"]) + k1_bound(
                    flow.packed_weights(), N_FRAMES, 1, text.shape[1],
                    flow.attention_layer.query.linear_layer.weight.shape[0])
                stop = gate_stop(gates[:, 0])
    return max_err, times, stop


def phase_k2(wg, dev):
    from flowtron_tpu_torch.ops.wavenet import wn_layer, wn_layer_reference

    wn = wg.WN[0]
    C = wn.n_channels
    T = N_FRAMES * HOP // 8                   # 12800 grouped samples
    g = torch.Generator().manual_seed(12)
    max_err, times = 0.0, None
    for layer, Tp in ((3, T), (7, T), (3, T + 96)):
        w_cat, b, w_rs, b_rs = wn.packed_layers()[layer]
        x = torch.randn(1, Tp, C, generator=g)
        x[:, T:] = 0
        x = x.to(dev)
        cond_all = torch.randn(1, Tp, 2 * C * wn.n_layers, generator=g).to(dev)
        cond = cond_all[..., 2 * C * layer:2 * C * (layer + 1)]
        args = (x, 2 ** layer, cond, w_cat, b, w_rs, b_rs, T)
        with torch.no_grad():
            k_ms, p_ms, runs, out_k, out_p = paired_ms(
                lambda: wn_layer(*args), lambda: wn_layer_reference(*args),
                reps=20, plain_reps=20)
        abs_errs, errs = [], []
        for a, r in zip(out_k, out_p):
            if r is not None:
                abs_errs.append(float((a - r).abs().max()))
                errs.append(abs_errs[-1] / max(1.0, float(r.abs().max())))
        check(all(e <= K2_TOL for e in errs), f"K2 layer {layer} err {errs}")
        if out_k[0] is not None and Tp > T:
            check(bool((out_k[0][:, T:] == 0).all()), "K2 pad rows not zero")
        max_err = max([max_err] + abs_errs)
        flops = 2 * Tp * (3 * C * 2 * C + C * w_rs.shape[1])
        if Tp == T and layer == 3:
            # x, cond, weights and biases read once; x' and skip written
            n_bytes = 4 * (Tp * C + Tp * 2 * C + 3 * C * 2 * C + 2 * C
                           + C * w_rs.shape[1] + w_rs.shape[1] + 2 * Tp * C)
            times = (k_ms, p_ms) + bound(n_bytes, flops)
        emit("k2", layer=layer, last=out_k[0] is None, C=C, B=1, T=T, Tp=Tp,
             max_abs_err=max(abs_errs), max_rel_err=max(errs),
             kernel_ms=k_ms, plain_ms=p_ms,
             runs_plain_kernel_kernel_plain_ms=runs,
             kernel_tflops=flops / k_ms / 1e9, plain_tflops=flops / p_ms / 1e9)
    return max_err, times


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
    audio, _, n = text_to_audio(model, cfg, wg, wg_cfg, ids[0], sid,
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
        audio, mel, n = text_to_audio(model, cfg, wg, wg_cfg, ids[i], sid,
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
    (k_ms, p_ms, lib_ms), (out_k, out_p, _) = graph_times([
        lambda: quantized_matmul(x, q, s, a8=a8),
        lambda: quantized_matmul_reference(x, q, s, a8=a8),
        lambda: torch.nn.functional.linear(x, w)], side)
    # the same call launched from Python, as the per-frame loop does
    eager_ms, _ = cuda_ms(lambda: quantized_matmul(x, q, s, a8=a8), reps=20)
    err = float((out_k - out_p).abs().max())
    scale = float(out_p.abs().max())
    tag = f"K4 {'w8a8' if a8 else 'w8'} M={M} K={K} N={N}"
    check(math.isfinite(err), f"{tag} not finite")
    if a8:
        check(torch.equal(out_k, out_p), f"{tag} not bitwise: err {err}")
    else:
        check(err <= K4_W8_TOL * scale, f"{tag} err {err} scale {scale}")
    n_bytes = 4 * M * K + N * K + 4 * N + 4 * M * N
    bound_ms, bound_by = bound(n_bytes, 2 * M * K * N,
                               "int8" if a8 else "fp32")
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


def phase_serve(ft_path, wg_path, kernels, quantize):
    """The batch-serving path: the port's HTTP server built in-process by
    serve/cli.py:build_server (--warmup), then 8 concurrent requests (the four
    texts x 2 seeds) with one capped at 120 frames alongside, then a wave
    of 4 with mixed temperatures. Returns the launches of the main wave
    and of the mixed wave."""
    from flowtron_tpu_torch.serve.cli import build_server

    argv = ["-c", "config.json", "-f", ft_path, "-w", wg_path, "--port",
            "0", "--warmup"] + (["--quantize", quantize] if quantize else [])
    tag = f"serve {quantize or 'fp32'}"
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
    emit("serve", quantize=quantize or None, build_and_warmup_s=start_s,
         requests=len(bodies), wall_s=wall, requests_per_s=len(bodies) / wall,
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


def reset_launches(kernels):
    for fn, attr in kernels.values():
        setattr(fn, attr, 0)


def read_launches(kernels):
    """Each counter, K4's split by body: quantized_matmul counts both
    bodies' launches, quantized_matmul_w8a8 the W8A8 body's."""
    out = {name: getattr(fn, attr) for name, (fn, attr) in kernels.items()}
    out["quantized_matmul_w8"] = out.pop("quantized_matmul") \
        - out["quantized_matmul_w8a8"]
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


def phase_k3(shape, D, dev):
    """K3 forward and backward against their plain versions at the padded
    (B, T, Tk) of the first batch the training path drew (from its log)
    and the flagship D, in fp32 and bf16, and
    at one unaligned shape; two backward runs must be bitwise equal.
    Returns the kernel table's fields of the fp32 flagship case."""
    from flowtron_tpu_torch.ops.attention import (
        attention_scores_backward_reference, attention_scores_bwd,
        attention_scores_fwd, attention_scores_reference)

    B, T, Tk = shape
    g = torch.Generator().manual_seed(13)
    table = {}
    for (b, tq, tk), tag in (((B, T, Tk), "train_batch"),
                             ((3, 19, 7), "unaligned")):
        for dtype in (torch.float32, torch.bfloat16):
            q = (0.5 * torch.randn(b, tq, D, generator=g)).to(dev, dtype)
            k = (0.5 * torch.randn(b, tk, D, generator=g)).to(dev, dtype)
            v = (0.1 * torch.randn(D, generator=g)).to(dev, dtype)
            ds = torch.randn(b, tq, tk, generator=g).to(dev, dtype)
            temp = 1.0
            with torch.no_grad():
                f_ms, fp_ms, f_runs, out_k, out_p = paired_ms(
                    lambda: attention_scores_fwd(q, k, v, temp),
                    lambda: attention_scores_reference(q, k, v, temp),
                    reps=20, plain_reps=5)
                b_ms, bp_ms, b_runs, grads_k, grads_p = paired_ms(
                    lambda: attention_scores_bwd(q, k, v, ds, temp),
                    lambda: attention_scores_backward_reference(
                        q, k, v, ds, temp), reps=20, plain_reps=5)
                # the kernel accumulates in fp32: hold it against the plain
                # math on the same inputs, accumulated in fp32
                ref = attention_scores_reference(q.float(), k.float(),
                                                 v.float(), temp)
                again = attention_scores_bwd(q, k, v, ds, temp)
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
            emit("k3", shape=tag, dtype=str(dtype)[6:], B=b, Tq=tq, Tk=tk,
                 D=D, fwd_max_abs_err=fwd_err, fwd_scale=scale,
                 fwd_max_abs_err_vs_plain_same_dtype=fwd_err_plain,
                 bwd_max_abs_err_dq_dk_dv=bwd_abs,
                 bwd_max_rel_err_dq_dk_dv=bwd_rel, bwd_bitwise_repeat=bitwise,
                 fwd_kernel_ms=f_ms, fwd_plain_ms=fp_ms,
                 bwd_kernel_ms=b_ms, bwd_plain_ms=bp_ms,
                 fwd_runs_plain_kernel_kernel_plain_ms=f_runs,
                 bwd_runs_plain_kernel_kernel_plain_ms=b_runs)
            if tag == "train_batch" and dtype == torch.float32:
                # q, k, v (and ds) read once, scores (or dq, dk, dv)
                # written once; 4 operations per (b, t, k, d) forward
                # (add, tanh, multiply, add), 10 backward (recompute add
                # and tanh, 1 - t^2, two products, three accumulations)
                qkv = b * tq * D + b * tk * D + D
                elems = b * tq * tk * D
                table = {
                    "fwd": (fwd_err, f_ms, fp_ms)
                    + bound(4 * (qkv + b * tq * tk), 4 * elems),
                    "bwd": (max(bwd_abs), b_ms, bp_ms)
                    + bound(4 * (2 * qkv + b * tq * tk), 10 * elems)}
    return table


def phase_train(corpus, tmp, kernels, dev):
    """The training path: cli.train_main from config.json, once with its
    bf16 policy (fp16_run true) and once in fp32, 10 flagship-width steps
    each. Returns the fp32 run's output directory, K3's launches and the
    padded (B, T, Tk) of the first batch, from the training log."""
    from flowtron_tpu_torch.cli import train_main

    launches = {}
    for fp16_run in (True, False):
        out_dir = os.path.join(tmp, "bf16" if fp16_run else "fp32")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)    # by earlier phases
        reset_launches(kernels)
        t0 = time.perf_counter()
        train_main(train_args(corpus, out_dir, fp16_run))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[fp16_run] = read_launches(kernels)
        peak = torch.cuda.max_memory_allocated(dev)
        with open(os.path.join(out_dir, "train_log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        steps = [r for r in log if "loss" in r]
        vals = [r for r in log if "validation" in r]
        losses = [r["loss"] for r in steps]
        tag = "bf16" if fp16_run else "fp32"
        check(len(steps) >= 10, f"train {tag}: {len(steps)} steps")
        check(all(math.isfinite(x) for x in losses),
              f"train {tag}: loss not finite {losses}")
        check(losses[-1] < losses[0],
              f"train {tag}: last loss {losses[-1]} not below the first "
              f"{losses[0]}")
        check(launches[fp16_run]["attention_scores_fwd"] > 0
              and launches[fp16_run]["attention_scores_bwd"] > 0,
              f"train {tag}: K3 not launched {launches[fp16_run]}")
        check(launches[fp16_run]["fused_flow_infer"] == 0
              and launches[fp16_run]["wn_layer"] == 0
              and launches[fp16_run]["quantized_matmul_w8a8"] == 0
              and launches[fp16_run]["quantized_matmul_w8"] == 0,
              f"train {tag}: inference kernels launched")
        check(os.path.exists(os.path.join(out_dir, "model_9.pt")),
              f"train {tag}: no checkpoint model_9.pt")
        timed = steps[1:]                     # step 0 includes warm-up
        frames = sum(r["frames"] for r in timed)
        seconds = sum(r["step_s"] for r in timed)
        emit("train", policy=tag, steps=len(steps),
             loss=losses, nll=[r["nll"] for r in steps],
             gate=[r["gate"] for r in steps],
             grad_norm=[r["grad_norm"] for r in steps],
             padded_shapes=[r["padded_shape"] for r in steps],
             step_ms=[1e3 * r["step_s"] for r in steps],
             ms_per_step_median=1e3 * statistics.median(
                 r["step_s"] for r in timed),
             mel_frames_per_s=frames / seconds,
             peak_memory_allocated_bytes=peak,
             allocated_before_run_bytes=held,
             validation=[{"iteration": r["iteration"], **r["validation"]}
                         for r in vals],
             wall_s=wall, launches=launches[fp16_run])
    return os.path.join(tmp, "fp32"), launches[False], \
        tuple(steps[0]["padded_shape"])


def phase_train_vs_cpu(config, dev):
    """One flagship-width step (B=2, T=32, fp32, CTC on, dropout off) on
    the card against the plain path on the CPU: loss and gradient norm."""
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
    emit("train_vs_cpu", B=B, T=T, Tk=Tk,
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
        (k_ms, p_ms, lib_ms), (out_k, out_p, _) = graph_times([
            lambda: w4_matmul(x, q, s, body),
            lambda: w4_matmul_reference(x, q, s, body),
            lambda: xin @ w_deq], side)
        err = probe_check(f"P1 {body}", out_k, out_p, PROBE_BF16_TOL)
        n_bytes = 2 * B * n_rows + q.numel() + 2 * B * OUT + (
            4 * s.numel() if BODIES[body][0] else 0)
        rows[body] = dict(err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                          bound=probe_bound(n_bytes, 2 * B * n_rows * OUT,
                                            "bf16", 1))
        emit("probe_w4", body=body, B=B, IN=IN, OUT=OUT, max_abs_err=err,
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


def probes_scans(dev):
    """P3, P4 and P5 against their plain versions on the card over 16
    steps at the scripts' shapes (and B=8 for P4, P5); then each timed
    over the script's STEPS or N: the kernel, the plain version (eager,
    as the other kernels' plain versions) and, for P3 and P4, the streamed
    cuBLAS step in a CUDA graph. Also the resident bytes, the L2 bytes an
    access-policy window may pin, and the time of a chain of four tiny
    dots (each step is then mostly its four grid barriers). Returns the
    kernel table's fields."""
    from flowtron_tpu_torch.ops.fused_cost import (
        VARIANTS, fused_cost, fused_cost_reference, pack_weights)
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
            packed = pack_resident_weights(body, args[1], args[2])
            steps = p4.STEPS
            k_ms = per_step(lambda: resident_scan(body, *args, steps=steps,
                                                  packed=packed), steps)
            res_bytes, resident = resident_scan.last_resident
            lib_ms = per_step(_probe.scan(p4.library_step(args[1], args[2]),
                                          args[0].float(), steps), steps)
            fields = dict(body=body, B=B, steps=steps,
                          check_steps=PROBE_STEPS, max_abs_err=err,
                          kernel_us_per_step=1e3 * k_ms,
                          cublas_streamed_us_per_step=1e3 * lib_ms,
                          resident_bytes=res_bytes, resident_dots=resident)
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
    # four tiny dependent dots a step: mostly the four grid barriers
    tiny = [(256, 1024)] * 4
    args = p4.to_device("bf16", p4.make_inputs("bf16", 1, tiny), dev)
    tiny_ms = per_step(lambda: resident_scan("bf16", *args, steps=p4.STEPS),
                       p4.STEPS)
    emit("probe_p4_barriers", shapes=tiny, B=1, steps=p4.STEPS,
         us_per_step=1e3 * tiny_ms, us_per_dot=1e3 * tiny_ms / len(tiny))

    # P5: the fp32 mel within PROBE_FP32_TOL of its scale
    for variant in VARIANTS:
        for B in (1, 8):
            ws, z, kv = p5.to_device(p5.make_inputs(variant, B, PROBE_STEPS),
                                     dev)
            err = probe_check(f"P5 {variant} B={B}",
                              fused_cost(variant, z, kv, ws),
                              fused_cost_reference(variant, z, kv, ws),
                              PROBE_FP32_TOL)
            ws, z, kv = p5.to_device(p5.make_inputs(variant, B), dev)
            packed = pack_weights(variant, ws)
            N = z.shape[0]
            k_ms = per_step(lambda: fused_cost(variant, z, kv, ws, packed), N)
            fields = dict(variant=variant, B=B, N=N, check_steps=PROBE_STEPS,
                          max_abs_err=err, kernel_us_per_step=1e3 * k_ms)
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
                                                       "bf16", N))
                fields.update(
                    M=M, plain_us_per_step=1e3 * p_ms,
                    bound_us_per_step=1e3 * rows[variant]["bound"][0])
            emit("probe_p5", **fields)
    return rows


def phase_probes(kernels, dev):
    """The probes of scripts/exp_*.py on the card: each kernel against its
    plain version (probes_w4, probes_scans), then the probes' own entry
    points, each module's ``main`` at the script's default B and, for P4
    and P5, at the serving engine's B=8, with every launch count set to 0
    just before and read just after. The kernels' scans run eagerly there
    (only the library baselines replay CUDA graphs), so each count is the
    launches the run made: one a step for P1's and P2's scans, one a scan
    for P3 and P4, one a recurrence for P5 (a host call launching its
    kernels step by step, as K1 does a flow). Returns the table's fields
    and the entry points' launches."""
    from flowtron_tpu_torch.scripts import (
        exp_fused_cost, exp_fused_int8, exp_int4_variants,
        exp_resident_weight, exp_w4_kernel_bisect)

    side = torch.cuda.Stream()
    rows = probes_w4(side, dev)
    rows.update(probes_scans(dev))
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU and has no CPU fallback",
              file=sys.stderr)
        return 1
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
               "quantized_matmul_w8a8": (quantized_matmul, "launches_w8a8")}
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

    k1_err, k1_times, stop = phase_k1(model, cfg, ids, sid, dev)
    k2_err, k2_times = phase_k2(wg, dev)
    k4 = phase_k4(dev)

    reset_launches(kernels)                  # the inference path
    phase_slice(model, cfg, wg, wg_cfg, ids, sid, stop, dev)
    infer_launches = read_launches(kernels)
    check(infer_launches["fused_flow_infer"] > 0
          and infer_launches["wn_layer"] > 0
          and infer_launches["quantized_matmul_w8a8"] == 0,
          f"inference path: {infer_launches}")
    phase_cpu_agreement(model, cfg, wg, wg_cfg, dev)

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

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        corpus = make_aligned_corpus(os.path.join(tmp, "corpus"),
                                     n_utterances=N_UTTS, seed=0,
                                     val_count=N_VAL)
        emit("corpus", utterances=N_UTTS, validation=N_VAL,
             seconds=time.perf_counter() - t0)
        out_dir, train_launches, shape = phase_train(corpus, tmp, kernels,
                                                     dev)
        k3 = phase_k3(shape, config["model_config"]["n_attn_channels"], dev)
        phase_train_vs_cpu(config, dev)
        phase_train_to_infer(config, os.path.join(out_dir, "model_9.pt"),
                             ids, sid, dev)
    probes, probe_launches = phase_probes(kernels, dev)
    loaded = [m for m in sys.modules if m in ("jax", "flowtron_tpu")
              or m.startswith(("jax.", "flowtron_tpu."))]
    check(not loaded, f"the JAX package or jax was imported: {loaded}")

    def row(name, source, replaces, launches, err, times, library_ms=None):
        ms, plain_ms, bound_ms, bound_by = times[:4]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms}

    # K1: one gated flow of the first request (B=1, 400 frames); K2: one
    # WN layer at T=12800; K3: the first training batch, fp32; K4: one
    # flow-frame's nine calls at B=8, summed (the library call is the
    # fp32 cuBLAS product on the pre-dequantized weight). K4's launches
    # are the w8a8 server's main wave: JAX routes only a8 leaves to the
    # kernel, so the weight-only body launches 0 times on any path.
    print(json.dumps({"kernels": [
        row("fused_flow_infer", "flowtron_tpu_torch/csrc/decoder.cu",
            "flowtron_tpu/ops/decoder_pallas.py:229",
            infer_launches["fused_flow_infer"], k1_err, k1_times),
        row("wn_layer", "flowtron_tpu_torch/csrc/wavenet.cu",
            "flowtron_tpu/ops/wavenet_pallas.py:57",
            infer_launches["wn_layer"], k2_err, k2_times),
        row("attention_scores_fwd", "flowtron_tpu_torch/csrc/attention.cu",
            "flowtron_tpu/ops/attention_pallas.py:46",
            train_launches["attention_scores_fwd"], k3["fwd"][0],
            k3["fwd"][1:]),
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
    ] + [
        # the probes: P1 one call at B=64; P2 one step of its 2000-step
        # scan at B=64; P3 a step at B=64, P4 and P5 a step at B=1 (B=8 in
        # the probe lines); launches: the probes' entry points (a launch
        # of P3-P5 runs a whole scan or recurrence)
        dict(row(name, f"flowtron_tpu_torch/csrc/{src}.cu", replaces,
                 probe_launches[name], probes[key]["err"],
                 (probes[key]["ms"], probes[key]["plain_ms"])
                 + probes[key]["bound"], probes[key]["library_ms"]),
             per="call" if key.startswith("k") else "step")
        for name, src, replaces in PROBE_ROWS
        for key in [name.rsplit("_", 1)[1]]
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
