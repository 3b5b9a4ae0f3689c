"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``flowtron_tpu_torch/csrc/`` (into
``build/torch_kernels/``), holds each against its plain PyTorch version at
the main path's shapes, then drives the inference path (text -> mel ->
audio) through ``flowtron_tpu_torch.infer.sampling`` at the full width of
the repo's ``config.json`` model and ``configs/config_waveglow.json``
vocoder, on seeded random weights. Each phase prints one JSON line; the
line before the last lists the kernels, the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result. There is no CPU fallback: without
CUDA it exits non-zero at once.

Imports nothing of JAX (checked at the end). The only module from beside
the port that runs is the pure-Python text package ``flowtron_tpu.text``,
which the port's ``data/frontend.py`` shares to turn text into ids.
"""

import json
import math
import statistics
import subprocess
import sys
import time

import torch

N_FRAMES = 400      # the reference's inference operating point
TK = 128            # text length of the random-text kernel checks
HOP, SR = 256, 22050
SIGMA = 0.5         # the latents' scale in infer/sampling.py:synthesize
REQ_SEED = 100      # latents seed of the first request
K1_TOL = 1e-3       # mel / attn / gate max-abs, kernel vs plain, fp32
K2_TOL = 1e-4       # max-abs relative to the output scale, fp32
SLICE_TOL = 1e-3    # card slice vs CPU plain slice, fp32
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


def perturb_heads(model, wg, seed):
    """The coupling heads start at zero, which would make mel == z and
    audio independent of the WN stack; 0.05 * normal makes both matter."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for flow in model.flows:
            step = getattr(flow, "ar_step", flow)
            step.conv.weight.copy_(0.05 * torch.randn(
                step.conv.weight.shape, generator=g))
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
                times = (fields["kernel_ms"], fields["plain_ms"])
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
        if Tp == T and layer == 3:
            times = (k_ms, p_ms)
        flops = 2 * Tp * (3 * C * 2 * C + C * w_rs.shape[1])
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU and has no CPU fallback",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowtron_tpu_torch.data.frontend import TextFrontend
    from flowtron_tpu_torch.models.flowtron import flowtron_init
    from flowtron_tpu_torch.ops import _build
    from flowtron_tpu_torch.ops.decoder import fused_flow_infer
    from flowtron_tpu_torch.ops.wavenet import wn_layer
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_init

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0))

    build = {}
    for name in ("decoder", "wavenet"):
        t0 = time.perf_counter()
        _build.load_library(name)
        build[name] = {"seconds": time.perf_counter() - t0,
                       "nvcc_seconds": _build.build_seconds[name],
                       "flags": " ".join(_build.NVCC_FLAGS)}
    emit("build", **build)

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

    fused_flow_infer.launches = 0
    wn_layer.launches = 0
    phase_slice(model, cfg, wg, wg_cfg, ids, sid, stop, dev)
    launches = {"k1": fused_flow_infer.launches, "k2": wn_layer.launches}
    check(launches["k1"] > 0 and launches["k2"] > 0,
          f"main path skipped a kernel: {launches}")
    phase_cpu_agreement(model, cfg, wg, wg_cfg, dev)
    check("jax" not in sys.modules, "jax was imported")

    print(json.dumps({"kernels": [
        {"name": "fused_flow_infer", "route": "cuda",
         "source": "flowtron_tpu_torch/csrc/decoder.cu",
         "replaces": "flowtron_tpu/ops/decoder_pallas.py:229",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": k1_times[0], "plain_ms": k1_times[1]},
        {"name": "wn_layer", "route": "cuda",
         "source": "flowtron_tpu_torch/csrc/wavenet.cu",
         "replaces": "flowtron_tpu/ops/wavenet_pallas.py:57",
         "launches": launches["k2"], "max_abs_err": k2_err,
         "ms": k2_times[0], "plain_ms": k2_times[1]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
