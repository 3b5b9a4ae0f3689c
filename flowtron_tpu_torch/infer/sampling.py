"""Inference: text -> mel -> audio (port of ``load_model_for_inference``,
``synthesize``, ``mel_to_audio_griffinlim``, ``_run_streaming`` and
``run_inference`` in flowtron_tpu/infer/sampling.py).

Loads a reference-format ``.pt`` state_dict or a training checkpoint
(the JAX package's pickle, sharded or orbax checkpoint, or the port's
directory), turns text into ids through the port's frontend, samples
z ~ N(0, sigma^2) from a seeded ``torch.Generator``, inverts the flows,
writes the mel and attention PNG (matplotlib) and vocodes: with WaveGlow when ``-w`` gives one (``-d``
then runs the bias denoiser), else with Griffin-Lim on the host, as the
JAX package does. ``--stream`` writes the wav chunk by chunk as
``infer/streaming.py`` synthesizes it. On a CUDA device the flows run
kernel K1 (a quantized flow runs the per-frame loop, with kernel K4 for
``w8a8``; a streamed flow 0 the loop) and the vocoder's WN layers kernel
K2. ``run_inference`` runs on ``cuda:0`` unless asked for the CPU
(``utils/device.py``).
"""

import os
import time
import wave

import numpy as np
import torch

from flowtron_tpu_torch.audio.griffin_lim import griffin_lim_numpy
from flowtron_tpu_torch.audio.mel import mel_filterbank
from flowtron_tpu_torch.data.frontend import TextFrontend
from flowtron_tpu_torch.infer.quantize import quantize_flows_for_inference
from flowtron_tpu_torch.infer.streaming import stream_tts
from flowtron_tpu_torch.models.flowtron import flowtron_init, flowtron_infer
from flowtron_tpu_torch.train.checkpoints import load_checkpoint, warmstart
from flowtron_tpu_torch.utils.device import resolve_device
from flowtron_tpu_torch.vocoder.denoiser import Denoiser, StreamingDenoiser
from flowtron_tpu_torch.vocoder.waveglow import load_waveglow, waveglow_infer


def load_model_for_inference(config, checkpoint_path, device="cpu"):
    """Build the configured model and load its weights. A
    reference-format ``.pt``/``.pth`` (a bare state_dict, or one under
    ``state_dict`` or ``model``; only tensors are unpickled) goes through
    ``warmstart`` as the JAX package's loader takes it
    (flowtron_tpu/infer/sampling.py:20-27): unknown keys are ignored, a
    missing key keeps its init, a speaker table of another shape keeps
    its init, any other shape mismatch raises. Anything else is a
    training checkpoint read whole by ``load_checkpoint``: the JAX
    package's pickle, sharded or orbax checkpoint, or the port's
    directory."""
    model, static_cfg = flowtron_init(0, **config["model_config"])
    if checkpoint_path.endswith((".pt", ".pth")):
        warmstart(checkpoint_path, model)
    else:
        load_checkpoint(checkpoint_path, model)
    return model.to(device), static_cfg


def synthesize(model, static_cfg, text_ids, speaker_id, n_frames=400,
               sigma=0.5, gate_threshold=0.5, seed=1234, fused=False,
               latents=None):
    """text ids -> (mel (n_mel, n_valid), attns [(n_valid, Tk)], n_valid),
    tensors on the model's device. ``latents``: a standard-normal (1,
    n_mel, n_frames) draw to use instead of the seeded one (sigma is
    applied here)."""
    device = next(model.parameters()).device
    if latents is None:
        g = torch.Generator().manual_seed(seed)
        latents = torch.randn(1, static_cfg["n_mel_channels"], n_frames,
                              generator=g)
    residual = (torch.as_tensor(latents) * sigma).to(device)
    text = torch.as_tensor(np.asarray(text_ids)[None], device=device)
    sid = torch.tensor([speaker_id], device=device)
    mel, attns, n_valid = flowtron_infer(
        model, static_cfg, residual, sid, text,
        gate_threshold=gate_threshold, fused=fused)
    n = int(n_valid[0])
    return mel[0, :, :n], [a[0, :n] for a in attns], n


def text_to_audio(model, static_cfg, wg_model, wg_cfg, text_ids, speaker_id,
                  n_frames=400, sigma=0.5, gate_threshold=0.5, seed=1234,
                  fused=False, wg_sigma=0.8, denoiser=None, strength=0.0):
    """text ids -> (audio (n_valid * 256,) float32 numpy, mel, attns,
    n_valid): the flows, WaveGlow, then the ``denoiser`` at ``strength``
    when one is given."""
    mel, attns, n = synthesize(model, static_cfg, text_ids, speaker_id,
                               n_frames, sigma, gate_threshold, seed, fused)
    audio = waveglow_infer(wg_model, wg_cfg, mel[None], sigma=wg_sigma,
                           seed=seed)
    if denoiser is not None:
        audio = denoiser(audio, strength=strength)
    return audio[0].cpu().numpy(), mel, attns, n


def mel_to_audio_griffinlim(mel, data_config, n_iters=30, seed=0):
    """The vocoder without a WaveGlow checkpoint: invert the mel filterbank
    (pinv, clamped at 0) then Griffin-Lim phase recovery, host numpy. A
    mel of <= 1 frame gives one hop of silence."""
    basis = mel_filterbank(
        data_config["sampling_rate"], data_config["filter_length"],
        int(np.asarray(mel).shape[0]), data_config["mel_fmin"],
        data_config["mel_fmax"])
    mag_est = np.clip(np.linalg.pinv(basis) @ np.exp(np.asarray(mel)),
                      0, None)
    audio = griffin_lim_numpy(
        mag_est, data_config["filter_length"], data_config["hop_length"],
        data_config["win_length"], n_iters=n_iters, seed=seed)
    if audio.size == 0:  # <= 1 mel frame inverts to zero samples
        audio = np.zeros(data_config["hop_length"], np.float32)
    return audio


def write_wav(path, audio, sampling_rate):
    """Peak-normalised 16-bit mono PCM."""
    audio = audio / max(1e-8, float(np.abs(audio).max()))
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm.tobytes())


def save_mel_attention_png(path, mel, attns):
    """The mel (n_mel, n) and each flow's attention (n, Tk) as one PNG
    (matplotlib, imported here as the JAX package does)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1 + len(attns), 1,
                             figsize=(8, 3 * (1 + len(attns))))
    axes = np.atleast_1d(axes)
    axes[0].imshow(mel, aspect="auto", origin="lower", interpolation="none")
    axes[0].set_title("mel")
    for i, a in enumerate(attns):
        axes[1 + i].imshow(a.T, aspect="auto", origin="lower",
                           interpolation="none")
        axes[1 + i].set_title(f"attention flow {i}")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _run_streaming(args, model, static_cfg, text_ids, speaker_id,
                   data_config, device):
    """--stream: write the wav as synthesis runs (any n_flows; a neural
    vocoder is required), through a StreamingDenoiser with ``-d``."""
    if not args.waveglow_path:
        raise SystemExit("--stream requires a vocoder checkpoint (-w)")
    wg_model, wg_cfg = load_waveglow(args.waveglow_path, device)
    sd = None
    if getattr(args, "denoise", 0.0) > 0:
        sd = StreamingDenoiser(
            Denoiser.from_data_config(wg_model, wg_cfg, data_config),
            strength=args.denoise)
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.join(
        args.output_dir,
        f"sid{args.id}_sigma{args.sigma}_seed{args.seed}_stream")
    sr = data_config["sampling_rate"]
    t0 = time.perf_counter()
    n = 0
    with wave.open(base + ".wav", "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)

        def write(samples):
            nonlocal n
            if samples.size == 0:
                return
            pcm = (np.clip(samples, -1, 1) * 32767).astype("<i2")
            w.writeframes(pcm.tobytes())
            n += len(pcm)
            print(f"  +{len(pcm) / sr:.2f}s audio at "
                  f"t={time.perf_counter() - t0:.2f}s", flush=True)

        for chunk in stream_tts(
                model, static_cfg, wg_model, wg_cfg, args.seed,
                torch.tensor([speaker_id], device=device),
                torch.as_tensor(np.asarray(text_ids)[None], device=device),
                sigma=args.sigma, gate_threshold=args.gate,
                max_frames=args.n_frames):
            write(sd.feed(chunk[0]) if sd is not None else chunk[0])
        if sd is not None:
            write(sd.flush())
    print(f"wrote {base}.wav ({n / sr:.2f}s)")
    return base


def run_inference(config, args, device=None):
    """CLI entry (reference:inference.py:93-132 contract). ``args.quantize``
    ("w8", "w8a8", "w4") or ``args.int8`` (w8) quantize the flows first,
    as flowtron_tpu/infer/sampling.py:128-132 does."""
    device = resolve_device(device)
    data_config = config["data_config"]
    model, static_cfg = load_model_for_inference(config, args.flowtron_path,
                                                 device)
    qmode = getattr(args, "quantize", "") or (
        "w8" if getattr(args, "int8", False) else "")
    if qmode:
        model = quantize_flows_for_inference(model, mode=qmode)
    frontend = TextFrontend.from_config(data_config)
    text_ids = frontend.get_text(args.text)
    speaker_id = int(frontend.get_speaker_id(args.id))
    if getattr(args, "stream", False):
        return _run_streaming(args, model, static_cfg, text_ids, speaker_id,
                              data_config, device)

    request = dict(n_frames=args.n_frames, sigma=args.sigma,
                   gate_threshold=args.gate, seed=args.seed,
                   fused="early" if getattr(args, "fused", False) else False)
    if args.waveglow_path:
        wg_model, wg_cfg = load_waveglow(args.waveglow_path, device)
        denoise = getattr(args, "denoise", 0.0)
        denoiser = Denoiser.from_data_config(
            wg_model, wg_cfg, data_config) if denoise > 0 else None
        audio, mel, attns, n_valid = text_to_audio(
            model, static_cfg, wg_model, wg_cfg, text_ids, speaker_id,
            denoiser=denoiser, strength=denoise, **request)
    else:
        mel, attns, n_valid = synthesize(model, static_cfg, text_ids,
                                         speaker_id, **request)
        print("no vocoder checkpoint; using Griffin-Lim")
        audio = mel_to_audio_griffinlim(mel.cpu().numpy(), data_config)
    hop, sr = data_config["hop_length"], data_config["sampling_rate"]
    print(f"synthesized {n_valid} mel frames ({n_valid * hop / sr:.2f}s)")
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.join(args.output_dir,
                        f"sid{args.id}_sigma{args.sigma}_seed{args.seed}")
    save_mel_attention_png(base + ".png", mel.cpu().numpy(),
                           [a.cpu().numpy() for a in attns])
    if audio.size == 0:
        # a 1-frame mel denoised, or vocoded by Griffin-Lim, has no
        # samples; still write a valid (silent) wav
        audio = np.zeros(hop, np.float32)
    write_wav(base + ".wav", audio, sr)
    print("wrote", base + ".wav")
    return base
