"""Inference: text -> mel -> audio (port of ``load_model_for_inference``,
``synthesize`` and ``run_inference`` in flowtron_tpu/infer/sampling.py).

Loads a reference-format ``.pt`` state_dict, turns text into ids through
the port's frontend, samples z ~ N(0, sigma^2) from a seeded
``torch.Generator``, inverts the flows and vocodes with WaveGlow. On a
CUDA device the flows run kernel K1 (a quantized flow runs the per-frame
loop, with kernel K4 for ``w8a8``) and the vocoder's WN layers kernel K2.
``run_inference`` runs on ``cuda:0`` unless asked for the CPU
(``utils/device.py``).
"""

import os
import wave

import numpy as np
import torch

from flowtron_tpu_torch.data.frontend import TextFrontend
from flowtron_tpu_torch.infer.quantize import quantize_flows_for_inference
from flowtron_tpu_torch.models.flowtron import flowtron_init, flowtron_infer
from flowtron_tpu_torch.utils.device import resolve_device
from flowtron_tpu_torch.vocoder.waveglow import load_waveglow, waveglow_infer


def load_model_for_inference(config, checkpoint_path, device="cpu"):
    """Build the configured model and load a reference-format state_dict
    (``.pt``/``.pth``: a bare state_dict, or one under ``state_dict`` or
    ``model``) with ``strict=True``. Only tensors are unpickled."""
    if not checkpoint_path.endswith((".pt", ".pth")):
        raise NotImplementedError(
            "loading the JAX package's pickle checkpoints is not ported yet "
            "(see ROADMAP.md Queue 1, 'JAX pickle checkpoint loading'); "
            "pass a reference-format .pt state_dict")
    model, static_cfg = flowtron_init(0, **config["model_config"])
    ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    model.load_state_dict(sd, strict=True)
    return model.to(device), static_cfg


def synthesize(model, static_cfg, text_ids, speaker_id, n_frames=400,
               sigma=0.5, gate_threshold=0.5, seed=1234, fused=False):
    """text ids -> (mel (n_mel, n_valid), attns [(n_valid, Tk)], n_valid),
    tensors on the model's device."""
    device = next(model.parameters()).device
    g = torch.Generator().manual_seed(seed)
    residual = (torch.randn(1, static_cfg["n_mel_channels"], n_frames,
                            generator=g) * sigma).to(device)
    text = torch.as_tensor(np.asarray(text_ids)[None], device=device)
    sid = torch.tensor([speaker_id], device=device)
    mel, attns, n_valid = flowtron_infer(
        model, static_cfg, residual, sid, text,
        gate_threshold=gate_threshold, fused=fused)
    n = int(n_valid[0])
    return mel[0, :, :n], [a[0, :n] for a in attns], n


def text_to_audio(model, static_cfg, wg_model, wg_cfg, text_ids, speaker_id,
                  n_frames=400, sigma=0.5, gate_threshold=0.5, seed=1234,
                  fused=False, wg_sigma=0.8):
    """text ids -> (audio (n_valid * 256,) float32 numpy, mel, n_valid)."""
    mel, _, n = synthesize(model, static_cfg, text_ids, speaker_id, n_frames,
                           sigma, gate_threshold, seed, fused)
    audio = waveglow_infer(wg_model, wg_cfg, mel[None], sigma=wg_sigma,
                           seed=seed)
    return audio[0].cpu().numpy(), mel, n


def write_wav(path, audio, sampling_rate):
    """Peak-normalised 16-bit mono PCM."""
    audio = audio / max(1e-8, float(np.abs(audio).max()))
    pcm = (np.clip(audio, -1, 1) * 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sampling_rate)
        w.writeframes(pcm.tobytes())


def run_inference(config, args, device=None):
    """CLI entry (reference:inference.py:93-132 contract, with ``-w``).
    ``args.quantize`` ("w8", "w8a8", "w4") or ``args.int8`` (w8) quantize
    the flows first, as flowtron_tpu/infer/sampling.py:128-132 does."""
    if not args.waveglow_path:
        raise NotImplementedError(
            "Griffin-Lim is not ported yet (see ROADMAP.md Queue 1, "
            "'Griffin-Lim / STFT'); pass a WaveGlow state_dict with -w")
    if getattr(args, "denoise", 0.0) > 0:
        raise NotImplementedError(
            "the denoiser is not ported yet (see ROADMAP.md Queue 1, "
            "slice C item 21)")
    device = resolve_device(device)
    data_config = config["data_config"]
    model, static_cfg = load_model_for_inference(config, args.flowtron_path,
                                                 device)
    qmode = getattr(args, "quantize", "") or (
        "w8" if getattr(args, "int8", False) else "")
    if qmode:
        model = quantize_flows_for_inference(model, mode=qmode)
    wg_model, wg_cfg = load_waveglow(args.waveglow_path, device)
    frontend = TextFrontend.from_config(data_config)
    text_ids = frontend.get_text(args.text)
    speaker_id = int(frontend.get_speaker_id(args.id))
    audio, _, n_valid = text_to_audio(
        model, static_cfg, wg_model, wg_cfg, text_ids, speaker_id,
        n_frames=args.n_frames, sigma=args.sigma, gate_threshold=args.gate,
        seed=args.seed, fused="early" if args.fused else False)
    hop, sr = data_config["hop_length"], data_config["sampling_rate"]
    print(f"synthesized {n_valid} mel frames ({n_valid * hop / sr:.2f}s)")
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.join(args.output_dir,
                        f"sid{args.id}_sigma{args.sigma}_seed{args.seed}")
    write_wav(base + ".wav", audio, sr)
    print("wrote", base + ".wav")
    return base
