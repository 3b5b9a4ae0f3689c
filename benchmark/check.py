"""What decides ``correct``: a sample of the answers the window served,
held against the plain reference on the same weights, texts, speakers and
seeds.

The reference (``benchmark/reference``) derives the text ids and the
latents again, makes the weights again from the run's seed (rounded to
the served dtype, as the server holds them) and computes in fp32 with
TF32 off, in blocks of rows. The numbers compared, each the worst over
the sample:

- ``mel_rel_rms``: the mel that the timed chain's ``_synth_mel``
  produced for the request (the encoder and the flows through K1), copied
  on the card as it was produced (``MelTap``), over its valid frames:
  ||served - reference|| / ||reference||;
- ``pcm_rel_rms``: the int16 PCM answer against the reference's, after
  matching the two waveforms' gains (the answer is divided by its own
  peak, so a rounding of its peak sample rescales it whole; that scale is
  left out here, and recorded beside);
- ``pcm_rms_lsb``: the same gain-matched difference as an rms in int16
  steps: where the program computes in fp32, the difference is the int16
  rounding flipped by fp32's last bits, under a step whatever the
  answer's loudness, while ``pcm_rel_rms`` divides it by the answer's
  own rms, and so reads high on a quiet answer;
- ``pcm_peak_gap``: how far the answer's peak magnitude lies from the
  reference's, over the reference's: each answer is normalised to its own
  peak, which so reads 32767 on both sides, exactly, at any precision
  (the gain that ``pcm_rel_rms`` leaves out is held here);
- ``length_mismatch``: answers whose length differs from the reference's
  (the gate's end), or that never came.
"""

import numpy as np
import torch

from benchmark import weights
from benchmark.reference import flowtron as ref_flowtron
from benchmark.reference import waveglow as ref_waveglow
from benchmark.reference.frontend import TextIds, speaker_table
from benchmark.reference.latents import mel_latents, vocoder_latents
from benchmark.reference.layout import n_remaining

BLOCK = 8            # rows the reference runs at once


class MelTap:
    """Wraps a serving engine's ``_synth_mel`` to keep, on the card, the
    mel rows of the requests whose latent seeds are in ``seeds`` (a copy
    launched behind the chain; nothing waits for it)."""

    def __init__(self, engine, seeds):
        self.seeds = set(int(s) for s in seeds)
        self.mels = {}
        original = engine._synth_mel

        def tapped(seeds_b, sigmas, sids, text, in_lens, temperature,
                   frames_cap, rep=None):
            mel, n_valid = original(seeds_b, sigmas, sids, text, in_lens,
                                    temperature, frames_cap, rep)
            for b, s in enumerate(seeds_b):
                s = int(s)
                if s in self.seeds and s not in self.mels:
                    self.mels[s] = mel[b].float().clone()
            return mel, n_valid

        engine._synth_mel = tapped

    def host(self, seed):
        m = self.mels.get(int(seed))
        return None if m is None else m.cpu()


def reference_weights(config, seed, device):
    """The run's weights as the server holds them: made from the seed,
    rounded to the served dtype, computed in fp32."""
    dt = getattr(torch, config["serve"]["dtype"])
    return tuple({k: v.to(dt).float() for k, v in sd.items()}
                 for sd in weights.model_weights(config, seed, device))


def reference_answers(config, bodies, seed, n_frames, device, tf32=False,
                      fp8=False, one_peak=False):
    """[(mel (n_mel, n_frames) on the host, int16 PCM numpy)] of each
    request body, as the reference computes it. The controls: ``tf32``
    runs every product in TF32; ``fp8`` rounds both operands of every
    product and convolution to fp8 (e4m3). The fault ``one_peak``
    normalises a block's rows by the block's one peak."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            return _answers(config, bodies, seed, n_frames, device, fp8,
                            one_peak)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _one_peak_pcm16(audio, n_valid, hop=256):
    """``pcm16`` with one peak over the whole block (the fault)."""
    valid = torch.arange(audio.shape[1], device=audio.device)[None, :] \
        < (n_valid * hop)[:, None]
    out = audio / (audio.abs() * valid).amax().clamp(min=1e-8) * valid
    return torch.clamp(out * 32767.0, -32767, 32767).to(torch.int16)


def _answers(config, bodies, seed, n_frames, device, fp8, one_peak):
    mc, wc, dc = (config["model_config"], config["waveglow_config"],
                  config["data_config"])
    sd_ft, sd_wg = reference_weights(config, seed, device)
    rounding = ref_waveglow.fp8 if fp8 else None
    frontend = TextIds(dc)
    speakers = speaker_table(dc["training_files"])
    n_rem, M = n_remaining(wc), mc["n_mel_channels"]
    out = []
    for b0 in range(0, len(bodies), BLOCK):
        block = bodies[b0:b0 + BLOCK]
        texts = [ref_flowtron.encode(
            sd_ft, torch.as_tensor(frontend.ids(b["text"]), device=device),
            speakers.get(int(b.get("speaker_id", 0)), 0), rounding)
            for b in block]
        residual = torch.cat([mel_latents(b["seed"], b.get("sigma", 0.5), M,
                                          n_frames) for b in block])
        mel, n_valid = ref_flowtron.infer(sd_ft, mc, texts,
                                          residual.to(device),
                                          rounding=rounding)
        zs = [vocoder_latents(b["seed"], wc, n_rem, n_frames)
              for b in block]
        mels = [mel[r].cpu() for r in range(len(block))]
        z_main = torch.cat([z for z, _ in zs]).to(device)
        z_early = {f: torch.cat([e[f] for _, e in zs]).to(device)
                   for f in zs[0][1]}
        audio = ref_waveglow.infer(sd_wg, wc, mel, z_main, z_early,
                                   rounding=rounding)
        pcm16 = _one_peak_pcm16 if one_peak else ref_waveglow.pcm16
        pcm = pcm16(audio, n_valid).cpu().numpy()
        out += [(mels[r], pcm[r, :int(n_valid[r]) * 256])
                for r in range(len(block))]
    return out


def compare(served, reference, mels):
    """The numbers compared (see the module's docstring) over the sample:
    ``served`` the answers' int16 PCM (None for one that never came),
    ``reference`` ``reference_answers``' pairs, ``mels`` the tapped mels
    (None for one not tapped). Returns (readings, record): the record
    keeps each answer's errors, and the PCM's error with its gain, for
    the run's log."""
    pcm, lsb, level, gain_in, peak_gap, mel_err = [], [], [], [], [], []
    mismatched = 0
    for got, m, (want_mel, want) in zip(served, mels, reference):
        if got is None or m is None or len(got) != len(want):
            mismatched += 1
            continue
        g, w = got.astype(np.float64), want.astype(np.float64)
        nw = max(np.linalg.norm(w), 1.0)
        gain_in.append(float(np.linalg.norm(g - w) / nw))
        a = float(g @ w / max(g @ g, 1.0))
        pcm.append(float(np.linalg.norm(a * g - w) / nw))
        lsb.append(float(np.linalg.norm(a * g - w) / np.sqrt(len(w))))
        level.append(float(nw / np.sqrt(len(w))))
        pw = max(float(np.abs(w).max()), 1.0)
        peak_gap.append(abs(float(np.abs(g).max()) - pw) / pw)
        n = len(want) // 256
        d = (m[:, :n].double() - want_mel[:, :n].double()).norm()
        mel_err.append(float(d / want_mel[:, :n].double().norm()))
    readings = {"mel_rel_rms": max(mel_err, default=0.0),
                "pcm_rel_rms": max(pcm, default=0.0),
                "pcm_rms_lsb": max(lsb, default=0.0),
                "pcm_peak_gap": max(peak_gap, default=0.0),
                "length_mismatch": mismatched}
    record = {"mel_rel_rms_each": mel_err, "pcm_rel_rms_each": pcm,
              "pcm_rms_lsb_each": lsb, "pcm_level_lsb_each": level,
              "pcm_with_gain_each": gain_in, "pcm_peak_gap_each": peak_gap}
    return readings, record


def judge(readings, limits):
    """{name: {"value", "limit"}} and whether every reading is within its
    limit."""
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    return checks, all(v["value"] <= v["limit"] for v in checks.values())
