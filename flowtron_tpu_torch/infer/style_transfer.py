"""Style transfer by a Gaussian posterior over reference utterances (port
of ``collect_z``, ``posterior_mean`` and ``style_transfer`` in
flowtron_tpu/infer/style_transfer.py).

The reference notebook's procedure (inference_style_transfer.ipynb cells
10-18; arXiv:2005.05957): push the reference mels forward through the
flows to get z, tile each utterance's valid z frames to the target
length, average, and form the ridge posterior mean ``mu = (n/lam) * z_bar
/ (n/lam + 1)`` (prior N(0, I), lam = 1e-4). Sampling N(mu, sigma) and
inverting the flows carries the references' style onto new text. On the
card the forward reaches kernel K3's forward and the inversion kernel K1.
"""

import numpy as np
import torch

from flowtron_tpu_torch.models.flowtron import (
    flowtron_forward, flowtron_infer,
)


@torch.no_grad()
def collect_z(model, config, mel, speaker_ids, text, in_lens, out_lens,
              attn_prior=None):
    """Forward one padded batch of utterances (``train=False``); returns z
    (T, B, n_mel)."""
    return flowtron_forward(model, config, mel, speaker_ids, text, in_lens,
                            out_lens, attn_prior=attn_prior)[0]


def posterior_mean(z_list, out_lens_list, n_frames, lam=1e-4):
    """z_list: per-utterance (T_i, n_mel) valid-frame latents (numpy).

    Tiles each to ``n_frames``, averages over the utterances and applies
    the ridge posterior, in numpy on the host. Returns (n_mel, n_frames)
    float32.
    """
    tiled = []
    for z in z_list:
        z = np.asarray(z)
        reps = int(np.ceil(n_frames / z.shape[0]))
        tiled.append(np.tile(z, (reps, 1))[:n_frames])
    z_bar = np.mean(tiled, axis=0).T
    ratio = len(z_list) / lam
    return (ratio * z_bar / (ratio + 1)).astype(np.float32)


def style_transfer(model, config, reference_batch, text_ids, speaker_id,
                   n_frames=400, sigma=0.5, gate_threshold=0.5, seed=1234,
                   lam=1e-4, device=None, noise=None):
    """End-to-end style transfer on ``device`` (the model's by default).

    reference_batch: the padded batch of the style references (``mel``,
    ``speaker_ids``, ``text``, ``in_lens``, ``out_lens``; numpy, as
    ``DataCollate`` gives it). text_ids: the target text. noise: a
    standard-normal (1, n_mel, n_frames) draw to use instead of one from
    ``torch.Generator(device).manual_seed(seed)`` (torch's generator
    cannot reproduce ``jax.random``'s, so a comparison with the JAX
    package passes JAX's draw in here). Returns (mel (n_mel, n) numpy, n).
    """
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)

    def put(key):
        return torch.as_tensor(np.asarray(reference_batch[key]),
                               device=device)

    z = collect_z(model, config, put("mel"), put("speaker_ids"), put("text"),
                  put("in_lens"), put("out_lens"))
    z = z.cpu().numpy()                                        # (T, B, M)
    out_lens = np.asarray(reference_batch["out_lens"])
    z_list = [z[:int(L), b] for b, L in enumerate(out_lens)]
    mu = posterior_mean(z_list, out_lens, n_frames, lam)
    if noise is None:
        g = torch.Generator(device).manual_seed(int(seed))
        noise = torch.randn(1, mu.shape[0], n_frames, generator=g,
                            device=device)
    residual = torch.as_tensor(mu, device=device)[None] + sigma \
        * torch.as_tensor(noise, dtype=torch.float32, device=device)
    text = torch.as_tensor(np.asarray(text_ids)[None], device=device)
    sid = torch.tensor([int(speaker_id)], device=device)
    mel, _, n_valid = flowtron_infer(model, config, residual, sid, text,
                                     gate_threshold=gate_threshold)
    n = int(n_valid[0])
    return mel[0, :, :n].cpu().numpy(), n
