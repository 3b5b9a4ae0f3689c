"""Flowtron top-level model (port of ``flowtron_init``, ``_encode_text``,
``flowtron_forward``, ``flowtron_infer`` and
``flowtron_test_invertibility`` in flowtron_tpu/models/flowtron.py).

n_flows alternating forward (even index) and backward (odd index) AR
steps, the gate only on the last flow; training pushes mel through the
flows in order, inference runs them in reverse
(reference:flowtron.py:831-961). With ``n_components > 1`` a mel encoder
feeds the Gaussian-mixture head, whose (mean, log_var, prob) the
training forward returns for the mixture NLL.
"""

import torch
from torch import nn

from flowtron_tpu_torch.models.ar_step import (
    ARStep, ARBackStep, ar_step_forward, ar_back_step_forward,
    ar_step_infer, ar_back_step_infer,
)
from flowtron_tpu_torch.models.encoder import (
    Encoder, MelEncoder, encoder_forward, encoder_infer, mel_encoder_forward,
)
from flowtron_tpu_torch.models.gaussian_mixture import (
    GaussianMixture, gaussian_mixture_forward,
)
from flowtron_tpu_torch.models.layers import Embedding
from flowtron_tpu_torch.utils.masks import sequence_mask


class Flowtron(nn.Module):
    """Parameter names follow the reference's state_dict (as
    ``flowtron_tpu.train.checkpoints.export_torch_state_dict`` writes it),
    so a reference-format checkpoint loads with ``strict=True``."""

    def __init__(self, n_speakers=1, n_speaker_dim=128, n_text=185,
                 n_text_dim=512, n_flows=2, n_mel_channels=80,
                 n_hidden=1024, n_attn_channels=640, n_lstm_layers=2,
                 use_gate_layer=True, mel_encoder_n_hidden=512,
                 n_components=0, fixed_gaussian=True, mean_scale=0.0,
                 dummy_speaker_embedding=False, use_cumm_attention=False,
                 generator=None):
        super().__init__()
        self.config = {"n_flows": n_flows, "n_mel_channels": n_mel_channels,
                       "n_components": n_components,
                       "dummy_speaker_embedding": dummy_speaker_embedding,
                       "use_gate_layer": use_gate_layer}
        self.speaker_embedding = Embedding(n_speakers, n_speaker_dim,
                                           generator)
        self.embedding = Embedding(n_text, n_text_dim, generator)
        self.encoder = Encoder(encoder_embedding_dim=n_text_dim,
                               generator=generator)
        if n_components > 1:
            self.mel_encoder = MelEncoder(mel_encoder_n_hidden,
                                          n_mel_channels=n_mel_channels,
                                          generator=generator)
            self.gaussian_mixture = GaussianMixture(
                mel_encoder_n_hidden, n_components, n_mel_channels,
                fixed_gaussian, mean_scale, generator=generator)
        self.flows = nn.ModuleList()
        for i in range(n_flows):
            step = ARStep if i % 2 == 0 else ARBackStep
            self.flows.append(step(
                n_mel_channels, n_speaker_dim, n_text_dim, n_hidden,
                n_attn_channels, n_lstm_layers,
                add_gate=(i == n_flows - 1) and use_gate_layer,
                use_cumm_attention=use_cumm_attention, generator=generator))

    def forward(self, *args, **kwargs):
        """``flowtron_forward``'s body on this module's (possibly swapped,
        see ``torch.func.functional_call``) parameters."""
        return _forward(self, *args, **kwargs)


def flowtron_init(seed=0, device="cpu", **model_config):
    """Build a seeded ``Flowtron`` and its static config dict.

    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    and then moved to ``device``, so a seed gives the same weights on
    every device. The coupling heads start at zero, as in the reference.
    """
    generator = torch.Generator().manual_seed(seed)
    model = Flowtron(generator=generator, **model_config).to(device)
    model.eval()
    return model, model.config


def _encode_text(model, config, speaker_ids, text, in_lens_mask=None,
                 train=False, generator=None):
    """Embed + encode + speaker concat. Returns (Tk, B, text + speaker)."""
    if config["dummy_speaker_embedding"]:
        speaker_ids = speaker_ids * 0
    speaker_vecs = model.speaker_embedding(speaker_ids)        # (B, S)
    text_emb = model.embedding(text).transpose(1, 2)           # (B, C, Tk)
    if in_lens_mask is not None:
        enc = encoder_forward(model.encoder, text_emb, in_lens_mask, train,
                              generator)
    else:
        enc = encoder_infer(model.encoder, text_emb)
    Tk = enc.shape[0]
    spk = speaker_vecs[None].expand(Tk, -1, -1)
    return torch.cat([enc, spk], dim=2)


def flowtron_forward(model, config, mel, speaker_ids, text, in_lens,
                     out_lens, attn_prior=None, train=False, generator=None,
                     compute_dtype=None, remat=False):
    """Training-direction pass: mel -> z.

    Args:
      mel: (B, n_mel, T); speaker_ids: (B,); text: (B, Tk) int ids.
      in_lens / out_lens: (B,) true lengths. attn_prior: (B, T, Tk) or None.
      train / generator: dropout of the text encoder, then of the mel
        encoder, drawn from ``generator`` (on the model's device) when
        ``train``.
      compute_dtype: e.g. torch.bfloat16, the ``fp16_run`` policy of the
        JAX package: the forward runs on cast copies of the fp32 master
        parameters (``torch.func.functional_call``, so gradients reach the
        fp32 parameters), with mel and prior cast too. As in the JAX
        package, the attention posterior stays fp32, so the context it
        gives promotes everything after it (decoder LSTMs, dense stack,
        head, z and the next flow) to fp32 on bf16-rounded weights; the
        losses are fp32. The fixed-gaussian buffers are cast too, as the
        JAX package casts every floating leaf.
      remat: rematerialize each flow's teacher-forced pass in the
        backward (``ar_step_forward``); the encoders are not, as in the
        JAX package (a recompute would draw other dropout masks).

    Returns (z (T, B, n_mel), log_s list, gate (T, B, 1), attn list,
    attn_logprob list, mean, log_var, prob): the JAX tuple, the last
    three None without the Gaussian-mixture head.
    """
    if compute_dtype is not None:
        mel = mel.to(compute_dtype)
        if attn_prior is not None:
            attn_prior = attn_prior.to(compute_dtype)
    args = (config, mel, speaker_ids, text, in_lens, out_lens, attn_prior,
            train, generator, remat)
    if compute_dtype is None:
        return _forward(model, *args)
    cast = {name: p.to(compute_dtype) if p.is_floating_point() else p
            for name, p in (*model.named_parameters(),
                            *model.named_buffers())}
    return torch.func.functional_call(model, cast, args)


def _forward(model, config, mel, speaker_ids, text, in_lens, out_lens,
             attn_prior, train, generator, remat=False):
    T, Tk = mel.shape[2], text.shape[1]
    key_mask = sequence_mask(in_lens, Tk)                      # (B, Tk)
    out_mask = sequence_mask(out_lens, T).t()                  # (T, B)
    encoder_outputs = _encode_text(model, config, speaker_ids, text,
                                   key_mask, train, generator)
    mean = log_var = prob = None
    if config["n_components"] > 1:
        mel_embedding = mel_encoder_forward(
            model.mel_encoder, mel, out_mask.t(), train, generator)
        mean, log_var, prob = gaussian_mixture_forward(
            model.gaussian_mixture, mel_embedding, config["n_components"],
            config["n_mel_channels"])
    z = mel.permute(2, 0, 1)                                   # (T, B, M)
    log_s_list, attn_list, attn_logprob_list = [], [], []
    gate_pred = None
    for i, flow in enumerate(model.flows):
        if i % 2 == 0:
            z, log_s, gate, attn, attn_logprob = ar_step_forward(
                flow, z, encoder_outputs, key_mask, out_mask, attn_prior,
                remat)
        else:
            z, log_s, gate, attn, attn_logprob = ar_back_step_forward(
                flow, z, encoder_outputs, key_mask, out_mask, out_lens,
                attn_prior, remat)
        if gate is not None:
            gate_pred = gate
        log_s_list.append(log_s)
        attn_list.append(attn)
        attn_logprob_list.append(attn_logprob)
    return (z, log_s_list, gate_pred, attn_list, attn_logprob_list,
            mean, log_var, prob)


@torch.no_grad()
def flowtron_infer(model, config, residual, speaker_ids, text,
                   temperature=1.0, gate_threshold=0.5, attn_prior=None,
                   in_lens=None, fused=False, attns=None):
    """Invert the flows over sampled latents.

    Args:
      residual: (B, n_mel, N) sampled z (sigma applied by the caller).
      speaker_ids: (B,) ints; text: (B, Tk) ints.
      in_lens: (B,) text lengths for padded batches, or None (all valid).
      fused: see ``ar_step_infer``; on CUDA every flow runs kernel K1 and
        ``"early"`` turns its early exit on.
      attns: external attention maps (B, N, Tk), one a flow, or None. The
        flow visited ``rev_i``-th takes ``attns[len(attns) - 1 - rev_i]``
        (the reference's ``reversed(attns)``), so the list this function
        returns, reversed, feeds the same maps back. A flow with a map
        runs the loop, never K1.

    Returns (mel (B, n_mel, N), attn list of (B, N, Tk), n_valid (B,)).
    """
    Tk = text.shape[1]
    key_mask = None if in_lens is None else sequence_mask(in_lens, Tk)
    encoder_outputs = _encode_text(model, config, speaker_ids, text,
                                   key_mask)
    z = residual.permute(2, 0, 1).contiguous()                 # (N, B, M)
    n_valid = None
    n_flows = config["n_flows"]
    out_attns = []
    for rev_i, flow in enumerate(reversed(model.flows)):
        i = n_flows - 1 - rev_i
        infer = ar_step_infer if i % 2 == 0 else ar_back_step_infer
        attn_ext = None if attns is None else attns[len(attns) - 1 - rev_i]
        z, attn_w, n_valid = infer(
            flow, z, encoder_outputs, key_mask, attn_prior, temperature,
            gate_threshold, n_valid=n_valid, fused=fused, attn=attn_ext)
        out_attns.append(attn_w)
    return z.permute(1, 2, 0), out_attns, n_valid


@torch.no_grad()
def flowtron_test_invertibility(model, config, residual, speaker_ids, text,
                                temperature=1.0):
    """infer -> forward round trip, mean |z_recon - z|: the reference's own
    oracle (reference:flowtron.py:932-954, its unpacking bug fixed). On
    CUDA the inverse runs K1 and the forward K3. fp32 matmuls on the card
    need TF32 off (``torch.backends.cuda.matmul`` and ``.cudnn``) for the
    ~1e-6 the oracle expects; the caller sets that."""
    B, _, N = residual.shape
    mel, _, _ = flowtron_infer(model, config, residual, speaker_ids, text,
                               temperature=temperature, gate_threshold=1e6)
    in_lens = torch.full((B,), text.shape[1], dtype=torch.long,
                         device=text.device)
    out_lens = torch.full((B,), N, dtype=torch.long, device=text.device)
    z_recon = flowtron_forward(model, config, mel, speaker_ids, text,
                               in_lens, out_lens)[0]
    return (z_recon - residual.permute(2, 0, 1)).abs().mean()
