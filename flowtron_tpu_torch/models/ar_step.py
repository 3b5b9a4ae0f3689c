"""Autoregressive affine flow steps (port of ``ar_step_forward``,
``ar_back_step_forward``, ``ar_step_infer`` and ``ar_back_step_infer`` in
flowtron_tpu/models/ar_step.py).

Training is teacher-forced over the whole sequence: ``mel' = exp(log_s) *
mel + b``, where (log_s, b) come from the shifted mel through the attention
LSTM, text attention (scores through kernel K3), decoder LSTMs, tanh dense
stack and the zero-init coupling head (reference:flowtron.py:645-773).
Inference inverts a flow frame by frame: ``out_t = (z_t - b_t) *
exp(-log_s_t)`` (reference:flowtron.py:775-828).

Routing, as the JAX package's (flowtron_tpu/models/ar_step.py:219-227
with ops/decoder_pallas.py:358-371), through one predicate,
``in_k1_subset``: a flow with a scalar temperature, no attention prior, no
external attention map and no quantized weight runs kernel K1
(``ops/decoder.py``) on CUDA tensors, ``fused="early"`` switching its
early exit on; on CPU tensors a truthy
``fused`` runs K1's plain version and ``fused=False`` the loop below. Any
other flow runs the per-frame loop ``_scan_infer`` on either device: it is
the counterpart of JAX's ``lax.scan`` (its body,
flowtron_tpu/models/ar_step.py:262-314), with every dot through
``utils/weights.py:qdot`` (so kernel K4 on an ``a8`` quantized flow). A
flow whose weights a serving mesh sharded (``utils/weights.py:
ShardedWeight``) runs the loop too: each dot multiplies the slices on
their devices and concatenates on the first, so the loop needs no other
change; the leaves it does not touch (the encoder, the embedding, the
speaker table) stay whole on that device.

An external attention map (style transfer, ``attn``: (B, N, Tk)) runs
the loop, frame t taking ``attn[:, t]`` in place of the attention step, as
JAX's scan cell does; the cumulative and previous attention still take it.

A chunked (streaming) call, with ``carry`` or ``return_carry``, always
runs the loop: K1 starts from zero state and returns none, and the JAX
package does not fuse that path either (its ar_step.py:221).

Cumulative attention (a flow with ``attn_cond_layer``): each frame a conv
over the (cumulative, previous) attention gates the text keys, which are
projected anew (reference:flowtron.py:697-723). Training runs it as a
per-frame pass in plain PyTorch, without the prior and without K3, as
the JAX package runs its ``attention_step`` in XLA; inference runs the
loop, never K1. The loop's state always has JAX's seven entries, (h_att,
c_att, hs, cs, previous frame, cumulative attention, previous attention),
whether or not the flow uses the last two.

``remat`` rematerializes a flow's teacher-forced pass in the backward
(``torch.utils.checkpoint``, non-reentrant), as the JAX package's
``remat_scans`` does for the flows' LSTM scans.
"""

import torch
import torch.utils.checkpoint
from torch import nn

from flowtron_tpu_torch.models.attention import (
    Attention, AttentionConditioning, attention_conditioning_apply,
    attention_forward, attention_precompute, attention_step,
    attention_step_external,
)
from flowtron_tpu_torch.models.layers import DenseLayer, LinearNorm, linear
from flowtron_tpu_torch.ops.decoder import pack_flow_weights, fused_flow_infer
from flowtron_tpu_torch.ops.lstm import LSTM, lstm_cell, lstm_forward
from flowtron_tpu_torch.utils.masks import flip_time, flip_time_batch_major
from flowtron_tpu_torch.utils.weights import is_quantized, qdot


class ARStep(nn.Module):
    """State names follow the reference's AR_Step (``conv``, ``lstm``,
    ``attention_lstm``, ``attention_layer``, ``dense_layer``,
    ``gate_layer``)."""

    def __init__(self, n_mel_channels=80, n_speaker_dim=128,
                 n_text_channels=512, n_hidden=1024, n_attn_channels=640,
                 n_lstm_layers=2, add_gate=False, use_cumm_attention=False,
                 generator=None):
        super().__init__()
        # zero-init coupling head: every flow starts as the identity
        # (reference:flowtron.py:651-653); a 1x1 conv, weight (2M, H, 1)
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(
            torch.zeros(2 * n_mel_channels, n_hidden, 1))
        self.conv.bias = nn.Parameter(torch.zeros(2 * n_mel_channels))
        self.lstm = LSTM(n_hidden + n_attn_channels, n_hidden,
                         num_layers=n_lstm_layers, generator=generator)
        self.attention_lstm = LSTM(n_mel_channels, n_hidden, num_layers=1,
                                   generator=generator)
        self.attention_layer = Attention(n_hidden, n_speaker_dim,
                                         n_text_channels, n_attn_channels,
                                         generator=generator)
        self.dense_layer = DenseLayer(n_hidden, (n_hidden, n_hidden),
                                      generator=generator)
        if add_gate:
            self.gate_layer = LinearNorm(n_hidden + n_attn_channels, 1,
                                         bias=True, w_init_gain="sigmoid",
                                         generator=generator)
        if use_cumm_attention:
            self.attn_cond_layer = AttentionConditioning(
                input_dim=2, attention_dim=n_text_channels + n_speaker_dim,
                generator=generator)
        self._packed = None

    def forward(self, mel, text, key_mask, out_mask, attn_prior=None):
        """The teacher-forced pass (``ar_step_forward`` without remat)."""
        return _ar_step_pass(self, mel, text, key_mask, out_mask, attn_prior)

    def _apply(self, fn, *args, **kwargs):
        self._packed = None        # moved or cast: pack anew
        return super()._apply(fn, *args, **kwargs)

    def packed_weights(self):
        """K1's packed weights in the flow's dtype (fp32, or bf16 for the
        bf16 body), cached on the module and rebuilt when any parameter is
        replaced, cast or modified in place."""
        key = tuple((p.data_ptr(), p._version, p.dtype)
                    for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_flow_weights(self))
        return self._packed[1]


class ARBackStep(nn.Module):
    """The reference's AR_Back_Step: an ARStep run over time-reversed
    input (state names ``ar_step.*``)."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        self.ar_step = ARStep(*args, **kwargs)


def _cumm_keys(flow, text_b, attn_cumm, attn_prev):
    """A cumulative-attention flow's keys for one frame: the conditioning
    layer over (cumulative, previous) attention (B, Tk) gates the text
    ``text_b`` (B, Tk, Din) before the key projection. After the frame's
    attention ``attn_w`` both callers update the state the same way:
    ``attn_cumm, attn_prev = attn_cumm + attn_w, attn_w``."""
    cond = attention_conditioning_apply(
        flow.attn_cond_layer, torch.stack([attn_cumm, attn_prev], 1))
    return flow.attention_layer.key(text_b * cond.transpose(1, 2))


def _cumm_attention_pass(flow, attention_hidden, text, key_mask):
    """The teacher-forced cumulative-attention pass, frame by frame (JAX
    ``_cumm_attention_scan``): the conditioning layer gates the text
    before each frame's key projection. No prior, as in the JAX package
    and the reference. Returns context (T, B, D), attn (B, T, Tk) and
    attn_logprob (B, T, Tk) fp32."""
    Tk, B, _ = text.shape
    text_b = text.transpose(0, 1)                              # (B, Tk, Din)
    vals = flow.attention_layer.value(text_b)                  # (B, Tk, D)
    attn_cumm = attn_prev = text.new_zeros(B, Tk)
    contexts, attns = [], []
    for q_t in attention_hidden:
        k_proj = _cumm_keys(flow, text_b, attn_cumm, attn_prev)
        context, attn_w = attention_step(flow.attention_layer, q_t, k_proj,
                                         vals, key_mask=key_mask)
        attn_cumm, attn_prev = attn_cumm + attn_w, attn_w
        contexts.append(context)
        attns.append(attn_w)
    attns = torch.stack(attns, dim=1)
    return torch.stack(contexts), attns, torch.log(attns.float() + 1e-8)


def ar_step_forward(flow, mel, text, key_mask, out_mask, attn_prior=None,
                    remat=False):
    """Teacher-forced forward flow.

    Args:
      flow: an ``ARStep``.
      mel: (T, B, n_mel) time-major mel (this flow's input).
      text: (Tk, B, text + speaker) encoder outputs.
      key_mask: (B, Tk) bool. out_mask: (T, B) bool, valid mel frames.
      attn_prior: (B, T, Tk) or None (a cumulative-attention flow ignores
        it, as the JAX package does).
      remat: keep only the pass's inputs for the backward and run the
        pass again there. The recompute runs on the tensors the pass
        used (``torch.func.functional_call``), so it also holds under the
        bf16 policy's cast copies of the parameters.

    Returns (mel_out (T, B, n_mel), log_s (T, B, n_mel), gates (T, B, 1)
    or None, attn (B, T, Tk), attn_logprob (B, T, Tk) fp32).
    """
    if remat:
        state = dict(flow.named_parameters())
        state.update(flow.named_buffers())
        return torch.utils.checkpoint.checkpoint(
            torch.func.functional_call, flow, state,
            (mel, text, key_mask, out_mask, attn_prior), use_reentrant=False)
    return flow(mel, text, key_mask, out_mask, attn_prior)


def _ar_step_pass(flow, mel, text, key_mask, out_mask, attn_prior):
    n_mel = mel.shape[2]
    mel0 = torch.cat([mel.new_zeros((1,) + mel.shape[1:]), mel[:-1]], dim=0)
    attention_hidden, _ = lstm_forward(flow.attention_lstm, mel0, out_mask)
    if hasattr(flow, "attn_cond_layer"):
        context, attn, attn_logprob = _cumm_attention_pass(
            flow, attention_hidden, text, key_mask)
    else:
        context, attn, attn_logprob = attention_forward(
            flow.attention_layer, attention_hidden, text, text,
            key_mask=key_mask, attn_prior=attn_prior)
        context = context.permute(2, 0, 1)
    decoder_input = torch.cat([attention_hidden, context], dim=-1)
    gates = flow.gate_layer(decoder_input) if hasattr(flow, "gate_layer") \
        else None
    lstm_hidden, _ = lstm_forward(flow.lstm, decoder_input, out_mask)
    decoder_output = linear(flow.dense_layer(lstm_hidden),
                            flow.conv.weight[:, :, 0], flow.conv.bias)
    log_s = decoder_output[:, :, :n_mel]
    b = decoder_output[:, :, n_mel:]
    return torch.exp(log_s) * mel + b, log_s, gates, attn, attn_logprob


def ar_back_step_forward(flow, mel, text, key_mask, out_mask, out_lens,
                         attn_prior=None, remat=False):
    """Backward flow: ``ar_step_forward`` on mel (and prior) flipped within
    ``out_lens``; mel comes back un-flipped, log_s / gates / attn stay in
    flipped order (reference:flowtron.py:605-627). ``flow`` is an
    ``ARBackStep``."""
    mel_f = flip_time(mel, out_lens)
    prior_f = None if attn_prior is None else \
        flip_time_batch_major(attn_prior, out_lens)
    mel_out, log_s, gates, attn, attn_logprob = ar_step_forward(
        flow.ar_step, mel_f, text, key_mask, out_mask, prior_f, remat)
    return flip_time(mel_out, out_lens), log_s, gates, attn, attn_logprob


def _n_valid_from_gates(gates, gate_threshold, n_valid):
    """First frame whose gate fires ends the utterance, inclusive
    (flowtron_tpu/models/ar_step.py:335-346)."""
    N, B = gates.shape
    hit = gates > gate_threshold
    first = hit.to(torch.int64).argmax(dim=0)
    nv = torch.where(hit.any(dim=0), first + 1, N)
    return nv if n_valid is None else torch.minimum(n_valid.to(nv.dtype), nv)


def in_k1_subset(flow, attn_prior, temperature, attn=None):
    """Whether kernel K1 can run this flow: a scalar temperature, no
    attention prior, no external attention map, no quantized weight and no
    cumulative attention, as the JAX package's fused condition
    (flowtron_tpu/models/ar_step.py:219-223), and not placed on a serving
    mesh (``utils/weights.py:shard_flows`` marks it ``on_mesh``): the JAX
    engine turns ``fused`` off under a mesh, flowtron_tpu/serve/
    engine.py:63-70, so K1 never sees a sharded weight."""
    scalar_temp = not torch.is_tensor(temperature) or temperature.numel() == 1
    return scalar_temp and attn_prior is None and attn is None \
        and not is_quantized(flow) and not getattr(flow, "on_mesh", False) \
        and not hasattr(flow, "attn_cond_layer")


def _scan_infer(flow, residual, text, key_mask, attn_prior, temperature,
                carry=None, attn=None):
    """The per-frame loop: the JAX scan body written out, every dot
    through ``qdot``. ``carry`` is the state (h_att, c_att, hs, cs, prev
    frame, cumulative attention, previous attention) to start from, None
    for zeros. ``attn`` (B, N, Tk): an external map, frame t's attention
    in place of the attention step. Returns (mel (N, B, n_mel), attn
    (B, N, Tk), gates (N, B), the final state)."""
    N, B, n_mel = residual.shape
    Tk = text.shape[0]
    k_proj, vals = attention_precompute(flow.attention_layer, text, text)
    cumm = hasattr(flow, "attn_cond_layer")
    text_b = text.transpose(0, 1) if cumm else None
    att_w_ih, att_w_hh, att_b_ih, att_b_hh = \
        flow.attention_lstm.layer_weights(0)
    layers = [flow.lstm.layer_weights(k) for k in range(flow.lstm.num_layers)]
    if carry is None:
        H = att_w_hh.shape[1]         # (4H, H), float or quantized
        h_att = c_att = residual.new_zeros(B, H)
        hs = [residual.new_zeros(B, H) for _ in layers]
        cs = [residual.new_zeros(B, H) for _ in layers]
        prev = residual.new_zeros(B, n_mel)
        attn_cumm = attn_prev = residual.new_zeros(B, Tk)
    else:
        h_att, c_att, hs, cs, prev, attn_cumm, attn_prev = carry
        hs, cs = list(hs), list(cs)
    mels, attns, gates = [], [], []
    for t in range(N):
        h_att, c_att = lstm_cell(qdot(prev, att_w_ih) + att_b_ih + att_b_hh,
                                 h_att, c_att, att_w_hh)
        prior_t = None if attn_prior is None else attn_prior[:, t]
        if cumm:
            k_proj = _cumm_keys(flow, text_b, attn_cumm, attn_prev)
        if attn is not None:
            context, attn_w = attention_step_external(attn[:, t], vals)
        else:
            context, attn_w = attention_step(
                flow.attention_layer, h_att, k_proj, vals, key_mask=key_mask,
                prior_t=prior_t, temperature=temperature)
        attn_cumm, attn_prev = attn_cumm + attn_w, attn_w
        x = torch.cat([h_att, context], dim=-1)
        gate = torch.sigmoid(flow.gate_layer(x))[:, 0] \
            if hasattr(flow, "gate_layer") else residual.new_zeros(B)
        for k, (w_ih, w_hh, b_ih, b_hh) in enumerate(layers):
            hs[k], cs[k] = lstm_cell(qdot(x, w_ih) + b_ih + b_hh, hs[k],
                                     cs[k], w_hh)
            x = hs[k]
        out2 = linear(flow.dense_layer(x), flow.conv.weight[:, :, 0],
                      flow.conv.bias)
        prev = (residual[t] - out2[:, n_mel:]) * torch.exp(-out2[:, :n_mel])
        mels.append(prev)
        attns.append(attn_w)
        gates.append(gate)
    return (torch.stack(mels), torch.stack(attns, dim=1), torch.stack(gates),
            (h_att, c_att, tuple(hs), tuple(cs), prev, attn_cumm, attn_prev))


def ar_step_infer(flow, residual, text, key_mask=None, attn_prior=None,
                  temperature=1.0, gate_threshold=0.5, n_valid=None,
                  fused=False, carry=None, return_carry=False, attn=None):
    """Invert one flow over sampled latents.

    Args:
      flow: an ``ARStep``.
      residual: (N, B, n_mel) latents (or the previous flow's output).
      text: (Tk, B, text+speaker) encoder outputs.
      key_mask: (B, Tk) bool or None. attn_prior: (B, N, Tk) or None.
      temperature: scalar, or (B, 1) per stream (runs the loop).
      n_valid: (B,) frames valid in ``residual``; None means all N.
      fused: on CPU, truthy runs K1's plain version instead of the loop
        for a flow in K1's subset; ``"early"`` turns on early exit (see
        ops/decoder.py).
      attn: an external attention map (B, N, Tk) or None; a map runs the
        loop (never K1), as in the JAX package.
      carry / return_carry: chunked (streaming) synthesis, on the loop.
        ``carry`` is the state a previous call returned with
        ``return_carry=True`` (None: a fresh start); with
        ``return_carry=True`` the call returns (mel, attn, gates (N, B),
        carry) and leaves the gate's end of the utterance to the caller
        (infer/streaming.py).

    Returns (mel (N, B, n_mel), attn (B, N, Tk), n_valid (B,)).
    """
    N, B, _ = residual.shape
    if carry is None and not return_carry \
            and in_k1_subset(flow, attn_prior, temperature, attn) \
            and (residual.device.type == "cuda" or fused):
        k_proj, vals = attention_precompute(flow.attention_layer, text, text)
        km = torch.ones(B, text.shape[0], device=residual.device) \
            if key_mask is None else key_mask.to(torch.float32)
        mel, attn, gates = fused_flow_infer(
            flow.packed_weights(), residual.contiguous(), k_proj, vals,
            km.contiguous(), float(temperature),
            early_exit=(fused == "early"), gate_threshold=gate_threshold,
            n_valid_in=n_valid)
        # K1 writes fp32; the flow's outputs keep the residual's dtype, as
        # JAX's fused branch casts them
        mel = mel.to(residual.dtype)
        attn = attn.transpose(0, 1).to(residual.dtype)
    else:
        mel, attn, gates, carry = _scan_infer(
            flow, residual, text, key_mask, attn_prior, temperature, carry,
            attn)
        if return_carry:
            return mel, attn, gates, carry
    if hasattr(flow, "gate_layer"):
        n_valid = _n_valid_from_gates(gates, gate_threshold, n_valid)
    elif n_valid is None:
        n_valid = torch.full((B,), N, dtype=torch.int64,
                             device=residual.device)
    return mel, attn, n_valid


def ar_back_step_infer(flow, residual, text, key_mask=None, attn_prior=None,
                       temperature=1.0, gate_threshold=0.5, n_valid=None,
                       fused=False, attn=None):
    """Backward flow: flip within n_valid, invert, flip back
    (reference:flowtron.py:629-642). ``flow`` is an ``ARBackStep``. As in
    the JAX package, an external map ``attn`` is not flipped (frame t of
    the flipped residual takes ``attn[:, t]``), and the attention that
    comes back stays in the flipped order."""
    N, B, _ = residual.shape
    if n_valid is None:
        n_valid = torch.full((B,), N, dtype=torch.int64,
                             device=residual.device)
    residual_f = flip_time(residual, n_valid)
    prior_f = None if attn_prior is None else \
        flip_time_batch_major(attn_prior, n_valid)
    mel, attn_w, n_valid_out = ar_step_infer(
        flow.ar_step, residual_f, text, key_mask, prior_f, temperature,
        gate_threshold, n_valid=n_valid, fused=fused, attn=attn)
    return flip_time(mel, n_valid_out), attn_w, n_valid_out
