"""Additive (tanh) attention (port of ``attention_scores``,
``attention_forward``, ``attention_precompute`` and ``attention_step`` in
flowtron_tpu/models/attention.py, and of the external-map frame that
flowtron_tpu/models/ar_step.py computes inline, ``attention_step_external``).

score = v . tanh(q + k) / temperature, softmax over text positions,
optional beta-binomial prior posterior (reference:flowtron.py:528-592).
The teacher-forced scores go through kernel K3 (``ops/attention.py``).
``AttentionConditioning`` is the cumulative-attention layer (port of
``attention_conditioning_params`` / ``_apply``): two convs over the
(cumulative, previous) attention that gate the text keys.

The projections (``query``, ``key``, ``value``) go through
``layers.linear``, so on a serving mesh, where they are
``utils/weights.py:ShardedWeight`` slices, each multiplies its slice on
its device; ``v`` (one output) is never sharded, as in JAX's rule.
"""

import torch
from torch import nn

from flowtron_tpu_torch.models.layers import ConvNorm, LinearNorm
from flowtron_tpu_torch.ops.attention import (
    attention_scores as _k3_attention_scores,
)

MASK_VALUE = -1e30


class Attention(nn.Module):
    def __init__(self, n_query_dim=1024, n_speaker_dim=128,
                 n_text_channels=512, n_att_channels=640, generator=None):
        super().__init__()
        kd = n_text_channels + n_speaker_dim
        g = dict(bias=False, w_init_gain="tanh", generator=generator)
        self.query = LinearNorm(n_query_dim, n_att_channels, **g)
        self.key = LinearNorm(kd, n_att_channels, **g)
        self.value = LinearNorm(kd, n_att_channels, **g)
        self.v = LinearNorm(n_att_channels, 1, **g)


class AttentionConditioning(nn.Module):
    """Conv 2 -> 32 (kernel 5, ReLU), conv 32 -> attention_dim (kernel 3,
    sigmoid) over (B, 2, Tk) (reference:flowtron.py:129-152). The
    reference registers each conv twice, as an attribute and inside
    ``conv_layers``, so its state_dict holds both names. This module
    holds each conv once (a module registered twice breaks
    ``torch.func.functional_call``, which the bf16 policy and remat use:
    the shared parameter keeps the cast copy afterwards) and writes and
    reads the ``conv_layers.0`` / ``conv_layers.2`` names as aliases, so
    such a checkpoint still loads with ``strict=True``."""

    def __init__(self, input_dim=2, attention_n_filters=32,
                 attention_kernel_sizes=(5, 3), attention_dim=640,
                 generator=None):
        super().__init__()
        self.location_conv_hidden = ConvNorm(
            input_dim, attention_n_filters, attention_kernel_sizes[0],
            w_init_gain="relu", generator=generator)
        self.location_conv_out = ConvNorm(
            attention_n_filters, attention_dim, attention_kernel_sizes[1],
            w_init_gain="sigmoid", generator=generator)
        self.register_state_dict_post_hook(_write_cond_aliases)
        self.register_load_state_dict_pre_hook(_read_cond_aliases)


def _cond_alias_names(prefix):
    for ours, theirs in (("location_conv_hidden", "conv_layers.0"),
                         ("location_conv_out", "conv_layers.2")):
        for leaf in ("weight", "bias"):
            yield (f"{prefix}{ours}.conv.{leaf}",
                   f"{prefix}{theirs}.conv.{leaf}")


def _write_cond_aliases(module, state_dict, prefix, local_metadata):
    for ours, alias in _cond_alias_names(prefix):
        state_dict[alias] = state_dict[ours]


def _read_cond_aliases(module, state_dict, prefix, local_metadata, strict,
                       missing_keys, unexpected_keys, error_msgs):
    for _, alias in _cond_alias_names(prefix):
        if state_dict.pop(alias, None) is None:
            missing_keys.append(alias)


def attention_conditioning_apply(layer, attn_cat):
    """attn_cat (B, 2, Tk) -> (B, attention_dim, Tk) sigmoid gates."""
    h = torch.relu(layer.location_conv_hidden(attn_cat))
    return torch.sigmoid(layer.location_conv_out(h))


def attention_scores(attn, queries_proj, keys_proj, temperature=1.0):
    """(B, Tq, D), (B, Tk, D) -> (B, Tq, Tk) additive scores through K3
    (its kernels on CUDA, its plain versions on the CPU), in the promoted
    dtype of the queries and keys, as JAX's ``q + k``."""
    dt = torch.promote_types(queries_proj.dtype, keys_proj.dtype)
    v_w = attn.v.linear_layer.weight[0]                        # (D,)
    return _k3_attention_scores(queries_proj.to(dt), keys_proj.to(dt),
                                v_w.to(dt), temperature)


def attention_forward(attn, queries, keys, values, key_mask=None,
                      attn_prior=None, temperature=1.0, attn_map=None):
    """Full attention over a sequence of queries (teacher-forced).

    Args:
      queries: (Tq, B, n_query_dim) attention-LSTM outputs (time-major).
      keys / values: (Tk, B, text + speaker dim) encoder outputs.
      key_mask: (B, Tk) bool, True at valid text positions.
      attn_prior: (B, Tq, Tk) beta-binomial prior or None.
      attn_map: an external attention map (B, Tq, Tk) or None. When given,
        no scores and no softmax are computed: the context is the map
        applied to the projected values, and attn_logprob is None.

    Returns context (B, D_att, Tq), attn (B, Tq, Tk) and attn_logprob
    (B, Tq, Tk) in fp32, taken before the key mask, for the CTC loss.
    With a prior, the posterior and its softmax are fp32, as in the JAX
    package, so under the bf16 policy the context comes out fp32 and
    promotes the decoder after it.
    """
    vals = attn.value(values).transpose(0, 1)                  # (B, Tk, D)
    if attn_map is not None:
        dt = torch.promote_types(attn_map.dtype, vals.dtype)
        context = torch.bmm(attn_map.to(dt), vals.to(dt))
        return context.transpose(1, 2), attn_map, None
    q = attn.query(queries).transpose(0, 1)
    k = attn.key(keys).transpose(0, 1)
    scores = attention_scores(attn, q, k, temperature)
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask[:, None, :], MASK_VALUE)
    w = torch.softmax(scores, dim=2)
    if attn_prior is not None:
        log_post = torch.log(w.float() + 1e-20) \
            + torch.log(attn_prior.float() + 1e-20)
        attn_logprob = log_post
        if key_mask is not None:
            log_post = log_post.masked_fill(~key_mask[:, None, :],
                                            MASK_VALUE)
        w = torch.softmax(log_post, dim=2)
    else:
        attn_logprob = torch.log(w.float() + 1e-8)
    dt = torch.promote_types(w.dtype, vals.dtype)
    context = torch.bmm(w.to(dt), vals.to(dt))                 # (B, Tq, D)
    return context.transpose(1, 2), w, attn_logprob


def attention_precompute(attn, keys, values):
    """Project keys/values once before the AR loop.

    keys/values: (Tk, B, D_in) -> k_proj, vals each (B, Tk, D_att), in the
    compute dtype (the layers' and the text's: bf16 in a bf16 engine, as
    K1's bf16 body takes them).
    """
    return (attn.key(keys).transpose(0, 1).contiguous(),
            attn.value(values).transpose(0, 1).contiguous())


def attention_step(attn, query, k_proj, vals, key_mask=None, prior_t=None,
                   temperature=1.0):
    """One frame: query (B, n_query_dim), k_proj/vals (B, Tk, D),
    key_mask (B, Tk) bool or None, prior_t (B, Tk) or None, temperature a
    scalar or a (B, 1) tensor. Returns context (B, D), attn (B, Tk)."""
    q = attn.query(query)                                      # (B, D)
    v_w = attn.v.linear_layer.weight[0]                        # (D,)
    scores = torch.tanh(q[:, None, :] + k_proj) @ v_w          # (B, Tk)
    # a (B, 1) temperature is cast so that it never promotes a bf16 path
    # (JAX models/attention.py:145-147)
    if torch.is_tensor(temperature):
        temperature = temperature.to(scores.dtype)
    scores = scores / temperature
    if key_mask is not None:
        scores = scores.masked_fill(~key_mask, MASK_VALUE)
    w = torch.softmax(scores, dim=-1)
    if prior_t is not None:
        log_post = torch.log(w + 1e-20) + torch.log(prior_t + 1e-20)
        if key_mask is not None:
            log_post = log_post.masked_fill(~key_mask, MASK_VALUE)
        w = torch.softmax(log_post, dim=-1)
    context = torch.einsum("bk,bkd->bd", w, vals)
    return context, w


def attention_step_external(attn_t, vals):
    """One frame with an external map: attn_t (B, Tk), vals (B, Tk, D) ->
    context (B, D), attn_t (no query, no scores, no softmax)."""
    return torch.einsum("bk,bkd->bd", attn_t, vals), attn_t
