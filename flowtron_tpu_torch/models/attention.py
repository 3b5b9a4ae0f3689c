"""Additive (tanh) attention for the AR inference loop (port of
``attention_precompute`` / ``attention_step`` in
flowtron_tpu/models/attention.py).

score = v . tanh(q + k) / temperature, softmax over text positions,
optional beta-binomial prior posterior (reference:flowtron.py:528-592).
"""

import torch
from torch import nn

from flowtron_tpu_torch.models.layers import LinearNorm

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


def attention_precompute(attn, keys, values):
    """Project keys/values once before the AR loop.

    keys/values: (Tk, B, D_in) -> k_proj, vals each (B, Tk, D_att).
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
