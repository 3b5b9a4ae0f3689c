"""Mask-aware LSTM as a Python loop over time (port of
flowtron_tpu/ops/lstm.py).

- Weights keep torch's ``nn.LSTM`` names and layout: ``weight_ih_l{k}``
  (4H, in), ``weight_hh_l{k}`` (4H, H), biases (4H,), ``_reverse`` for the
  backward direction. Gate order is (i, f, g, o).
- The input projection for all timesteps is hoisted out of the loop into
  one matmul; only the recurrent (B, H) x (H, 4H) product stays inside.
- Variable lengths use masking instead of packing: at masked steps the
  (h, c) carry is held and the output is zeroed. For the reverse
  direction, holding the zero carry until the first valid step equals
  starting at the true sequence end, so this reproduces
  pack_padded_sequence semantics (flowtron_tpu/ops/lstm.py:5-13).

Sequences are time-major: (T, B, F). This loop runs off the kernel path
(the text encoder runs it once per request).
"""

import math

import torch
from torch import nn


class LSTM(nn.Module):
    """Parameter holder named and laid out like ``torch.nn.LSTM``.

    Uniform(-1/sqrt(H), 1/sqrt(H)) init, torch's default.
    """

    def __init__(self, input_size, hidden_size, num_layers=1,
                 bidirectional=False, generator=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        bound = 1.0 / math.sqrt(hidden_size)
        n_dir = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * n_dir
            for suffix in ("", "_reverse")[:n_dir]:
                for name, shape in (
                        ("weight_ih", (4 * hidden_size, in_size)),
                        ("weight_hh", (4 * hidden_size, hidden_size)),
                        ("bias_ih", (4 * hidden_size,)),
                        ("bias_hh", (4 * hidden_size,))):
                    self.register_parameter(
                        f"{name}_l{layer}{suffix}",
                        nn.Parameter(torch.empty(shape).uniform_(
                            -bound, bound, generator=generator)))

    def layer_weights(self, layer, reverse=False):
        """(w_ih, w_hh, b_ih, b_hh) of one layer and direction."""
        s = f"_l{layer}" + ("_reverse" if reverse else "")
        return (getattr(self, "weight_ih" + s), getattr(self, "weight_hh" + s),
                getattr(self, "bias_ih" + s), getattr(self, "bias_hh" + s))


def lstm_cell(x_proj_t, h, c, w_hh):
    """One LSTM step given ``x_proj_t`` = x_t @ w_ih.T + b, (B, 4H)."""
    gates = x_proj_t + h @ w_hh.t()
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_single_direction(weights, x, mask=None, reverse=False):
    """Run one direction over (T, B, in). Returns outputs (T, B, H), zero
    at masked steps, and the final (h, c)."""
    w_ih, w_hh, b_ih, b_hh = weights
    T, B = x.shape[:2]
    H = w_hh.shape[1]
    xs = x @ w_ih.t() + (b_ih + b_hh)                 # hoisted projection
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    mask_f = None if mask is None else mask.to(x.dtype)[..., None]
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new = lstm_cell(xs[t], h, c, w_hh)
        if mask_f is None:
            h, c = h_new, c_new
            ys[t] = h_new
        else:
            m = mask_f[t]
            h = m * h_new + (1.0 - m) * h
            c = m * c_new + (1.0 - m) * c
            ys[t] = h_new * m
    return torch.stack(ys), (h, c)


def bilstm_forward(lstm, x, mask=None):
    """Multi-layer bidirectional LSTM; each layer concats fwd || bwd."""
    for layer in range(lstm.num_layers):
        fwd, _ = lstm_single_direction(lstm.layer_weights(layer), x, mask)
        bwd, _ = lstm_single_direction(lstm.layer_weights(layer, True), x,
                                       mask, reverse=True)
        x = torch.cat([fwd, bwd], dim=-1)
    return x
