"""Mask-aware LSTMs over whole sequences (port of flowtron_tpu/ops/lstm.py).

- Weights keep torch's ``nn.LSTM`` names and layout: ``weight_ih_l{k}``
  (4H, in), ``weight_hh_l{k}`` (4H, H), biases (4H,), ``_reverse`` for the
  backward direction. Gate order is (i, f, g, o).
- Variable lengths: at masked steps the (h, c) carry is held and the
  output is zeroed. For the reverse direction, holding the zero carry
  until the first valid step equals starting at the true sequence end
  (flowtron_tpu/ops/lstm.py:5-13). Masks are length masks (a valid
  prefix per stream), as everywhere in Flowtron.

Two versions of the same math:
- ``lstm_single_direction``: the plain Python loop over time (the JAX
  ``lax.scan`` body written out, the input projection hoisted into one
  matmul). CPU tensors run it.
- ``lstm_fused``: torch's own fused LSTM (cuDNN on CUDA for fp32) on the
  same weights, variable lengths by packing. CUDA tensors run it. The JAX
  package runs its LSTMs as ``lax.scan`` outside any Pallas kernel, so
  there is no TPU kernel to port here.

Sequences are time-major: (T, B, F).
"""

import math

import torch
from torch import nn
from torch.nn.utils.rnn import (
    PackedSequence, pack_padded_sequence, pad_packed_sequence,
)

from flowtron_tpu_torch.utils.weights import qdot


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
    """One LSTM step given ``x_proj_t`` = x_t @ w_ih.T + b, (B, 4H);
    ``w_hh`` may be quantized (``utils/weights.py:qdot``)."""
    gates = x_proj_t + qdot(h, w_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _promoted(x, weights):
    """x and the weights in their promoted dtype, as JAX's ``jnp.dot``:
    an fp32 input runs bf16 weights in fp32 (and its carry is fp32)."""
    dt = torch.promote_types(x.dtype, weights[0].dtype)
    return x.to(dt), [w.to(dt) for w in weights]


def lstm_single_direction(weights, x, mask=None, reverse=False):
    """Run one direction over (T, B, in) as a Python loop from a zero
    carry. Returns outputs (T, B, H), zero at masked steps, and the final
    (h, c)."""
    x, (w_ih, w_hh, b_ih, b_hh) = _promoted(x, weights)
    T, B = x.shape[:2]
    H = w_hh.shape[1]
    xs = x @ w_ih.t() + (b_ih + b_hh)                 # hoisted projection
    h, c = x.new_zeros(B, H), x.new_zeros(B, H)
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


def lstm_fused(lstm, x, mask=None):
    """All layers (and both directions) of ``lstm`` over (T, B, in) through
    torch's fused LSTM. Returns outputs (T, B, n_dir * H), zero at masked
    steps, and the final (h, c), each (n_layers * n_dir, B, H)."""
    n_dir = 2 if lstm.bidirectional else 1
    x, flat = _promoted(x, [w for layer in range(lstm.num_layers)
                            for rev in (False, True)[:n_dir]
                            for w in lstm.layer_weights(layer, rev)])
    T, B = x.shape[:2]
    h0 = x.new_zeros(lstm.num_layers * n_dir, B, lstm.hidden_size)
    train = torch.is_grad_enabled()
    if mask is None:
        out, h, c = torch._VF.lstm(x, (h0, h0), flat, True, lstm.num_layers,
                                   0.0, train, lstm.bidirectional, False)
        return out, (h, c)
    lengths = mask.sum(0).to("cpu", torch.int64)
    packed = pack_padded_sequence(x, lengths, enforce_sorted=False)
    data, h, c = torch._VF.lstm(packed.data, packed.batch_sizes, (h0, h0),
                                flat, True, lstm.num_layers, 0.0, train,
                                lstm.bidirectional)
    out, _ = pad_packed_sequence(
        PackedSequence(data, packed.batch_sizes, packed.sorted_indices,
                       packed.unsorted_indices), total_length=T)
    order = packed.unsorted_indices
    return out, (h.index_select(1, order), c.index_select(1, order))


def lstm_forward(lstm, x, mask=None):
    """Multi-layer unidirectional LSTM over (T, B, in) (JAX
    ``lstm_forward``). Returns (outputs (T, B, H), [(h, c)] per layer)."""
    if x.device.type == "cuda":
        out, (h, c) = lstm_fused(lstm, x, mask)
        return out, list(zip(h, c))
    finals = []
    for layer in range(lstm.num_layers):
        x, hc = lstm_single_direction(lstm.layer_weights(layer), x, mask)
        finals.append(hc)
    return x, finals


def bilstm_forward(lstm, x, mask=None):
    """Multi-layer bidirectional LSTM; each layer concats fwd || bwd."""
    if x.device.type == "cuda":
        return lstm_fused(lstm, x, mask)[0]
    for layer in range(lstm.num_layers):
        fwd, _ = lstm_single_direction(lstm.layer_weights(layer), x, mask)
        bwd, _ = lstm_single_direction(lstm.layer_weights(layer, True), x,
                                       mask, reverse=True)
        x = torch.cat([fwd, bwd], dim=-1)
    return x
