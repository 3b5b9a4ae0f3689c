"""Basic layers (port of flowtron_tpu/models/layers.py).

Modules hold parameters under the reference's names (``.linear_layer``,
``.conv``, ``.weight``/``.bias``), in torch's (out, in) layout, so a
reference-format state_dict loads with ``strict=True``. The math lives in
plain functions on tensors. Initializers mirror the JAX package's
xavier-uniform with activation gains; they draw from an explicit
``torch.Generator`` and cannot reproduce ``jax.random`` draws, so tests
move weights across with ``utils/convert.py`` instead.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from flowtron_tpu_torch.utils.weights import (
    QuantizedWeight, ShardedWeight, qdot,
)

_GAINS = {
    "linear": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
    "sigmoid": 1.0,
}


def xavier_uniform(shape, gain=1.0, generator=None):
    """Xavier/Glorot uniform over ``shape`` = (out, in) or (out, in, k)."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_out, fan_in = shape[0] * receptive, shape[1] * receptive
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


# ---------------------------------------------------------------------------
# plain functions
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None):
    """``F.linear`` with the JAX package's dtype promotion: an fp32 input
    meets bf16 weights in fp32, as ``jnp.dot`` does (the bf16 policy's
    decoder after the fp32 attention posterior). A quantized or sharded
    weight goes through ``qdot``, as JAX's ``linear_apply`` does."""
    if isinstance(weight, (QuantizedWeight, ShardedWeight)):
        y = qdot(x, weight)
        return y if bias is None else y + bias
    dt = torch.promote_types(x.dtype, weight.dtype)
    return F.linear(x.to(dt), weight.to(dt),
                    None if bias is None else bias.to(dt))


def conv1d_same(x, weight, bias=None, dilation=1):
    """'Same'-padded 1-D conv, x (B, C_in, T), weight (C_out, C_in, k odd)."""
    pad = dilation * (weight.shape[-1] - 1) // 2
    return F.conv1d(x, weight, bias, padding=pad, dilation=dilation)


def masked_instance_norm(x, mask, eps=1e-5, weight=None, bias=None):
    """Instance norm over valid steps only; x (B, C, T), mask (B, 1, T)."""
    mask_f = mask.to(x.dtype)
    lengths = mask_f.sum(-1)                                  # (B, 1)
    mean = (x * mask_f).sum(-1) / lengths                     # (B, C)
    var = (((x - mean[..., None]) * mask_f) ** 2).sum(-1) / lengths
    out = (x - mean[..., None]) / torch.sqrt(var[..., None] + eps)
    if weight is not None:
        out = out * weight[None, :, None] + bias[None, :, None]
    return out


def instance_norm(x, eps=1e-5, weight=None, bias=None):
    """Plain instance norm over time (the unmasked inference path)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    out = (x - mean) / torch.sqrt(var + eps)
    if weight is not None:
        out = out * weight[None, :, None] + bias[None, :, None]
    return out


# ---------------------------------------------------------------------------
# parameter holders
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """Holds ``weight`` (out, in) and an optional ``bias`` (out,)."""

    def __init__(self, in_dim, out_dim, bias=True, w_init_gain="linear",
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(xavier_uniform(
            (out_dim, in_dim), _GAINS[w_init_gain], generator))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LinearNorm(nn.Module):
    """reference:flowtron.py:278-288 module shape (``.linear_layer``)."""

    def __init__(self, in_dim, out_dim, bias=True, w_init_gain="linear",
                 generator=None):
        super().__init__()
        self.linear_layer = Linear(in_dim, out_dim, bias, w_init_gain,
                                   generator)

    def forward(self, x):
        return self.linear_layer(x)


class Conv1d(nn.Module):
    """Holds ``weight`` (out, in, k) and ``bias`` (out,)."""

    def __init__(self, in_channels, out_channels, kernel_size=1,
                 w_init_gain="linear", generator=None):
        super().__init__()
        self.weight = nn.Parameter(xavier_uniform(
            (out_channels, in_channels, kernel_size), _GAINS[w_init_gain],
            generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x, dilation=1):
        return conv1d_same(x, self.weight, self.bias, dilation)


class ConvNorm(nn.Module):
    """reference:flowtron.py:291-309 module shape (``.conv``)."""

    def __init__(self, in_channels, out_channels, kernel_size=1,
                 w_init_gain="linear", generator=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size,
                           w_init_gain, generator)

    def forward(self, x, dilation=1):
        return self.conv(x, dilation)


class Embedding(nn.Module):
    """Holds ``weight`` (num, dim), N(0, 1) init as torch's Embedding."""

    def __init__(self, num, dim, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num, dim).normal_(
            generator=generator))

    def forward(self, ids):
        return self.weight[ids]


class InstanceNormAffine(nn.Module):
    """Affine parameters of an instance norm (``weight``/``bias``)."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class DenseLayer(nn.Module):
    """Stack of Linear + tanh (reference:flowtron.py:453-464)."""

    def __init__(self, in_dim=1024, sizes=(1024, 1024), generator=None):
        super().__init__()
        in_sizes = (in_dim,) + tuple(sizes[:-1])
        self.layers = nn.ModuleList(
            LinearNorm(i, o, bias=True, generator=generator)
            for i, o in zip(in_sizes, sizes))

    def forward(self, x):
        for layer in self.layers:
            x = torch.tanh(layer(x))
        return x
