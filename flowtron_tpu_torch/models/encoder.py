"""Text encoder (port of flowtron_tpu/models/encoder.py, inference only).

3 x (conv k=5 + instance norm + relu), padding zeroed before each conv on
the masked path, then a single-layer BiLSTM (reference:flowtron.py:467-525).
Dropout is a training feature and is not part of this inference port.
"""

import torch
from torch import nn

from flowtron_tpu_torch.models.layers import (
    ConvNorm, InstanceNormAffine, masked_instance_norm, instance_norm,
)
from flowtron_tpu_torch.ops.lstm import LSTM, bilstm_forward


class Encoder(nn.Module):
    """State names: ``convolutions.{i}.0.conv.*``, ``convolutions.{i}.1.*``,
    ``lstm.*`` — the reference's module tree."""

    def __init__(self, encoder_n_convolutions=3, encoder_embedding_dim=512,
                 encoder_kernel_size=5, generator=None):
        super().__init__()
        dim = encoder_embedding_dim
        self.convolutions = nn.ModuleList(
            nn.ModuleList([
                ConvNorm(dim, dim, encoder_kernel_size, w_init_gain="relu",
                         generator=generator),
                InstanceNormAffine(dim)])
            for _ in range(encoder_n_convolutions))
        self.lstm = LSTM(dim, dim // 2, num_layers=1, bidirectional=True,
                         generator=generator)


def _conv_stack(encoder, x, mask_b1t):
    for conv, norm in encoder.convolutions:
        if mask_b1t is not None:
            x = torch.where(mask_b1t, x, 0.0)
        y = conv(x)
        if mask_b1t is not None:
            y = masked_instance_norm(y, mask_b1t, weight=norm.weight,
                                     bias=norm.bias)
        else:
            y = instance_norm(y, weight=norm.weight, bias=norm.bias)
        x = torch.relu(y)
    return x


def encoder_forward(encoder, x, in_lens_mask):
    """x (B, C, T) text embeddings, in_lens_mask (B, T) bool ->
    (T, B, C) time-major outputs, zero at padding."""
    x = _conv_stack(encoder, x, in_lens_mask[:, None, :])
    return bilstm_forward(encoder.lstm, x.permute(2, 0, 1), in_lens_mask.t())


def encoder_infer(encoder, x):
    """Unmasked path (reference:flowtron.py:516-525)."""
    x = _conv_stack(encoder, x, None)
    return bilstm_forward(encoder.lstm, x.permute(2, 0, 1), None)
