"""Text encoder and mel encoder (port of flowtron_tpu/models/encoder.py).

Text encoder: 3 x (conv k=5 + instance norm + relu + dropout 0.5 when
training), padding zeroed before each conv on the masked path, then a
single-layer BiLSTM (reference:flowtron.py:467-525). Mel encoder (the
Gaussian-mixture head's input, reference:flowtron.py:366-450): the same
stack with 2 convs k=3 over the mel and a BiLSTM of n_hidden // 2 a
direction, then a mean over the padded length (the reference divides by
the longest length, not the true one; kept for checkpoint parity). On
CUDA both BiLSTMs run cuDNN (``ops/lstm.py``). Dropout keeps each value with
probability 0.5 and scales it by 1 / 0.5, drawing from an explicit
``torch.Generator``; its draws cannot match ``jax.random``'s, so the
tests compare the packages with dropout off.
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
                 encoder_kernel_size=5, generator=None, in_channels=None):
        super().__init__()
        dim = encoder_embedding_dim
        self.convolutions = nn.ModuleList(
            nn.ModuleList([
                ConvNorm(dim if i or in_channels is None else in_channels,
                         dim, encoder_kernel_size, w_init_gain="relu",
                         generator=generator),
                InstanceNormAffine(dim)])
            for i in range(encoder_n_convolutions))
        self.lstm = LSTM(dim, dim // 2, num_layers=1, bidirectional=True,
                         generator=generator)


class MelEncoder(Encoder):
    """The reference's MelEncoder: two k=3 convs, the first from the mel
    channels, and the BiLSTM; the same state names as ``Encoder``."""

    def __init__(self, n_hidden=512, encoder_kernel_size=3,
                 encoder_n_convolutions=2, n_mel_channels=80,
                 generator=None):
        super().__init__(encoder_n_convolutions, n_hidden,
                         encoder_kernel_size, generator,
                         in_channels=n_mel_channels)


def _conv_stack(encoder, x, mask_b1t, train=False, generator=None):
    for conv, norm in encoder.convolutions:
        if mask_b1t is not None:
            x = torch.where(mask_b1t, x, 0.0)
        y = conv(x)
        if mask_b1t is not None:
            y = masked_instance_norm(y, mask_b1t, weight=norm.weight,
                                     bias=norm.bias)
        else:
            y = instance_norm(y, weight=norm.weight, bias=norm.bias)
        y = torch.relu(y)
        if train and generator is not None:
            keep = torch.rand(y.shape, generator=generator,
                              device=y.device) < 0.5
            y = torch.where(keep, y / 0.5, 0.0)
        x = y
    return x


def encoder_forward(encoder, x, in_lens_mask, train=False, generator=None):
    """x (B, C, T) text embeddings, in_lens_mask (B, T) bool ->
    (T, B, C) time-major outputs, zero at padding. Dropout runs when
    ``train`` and a ``generator`` (on x's device) are given."""
    x = _conv_stack(encoder, x, in_lens_mask[:, None, :], train, generator)
    return bilstm_forward(encoder.lstm, x.permute(2, 0, 1), in_lens_mask.t())


def encoder_infer(encoder, x):
    """Unmasked path (reference:flowtron.py:516-525)."""
    x = _conv_stack(encoder, x, None)
    return bilstm_forward(encoder.lstm, x.permute(2, 0, 1), None)


def mel_encoder_forward(encoder, mel, out_lens_mask, train=False,
                        generator=None):
    """mel (B, n_mel, T), out_lens_mask (B, T) bool -> (B, n_hidden), the
    BiLSTM's outputs averaged over all T frames, padding included."""
    x = _conv_stack(encoder, mel, out_lens_mask[:, None, :], train,
                    generator)
    x = bilstm_forward(encoder.lstm, x.permute(2, 0, 1), out_lens_mask.t())
    return x.mean(0)
