"""Gaussian-mixture head (port of flowtron_tpu/models/gaussian_mixture.py;
reference:flowtron.py:312-363).

The mixture weights come from the mel-encoder embedding. With
``fixed_gaussian`` the means are scaled one-hot rows of the identity
chosen at init and the log-variances zero, both buffers: they are in the
state_dict (``gaussian_mixture.mean`` / ``.log_var``) but not among the
parameters, so the optimizer never sees them (the JAX package's
``trainable_mask``). Otherwise means and log-variances are predicted
from the embedding. The JAX package draws the one-hot channels with
``jax.random.choice``, which torch cannot reproduce: the port draws its
own from its generator, and the tests load JAX's through
``utils/convert.py``.
"""

import torch
from torch import nn

from flowtron_tpu_torch.models.layers import LinearNorm


class GaussianMixture(nn.Module):
    def __init__(self, n_hidden, n_components, n_mel_channels,
                 fixed_gaussian=True, mean_scale=0.0, generator=None):
        super().__init__()
        self.prob_layer = LinearNorm(n_hidden, n_components,
                                     generator=generator)
        if not fixed_gaussian:
            self.mean_layer = LinearNorm(
                n_hidden, n_mel_channels * n_components, generator=generator)
            self.log_var_layer = LinearNorm(
                n_hidden, n_mel_channels * n_components, generator=generator)
        else:
            ids = torch.randperm(n_mel_channels,
                                 generator=generator)[:n_components]
            mean = torch.eye(n_mel_channels)[ids] * mean_scale   # (K, M)
            self.register_buffer("mean", mean.t()[None].contiguous())
            self.register_buffer(
                "log_var", torch.zeros(1, n_mel_channels, n_components))


def gaussian_mixture_forward(gm, outputs, n_components, n_mel_channels):
    """outputs (B, n_hidden) -> mean and log_var (1 or B, n_mel, K), prob
    (B, K)."""
    prob = torch.softmax(gm.prob_layer(outputs), dim=1)
    if hasattr(gm, "mean_layer"):
        bs = outputs.shape[0]
        shape = (bs, n_mel_channels, n_components)
        return (gm.mean_layer(outputs).reshape(shape),
                gm.log_var_layer(outputs).reshape(shape), prob)
    return gm.mean, gm.log_var, prob
