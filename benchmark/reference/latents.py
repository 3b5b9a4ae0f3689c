"""The served latent-drawing rule, frozen: what a request's ``seed`` and
``sigma`` give. A request's mel latents are N(0, 1) * sigma of shape
(1, n_mel, n_frames) from a CPU ``torch.Generator`` seeded ``seed``; its
vocoder latents come from a second CPU generator, seeded with the first
word of numpy's ``SeedSequence([seed mod 2**64, 1986])``: N(0, 1) * 0.8
for the innermost channels over the full length, then for each
early-output flow in increasing order. Windows and batches slice these;
they never draw anew."""

import numpy as np
import torch

WG_SIGMA = 0.8
VOCODER_STREAM = 1986


def mel_latents(seed, sigma, n_mel, n_frames):
    """(1, n_mel, n_frames) fp32 on the CPU."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn(1, n_mel, n_frames, generator=g) * float(sigma)


def vocoder_latents(seed, wc, n_remaining, n_frames):
    """(z_main (1, n_remaining, Tg), {flow: (1, n_early_size, Tg)}), fp32
    on the CPU, Tg = n_frames * 256 / n_group."""
    entropy = np.random.SeedSequence([int(seed) % 2 ** 64, VOCODER_STREAM])
    g = torch.Generator().manual_seed(int(entropy.generate_state(1)[0]))
    Tg = n_frames * 256 // wc["n_group"]
    z_main = WG_SIGMA * torch.randn(1, n_remaining, Tg, generator=g)
    z_early = {f: WG_SIGMA * torch.randn(1, wc["n_early_size"], Tg,
                                         generator=g)
               for f in range(1, wc["n_flows"])
               if f % wc["n_early_every"] == 0}
    return z_main, z_early
