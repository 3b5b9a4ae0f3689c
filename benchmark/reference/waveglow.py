"""Plain PyTorch WaveGlow inference (Prenger et al. 2019, arXiv:1811.00002;
NVIDIA/waveglow ``glow.py``: ``WaveGlow.infer`` and ``WN.forward``) on a
published state dict with its weight_norm pairs folded, channel-major with
``conv_transpose1d`` and ``conv1d`` as the published code runs it. The
latents are given (the published code draws them inside ``infer``), and
the output is the peak-normalised int16 PCM the server returns. Imports
nothing of the program.

``rounding`` (the control only) computes in a lower precision: every
convolution's weights and inputs, and every stored activation (the
gated product, the residual and skip sums, the audio between flows), are
rounded (``fp8``: float8 e4m3, one scale a tensor); sums accumulate in
fp32.
"""

import torch
import torch.nn.functional as F


def fp8(t):
    """t rounded to float8 e4m3 on one scale (its largest magnitude at
    e4m3's largest, 448), back in t's dtype."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s


def _conv(x, w, b, rounding, **kw):
    if rounding is not None:
        x, w = rounding(x), rounding(w)
    return F.conv1d(x, w, b, **kw)


def _keep(x):
    return x


def _wn(sd, p, audio, spect, C, L, rounding=None):
    r = rounding or _keep
    x = _conv(audio, sd[f"{p}.start.weight"], sd[f"{p}.start.bias"],
              rounding)
    cond = _conv(spect, sd[f"{p}.cond_layer.weight"],
                 sd[f"{p}.cond_layer.bias"], rounding)
    output = None
    for i in range(L):
        d = 2 ** i
        acts = _conv(x, sd[f"{p}.in_layers.{i}.weight"],
                     sd[f"{p}.in_layers.{i}.bias"], rounding, dilation=d,
                     padding=d) + cond[:, 2 * C * i:2 * C * (i + 1)]
        acts = r(acts)
        z = r(torch.tanh(acts[:, :C]) * torch.sigmoid(acts[:, C:]))
        rs = _conv(z, sd[f"{p}.res_skip_layers.{i}.weight"],
                   sd[f"{p}.res_skip_layers.{i}.bias"], rounding)
        if i < L - 1:
            x = r(x + rs[:, :C])
            skip = rs[:, C:]
        else:
            skip = rs
        output = r(skip if output is None else output + skip)
    return _conv(output, sd[f"{p}.end.weight"], sd[f"{p}.end.bias"],
                 rounding)


def infer(sd, wc, mel, z_main, z_early, rounding=None):
    """mel (B, n_mel, F); z_main (B, n_remaining, F * 256 / n_group) and
    z_early {flow: (B, n_early_size, same)}, sigma applied -> audio
    (B, F * 256)."""
    G, C, L = wc["n_group"], wc["n_channels"], wc["n_layers"]
    B, _, F_ = mel.shape
    w_up = sd["upsample.weight"]
    if rounding is not None:
        mel, w_up = rounding(mel), rounding(w_up)
    spect = F.conv_transpose1d(mel, w_up, sd["upsample.bias"], stride=256)
    spect = spect[:, :, :-(w_up.shape[2] - 256)]                # F * 256
    spect = spect.unfold(2, G, G).permute(0, 2, 1, 3)
    spect = spect.reshape(B, spect.shape[1], -1).permute(0, 2, 1)
    r = rounding or _keep
    audio = z_main
    for k in reversed(range(wc["n_flows"])):
        half = audio.shape[1] // 2
        a0, a1 = audio[:, :half], audio[:, half:]
        out = _wn(sd, f"WN.{k}", a0, spect, C, L, rounding)
        a1 = r((a1 - out[:, :half]) * torch.exp(-out[:, half:]))
        audio = torch.cat([a0, a1], 1)
        w_inv = torch.linalg.inv(
            sd[f"convinv.{k}.conv.weight"][:, :, 0].double()).to(audio.dtype)
        audio = F.conv1d(audio, w_inv[:, :, None])
        if k % wc["n_early_every"] == 0 and k > 0:
            audio = torch.cat([z_early[k], audio], 1)
    return audio.permute(0, 2, 1).reshape(B, -1)


def pcm16(audio, n_valid, hop=256):
    """The served answer: audio peak-normalised over its n_valid frames,
    zero past them, as int16 ((B, T) -> (B, T) int16; row b's answer is
    its first n_valid[b] * hop samples)."""
    valid = torch.arange(audio.shape[1], device=audio.device)[None, :] \
        < (n_valid * hop)[:, None]
    peak = (audio.abs() * valid).amax(dim=1, keepdim=True)
    out = audio / peak.clamp(min=1e-8) * valid
    return torch.clamp(out * 32767.0, -32767, 32767).to(torch.int16)
