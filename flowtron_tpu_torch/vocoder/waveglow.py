"""WaveGlow flow vocoder (port of flowtron_tpu/vocoder/waveglow.py:
``waveglow_init``, ``_upsample_mel``, the WN stacks, ``_squeeze_audio``,
``waveglow_forward``, ``waveglow_loss``, the inverse 1x1 conv,
``waveglow_n_remaining``, ``waveglow_infer_z``, ``waveglow_infer`` and
``load_waveglow``).

Audio is squeezed into groups of ``n_group`` samples; ``n_flows`` steps of
[invertible 1x1 conv -> affine coupling] map it to z (training,
``waveglow_forward``) and are inverted from z ~ N(0, sigma^2) (inference),
fully parallel over time.

Inference runs the coupling's WN stack time-major, activations as
(B, T, C), and every WN layer goes through kernel K2 (``ops/wavenet.py``)
on CUDA tensors and its plain version on CPU tensors. A bf16 vocoder (the
serving engine's ``bf16``: every parameter cast) runs the inverse in
bf16, with the dtypes of the JAX package's Pallas WN path
(``_wavenet_pallas``): K2's bf16 body, the 1x1 convs and the upsample as
bf16 matmuls, the skip sum in fp32 (its :234-235), and the inverse 1x1
weight inverted in fp32 from the bf16 weight, then cast back (JAX
``waveglow_infer_z``, :412-414). Training runs it in
the channel-major form of the JAX package's ``_wavenet_nch`` (the path
JAX's ``waveglow_forward`` takes by default, an XLA convolution and not a
Pallas kernel): ``F.conv1d`` with dilation, the one conditioning conv of
all layers, the tanh * sigmoid gate and res/skip, differentiable on every
device. K2 has no backward, so the training direction never reaches it.

Parameter names follow the published WaveGlow state_dict (``upsample``,
``convinv.{f}.conv``, ``WN.{f}.{start,end,cond_layer,in_layers.{l},
res_skip_layers.{l}}``).
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from flowtron_tpu_torch.ops.wavenet import wn_layer
from flowtron_tpu_torch.utils.convert import waveglow_from_jax
from flowtron_tpu_torch.utils.jax_pickle import load_jax_pickle


def _conv(out_c, in_c, k, generator, zero=False):
    """A conv parameter holder (``weight`` (out, in, k), ``bias``) with
    torch's default uniform(+-1/sqrt(in*k)) init, or zeros."""
    m = nn.Module()
    bound = 1.0 / math.sqrt(in_c * k)
    if zero:
        m.weight = nn.Parameter(torch.zeros(out_c, in_c, k))
        m.bias = nn.Parameter(torch.zeros(out_c))
    else:
        m.weight = nn.Parameter(torch.empty(out_c, in_c, k).uniform_(
            -bound, bound, generator=generator))
        m.bias = nn.Parameter(torch.empty(out_c).uniform_(
            -bound, bound, generator=generator))
    return m


class WN(nn.Module):
    """Gated WaveNet of one coupling layer."""

    def __init__(self, n_in, n_mel_group, n_layers, n_channels, kernel_size,
                 generator=None):
        super().__init__()
        self.n_layers, self.n_channels = n_layers, n_channels
        self.start = _conv(n_channels, n_in, 1, generator)
        # zero-init end conv: the coupling starts as the identity
        self.end = _conv(2 * n_in, n_channels, 1, generator, zero=True)
        self.cond_layer = _conv(2 * n_channels * n_layers, n_mel_group, 1,
                                generator)
        self.in_layers = nn.ModuleList(
            _conv(2 * n_channels, n_channels, kernel_size, generator)
            for _ in range(n_layers))
        self.res_skip_layers = nn.ModuleList(
            _conv(2 * n_channels if k < n_layers - 1 else n_channels,
                  n_channels, 1, generator)
            for k in range(n_layers))
        self._packed = None

    def _apply(self, fn, *args, **kwargs):
        self._packed = None        # moved or cast: pack anew
        return super()._apply(fn, *args, **kwargs)

    def packed_layers(self):
        """Per layer (w_cat (3C, 2C), b, w_rs (C, n_rs), b_rs) in K2's
        layout, cached and rebuilt when a parameter changes."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                layers = []
                for conv, rs in zip(self.in_layers, self.res_skip_layers):
                    w = conv.weight                          # (2C, C, 3)
                    w_cat = torch.cat([w[:, :, k].t() for k in range(3)])
                    layers.append((w_cat.contiguous(), conv.bias.detach(),
                                   rs.weight[:, :, 0].t().contiguous(),
                                   rs.bias.detach()))
            self._packed = (key, layers)
        return self._packed[1]


class WaveGlow(nn.Module):
    def __init__(self, n_mel_channels=80, n_flows=12, n_group=8,
                 n_early_every=4, n_early_size=2, n_layers=8,
                 n_channels=256, kernel_size=3, generator=None):
        super().__init__()
        self.upsample = _conv(n_mel_channels, n_mel_channels, 1024,
                              generator)  # ConvTranspose1d: (in, out, k)
        self.convinv = nn.ModuleList()
        self.WN = nn.ModuleList()
        n_remaining = n_group
        for f in range(n_flows):
            if f % n_early_every == 0 and f > 0:
                n_remaining -= n_early_size
            # invertible 1x1: random orthogonal with positive determinant
            q = torch.linalg.qr(torch.empty(n_remaining, n_remaining).normal_(
                generator=generator))[0]
            if torch.det(q) < 0:
                q[:, 0] = -q[:, 0]
            inv = nn.Module()
            inv.conv = nn.Module()
            inv.conv.weight = nn.Parameter(q[:, :, None].contiguous())
            self.convinv.append(inv)
            self.WN.append(WN(n_remaining // 2, n_mel_channels * n_group,
                              n_layers, n_channels, kernel_size, generator))

    def forward(self, config, spect, audio):
        """``waveglow_forward``'s body on this module's (possibly swapped,
        see ``torch.func.functional_call``) parameters."""
        return _forward(self, config, spect, audio)


def waveglow_init(seed=0, device="cpu", n_mel_channels=80, n_flows=12,
                  n_group=8, n_early_every=4, n_early_size=2, n_layers=8,
                  n_channels=256, kernel_size=3):
    """A seeded ``WaveGlow`` (drawn on the CPU, then moved) and its
    config dict."""
    config = dict(n_mel_channels=n_mel_channels, n_flows=n_flows,
                  n_group=n_group, n_early_every=n_early_every,
                  n_early_size=n_early_size, n_layers=n_layers,
                  n_channels=n_channels, kernel_size=kernel_size)
    generator = torch.Generator().manual_seed(seed)
    model = WaveGlow(generator=generator, **config).to(device)
    return model.eval(), config


def _mm1x1(x_tc, conv):
    """1x1 conv as (B, T, C_in) @ (C_in, C_out)."""
    return x_tc @ conv.weight[:, :, 0].t() + conv.bias


def _wavenet(wn, audio_half, spect_t):
    """Time-major gated WaveNet. audio_half (B, n_half, T), spect_t
    (B, T, n_mel * n_group) -> (B, 2 * n_half, T)."""
    C = wn.n_channels
    x = _mm1x1(audio_half.transpose(1, 2), wn.start).contiguous()  # (B, T, C)
    cond = _mm1x1(spect_t, wn.cond_layer).contiguous()        # (B, T, 2CL)
    T = x.shape[1]
    dtype = x.dtype
    out = None
    for k, (w_cat, b, w_rs, b_rs) in enumerate(wn.packed_layers()):
        x_new, skip = wn_layer(x, 2 ** k, cond[..., 2 * C * k:2 * C * (k + 1)],
                               w_cat, b, w_rs, b_rs, T)
        # the skips are summed in fp32 (a bf16 skip promotes)
        out = skip.float() if out is None else out + skip
        if x_new is not None:
            x = x_new
    return _mm1x1(out.to(dtype), wn.end).transpose(1, 2)


def _upsample_mel(model, spect, n_group, time_cutoff_samples):
    """ConvTranspose1d(k=1024, stride=256), then trim and group, in the JAX
    package's phase-decomposed matmul form: output sample 256 m + r is
    sum_j spect[:, m - j] @ W[:, :, r + 256 j].

    spect (B, n_mel, T_mel) -> (B, n_mel * n_group, T_audio / n_group).
    """
    w = model.upsample.weight                       # (in, out, 1024)
    in_c, out_c, _ = w.shape
    B, _, M = spect.shape
    x = spect.transpose(1, 2)                       # (B, M, in)
    shifts = [x] + [torch.nn.functional.pad(x, (0, 0, j, 0))[:, :M]
                    for j in range(1, 4)]
    x4 = torch.cat(shifts, dim=-1)                  # (B, M, 4 in)
    w4 = (w.reshape(in_c, out_c, 4, 256).permute(2, 0, 1, 3)
          .reshape(4 * in_c, out_c * 256))
    y = (x4 @ w4).reshape(B, M, out_c, 256).permute(0, 2, 1, 3) \
        .reshape(B, out_c, M * 256)
    y = y + model.upsample.bias[None, :, None]
    y = y[:, :, :time_cutoff_samples]
    T = y.shape[2]
    Tg = T // n_group
    y = y[:, :, :Tg * n_group].reshape(B, out_c, Tg, n_group)
    return y.permute(0, 2, 1, 3).reshape(B, Tg, out_c * n_group) \
        .transpose(1, 2)


def _unsqueeze_audio(audio_g):
    """(B, n_group, Tg) -> (B, Tg * n_group)."""
    B, G, Tg = audio_g.shape
    return audio_g.transpose(1, 2).reshape(B, Tg * G)


def _squeeze_audio(audio, n_group):
    """(B, T) -> (B, n_group, T // n_group), torch's unfold layout."""
    B, T = audio.shape
    Tg = T // n_group
    return audio[:, :Tg * n_group].reshape(B, Tg, n_group).transpose(1, 2)


def _conv1d(conv, x, dilation=1):
    """A "same" conv (B, C_in, T) -> (B, C_out, T), the bias added after
    the product as the JAX package adds it."""
    pad = dilation * (conv.weight.shape[-1] - 1) // 2
    return F.conv1d(x, conv.weight, padding=pad, dilation=dilation) \
        + conv.bias[None, :, None]


def _wavenet_nch(wn, audio_half, spect):
    """Channel-major gated WaveNet (the JAX package's ``_wavenet_nch``).
    audio_half (B, n_half, T), spect (B, n_mel * n_group, T) ->
    (B, 2 * n_half, T)."""
    C, L = wn.n_channels, wn.n_layers
    x = _conv1d(wn.start, audio_half)
    cond = _conv1d(wn.cond_layer, spect)                # (B, 2 C L, T)
    output = torch.zeros_like(x)
    for k in range(L):
        acts = _conv1d(wn.in_layers[k], x, dilation=2 ** k) \
            + cond[:, 2 * C * k:2 * C * (k + 1)]
        z = torch.tanh(acts[:, :C]) * torch.sigmoid(acts[:, C:])
        rs = _conv1d(wn.res_skip_layers[k], z)
        if k < L - 1:
            x = x + rs[:, :C]
            output = output + rs[:, C:]
        else:
            output = output + rs
    return _conv1d(wn.end, output)


def _forward(model, config, spect, audio):
    n_group, n_early_every = config["n_group"], config["n_early_every"]
    n_early_size = config["n_early_size"]
    audio_g = _squeeze_audio(audio, n_group)
    Tg = audio_g.shape[2]
    spect_g = _upsample_mel(model, spect, n_group, Tg * n_group)[:, :, :Tg]
    output_audio, log_s_list, log_det_list = [], [], []
    for f in range(config["n_flows"]):
        if f % n_early_every == 0 and f > 0:
            output_audio.append(audio_g[:, :n_early_size])
            audio_g = audio_g[:, n_early_size:]
        W = model.convinv[f].conv.weight[:, :, 0]
        audio_g = torch.einsum("ij,bjt->bit", W, audio_g)
        logdet = torch.linalg.slogdet(W.float())[1]
        log_det_list.append(audio_g.shape[0] * audio_g.shape[2] * logdet)
        n_half = audio_g.shape[1] // 2
        audio_0, audio_1 = audio_g[:, :n_half], audio_g[:, n_half:]
        out = _wavenet_nch(model.WN[f], audio_0, spect_g)
        log_s, b = out[:, n_half:], out[:, :n_half]
        audio_1 = torch.exp(log_s) * audio_1 + b
        log_s_list.append(log_s)
        audio_g = torch.cat([audio_0, audio_1], dim=1)
    output_audio.append(audio_g)
    return torch.cat(output_audio, dim=1), log_s_list, log_det_list


def waveglow_forward(model, config, spect, audio, compute_dtype=None):
    """Training direction: audio (B, T), spect (B, n_mel, T_mel) ->
    (z (B, n_group, T // n_group), log_s list, log_det list), each
    log_det ``B * Tg * log|det W|`` in fp32.

    compute_dtype: e.g. torch.bfloat16, the ``fp16_run`` policy of the
    JAX package's vocoder trainer: the pass runs on cast copies of every
    floating parameter (``torch.func.functional_call``, so gradients reach
    the fp32 parameters), with spect and audio cast too; the outputs keep
    the dtypes the pass gives them (the caller casts them for the loss).
    """
    if compute_dtype is None:
        return _forward(model, config, spect, audio)
    cast = {name: p.to(compute_dtype) if p.is_floating_point() else p
            for name, p in model.named_parameters()}
    return torch.func.functional_call(
        model, cast, (config, spect.to(compute_dtype),
                      audio.to(compute_dtype)))


def waveglow_loss(z, log_s_list, log_det_list, sigma=1.0):
    """-log p(x): the Gaussian NLL of z minus the flows' log-determinants,
    over the elements of z (the WaveGlow paper's convention)."""
    log_s_total = sum(torch.sum(ls) for ls in log_s_list)
    log_det_total = sum(log_det_list)
    loss = (torch.sum(z * z) / (2 * sigma * sigma)
            - log_s_total - log_det_total)
    return loss / (z.shape[0] * z.shape[1] * z.shape[2])


def waveglow_n_remaining(config):
    """Channel count of the innermost flow after the early outputs."""
    n = config["n_group"]
    for f in range(config["n_flows"]):
        if f % config["n_early_every"] == 0 and f > 0:
            n -= config["n_early_size"]
    return n


@torch.no_grad()
def waveglow_infer_z(model, config, spect, z_main, z_early):
    """Inverse pass with given latents.

    spect (B, n_mel, T_mel); z_main (B, n_remaining, Tg) innermost latents
    (sigma applied); z_early: n_flows entries, (B, n_early_size, Tg) at
    each early-output flow, None elsewhere. Returns audio (B, T_mel * 256)
    in the model's dtype (spect and the latents in it too).
    """
    n_group, n_flows = config["n_group"], config["n_flows"]
    Tg = spect.shape[2] * 256 // n_group
    spect_t = _upsample_mel(model, spect, n_group, Tg * n_group)[:, :, :Tg] \
        .transpose(1, 2).contiguous()               # (B, Tg, n_mel * n_group)
    audio_g = z_main
    for f in reversed(range(n_flows)):
        n_half = audio_g.shape[1] // 2
        audio_0, audio_1 = audio_g[:, :n_half], audio_g[:, n_half:]
        out = _wavenet(model.WN[f], audio_0, spect_t)
        log_s, b = out[:, n_half:], out[:, :n_half]
        audio_1 = (audio_1 - b) * torch.exp(-log_s)
        audio_g = torch.cat([audio_0, audio_1], dim=1)
        w_inv = torch.linalg.inv(
            model.convinv[f].conv.weight[:, :, 0].float()).to(audio_g.dtype)
        audio_g = torch.einsum("ij,bjt->bit", w_inv, audio_g)
        if f % config["n_early_every"] == 0 and f > 0:
            audio_g = torch.cat([z_early[f], audio_g], dim=1)
    return _unsqueeze_audio(audio_g)


def waveglow_infer(model, config, spect, sigma=1.0, seed=0):
    """spect (B, n_mel, T_mel) -> audio (B, T_mel * 256). Latents are drawn
    on the CPU from ``torch.Generator().manual_seed(seed)``, so a seed gives
    the same latents on every device."""
    B = spect.shape[0]
    Tg = spect.shape[2] * 256 // config["n_group"]
    g = torch.Generator().manual_seed(seed)

    def draw(c):
        return (sigma * torch.randn(B, c, Tg, generator=g)).to(
            spect.device, spect.dtype)

    z_main = draw(waveglow_n_remaining(config))
    z_early = [draw(config["n_early_size"])
               if f % config["n_early_every"] == 0 and f > 0 else None
               for f in range(config["n_flows"])]
    return waveglow_infer_z(model, config, spect, z_main, z_early)


def load_waveglow(path, device="cpu"):
    """Load a WaveGlow, each kind with ``strict=True``: a ``.pt`` that holds
    its ``config`` (as ``scripts/train_waveglow.py`` writes it) at that
    width; a published ``.pt`` state_dict without one in the 256-channel
    layout (``waveglow_init``'s defaults), weight_norm pairs
    (``weight_g``, ``weight_v``) folded into weights (only tensors are
    unpickled, ``weights_only=True``); any other file as the JAX
    package's ``{"params", "config"}`` pickle of any width
    (``utils/jax_pickle.py``). Returns (model, config)."""
    if not path.endswith((".pt", ".pth")):
        payload = load_jax_pickle(path)
        model, config = waveglow_init(**payload["config"])
        model.load_state_dict(waveglow_from_jax(payload["params"], config),
                              strict=True)
        return model.to(device), config
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    folded = {}
    for name, value in sd.items():
        if name.endswith(".weight_g"):
            base = name[:-len(".weight_g")]
            v = sd[base + ".weight_v"]
            norm = v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
            folded[base + ".weight"] = value * v / norm
        elif not name.endswith(".weight_v"):
            folded[name] = value
    saved = ckpt.get("config") if isinstance(ckpt, dict) else None
    model, config = waveglow_init(**(saved or {}))
    model.load_state_dict(folded, strict=True)
    return model.to(device), config
