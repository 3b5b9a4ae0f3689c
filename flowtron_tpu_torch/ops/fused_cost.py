"""P5: K1 stripped to its dots, its LSTM cells or its attention (port of
the TPU probe scripts/exp_fused_cost.py: ``run`` and its bodies
``v_dots``, ``v_lstm``, ``v_attn``).

Each variant runs N steps of a recurrence over scratch h, h2 (B, H) and
prev (B, M) that start at zero, with bf16 weights in the scripts' (K, N)
layout, fp32 sums, latents z (N, B, M) fp32 and keys/values kv (B, Tk, D)
bf16, and returns mel (N, B, M) fp32 (csrc/fused_cost.cu spells out the
three recurrences). Every dot input is rounded to bf16 first. Where the
script slices a dot's output, the kernels still compute the whole product
(the probe measures what reading every weight of a K1 frame costs).

On CUDA tensors ``fused_cost`` launches csrc/fused_cost.cu (one host
call, K1's launch structure stripped down: per step one kernel per
dependent dot); on CPU tensors it runs ``fused_cost_reference``, the
plain PyTorch version on the same (K, N) weights.
"""

import ctypes

import torch
import torch.nn.functional as F

from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.ops._layout import interleave_gates

VARIANTS = ("dots", "lstm", "attn")


def weight_shapes(variant, M=80, H=1024, D=640):
    """The (K, N) weights of each variant, as exp_fused_cost.py builds
    them (v_lstm's output dot is 128 wide when M is not a multiple of
    128)."""
    if variant == "dots":
        return [(M, 4 * H), (H, 4 * H), (H, 4 * H), (H, 4 * H)]
    if variant == "lstm":
        return [(M, 4 * H), (H, 4 * H), (H, 4 * H), (H, 4 * H),
                (H, M if M % 128 == 0 else 128)]
    if variant == "attn":
        return [(M, D)]
    raise ValueError(f"variant {variant!r} not in {VARIANTS}")


def _bf16(t):
    return t.to(torch.bfloat16).float()


def fused_cost_reference(variant, z, kv, ws):
    """Plain PyTorch version of ``fused_cost``: the script's step, N times."""
    N, B, M = z.shape
    dev = z.device
    w = [x.float() for x in ws]
    prev = torch.zeros(B, M, device=dev)
    mel = []
    if variant == "attn":
        kvf = kv.float()
        for t in range(N):
            q = _bf16(prev) @ w[0]
            scores = torch.tanh(_bf16(_bf16(q)[:, None, :] + kvf)).sum(-1)
            scores = scores - scores.amax(-1, keepdim=True)
            e = torch.exp(scores)
            attn = e / e.sum(-1, keepdim=True)
            ctx = _bf16((_bf16(attn)[:, :, None] * kvf).sum(1))
            prev = ctx[:, :M] + z[t]
            mel.append(prev)
        return torch.stack(mel)
    H = w[1].shape[0]
    h = torch.zeros(B, H, device=dev)
    h2 = torch.zeros(B, H, device=dev)
    for t in range(N):
        if variant == "dots":
            a = (_bf16(prev) @ w[0])[:, :H] + (_bf16(h) @ w[1])[:, :H]
            h = torch.tanh(a)
            h2 = torch.tanh((_bf16(h) @ w[2])[:, :H])
            out = _bf16(h2) @ w[3]
        elif variant == "lstm":
            g1 = _bf16(prev) @ w[0] + _bf16(h) @ w[1]
            i, f, g, o = g1.split(H, dim=1)
            c = torch.sigmoid(f) * h + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            g2 = _bf16(h) @ w[2] + _bf16(h2) @ w[3]
            h2 = torch.sigmoid(g2[:, :H]) * torch.tanh(g2[:, H:2 * H])
            out = _bf16(h2) @ w[4]
        else:
            raise ValueError(f"variant {variant!r} not in {VARIANTS}")
        prev = out[:, :M] + z[t]
        mel.append(prev)
    return torch.stack(mel)


def _pad8(w):
    return F.pad(w, (0, -w.shape[1] % 8))


def _interleave(w):
    """(K, N) -> (N, P(K)) rows with row 4u + c = column c * N/4 + u."""
    return _pad8(interleave_gates(w.t()))


def _columns(w):
    """(K, N) -> (N, P(K)) rows in column order."""
    return _pad8(w.t())


@torch.no_grad()
def pack_weights(variant, ws):
    """The kernel's bf16 layout (documented at ``fused_cost_f32`` in
    csrc/fused_cost.cu): (wa, wb, wc), new storage; wb and wc are None
    for "attn"."""
    if variant == "attn":
        packed = [_columns(ws[0]), None, None]
    elif variant == "dots":
        packed = [torch.cat([_interleave(ws[0]), _interleave(ws[1])], 1),
                  _interleave(ws[2]), _columns(ws[3])]
    elif variant == "lstm":
        packed = [torch.cat([_interleave(ws[0]), _interleave(ws[1])], 1),
                  torch.cat([_interleave(ws[2]), _interleave(ws[3])], 1),
                  _columns(ws[4])]
    else:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    return tuple(None if w is None else w.to(torch.bfloat16).contiguous()
                 for w in packed)


def _lib():
    lib = _build.load_library("fused_cost")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_cost_f32.argtypes = [i, p, p, p, p, p, p, p] + [i] * 8 + [p]
        lib.fused_cost_f32.restype = i
        lib.fused_cost_workspace_floats.argtypes = [i, i, i, i]
        lib.fused_cost_workspace_floats.restype = ctypes.c_longlong
        lib.fused_cost_error_string.argtypes = [i]
        lib.fused_cost_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def fused_cost(variant, z, kv, ws, packed=None):
    """mel (N, B, M) fp32 of ``variant`` over latents z (N, B, M) fp32 and
    kv (B, Tk, D) bf16 with the (K, N) bf16 weights ``ws``. On CPU
    tensors this is ``fused_cost_reference``; on CUDA tensors it launches
    csrc/fused_cost.cu once, on ``packed`` (``pack_weights``) when given,
    or raises."""
    if z.device.type == "cpu":
        return fused_cost_reference(variant, z, kv, ws)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    dev = z.device
    N, B, M = z.shape
    _, Tk, D = kv.shape
    wa, wb, wc = packed if packed is not None else pack_weights(variant, ws)
    _build.check_tensor("z", z, (N, B, M), dev)
    _build.check_tensor("kv", kv, (B, Tk, D), dev, dtype=torch.bfloat16)
    for name, w in (("wa", wa), ("wb", wb), ("wc", wc)):
        if w is not None:
            _build.check_tensor(name, w, tuple(w.shape), dev,
                                dtype=torch.bfloat16)
    if variant == "attn":        # no recurrent state, one D-wide dot
        H, Nc = 0, D
    else:
        H, Nc = wa.shape[0] // 4, wc.shape[0]
    Ny = max(4 * H, Nc, D)
    lib = _lib()
    work = torch.zeros(int(lib.fused_cost_workspace_floats(B, H, D, Ny)),
                       device=dev)
    mel = torch.empty(N, B, M, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.fused_cost_f32(
        VARIANTS.index(variant), z.data_ptr(), kv.data_ptr(), ptr(wa),
        ptr(wb), ptr(wc), mel.data_ptr(), work.data_ptr(), N, B, M, H, D,
        Tk, Nc, Ny, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("fused_cost_f32 failed: "
                           + lib.fused_cost_error_string(err).decode())
    fused_cost.launches += 1
    setattr(fused_cost, f"launches_{variant}",
            getattr(fused_cost, f"launches_{variant}") + 1)
    return mel


# launches of any variant, and of each variant
fused_cost.launches = 0
fused_cost.launches_dots = 0
fused_cost.launches_lstm = 0
fused_cost.launches_attn = 0
