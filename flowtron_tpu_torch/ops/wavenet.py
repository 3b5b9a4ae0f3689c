"""K2: one fused WaveGlow WN layer (port of
flowtron_tpu/ops/wavenet_pallas.py:wn_layer_fused).

    acts = [x[t-d], x[t], x[t+d]] @ w_cat + b + cond   (zero outside [0, T))
    z    = tanh(acts[..., :C]) * sigmoid(acts[..., C:])
    rs   = z @ w_rs + b_rs
    x'   = x + rs[..., :C], zero on pad rows t >= T;  skip = rs[..., C:]

The last layer has ``w_rs`` of shape (C, C) and returns ``(None, rs)``.
Unlike the Pallas kernel, which takes three pre-shifted copies of x, this
takes x once and the dilation ``d``: the kernel does the shift itself.

On CUDA tensors ``wn_layer`` launches csrc/wavenet.cu (its note says what
bounds it and how the design answers); on CPU tensors it runs
``wn_layer_reference``.
"""

import ctypes

import torch
import torch.nn.functional as F

from flowtron_tpu_torch.ops import _build


def wn_layer_reference(x, d, cond, w_cat, b, w_rs, b_rs, T):
    """Plain PyTorch version of ``wn_layer`` (same arguments and outputs)."""
    C = x.shape[-1]
    Tp = x.shape[1]
    valid = (torch.arange(Tp, device=x.device) < T)[None, :, None]
    xv = torch.where(valid, x, 0.0)
    x_m = F.pad(xv, (0, 0, d, 0))[:, :Tp]            # x[t - d]
    x_p = F.pad(xv, (0, 0, 0, d))[:, d:]             # x[t + d]
    acts = torch.cat([x_m, xv, x_p], dim=-1) @ w_cat + b + cond
    z = torch.tanh(acts[..., :C]) * torch.sigmoid(acts[..., C:])
    rs = z @ w_rs + b_rs
    if w_rs.shape[1] == C:
        return None, rs
    return torch.where(valid, x + rs[..., :C], 0.0), rs[..., C:]


def _lib():
    lib = _build.load_library("wavenet")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wn_layer_f32.argtypes = [p, i, p, i, p, p, p, p, p, p,
                                     i, i, i, i, i, p]
        lib.wn_layer_f32.restype = i
        lib.wavenet_error_string.argtypes = [i]
        lib.wavenet_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T):
    """One WN layer.

    Args:
      x: (B, Tp, C) activations, Tp >= T (rows t >= T are padding).
      d: dilation. cond: (B, Tp, 2C), last dim contiguous; may be a slice
        of the all-layer conditioning tensor.
      w_cat: (3C, 2C) conv taps [w[:,:,0].T; w[:,:,1].T; w[:,:,2].T];
        b: (2C,). w_rs: (C, 2C), or (C, C) on the last layer; b_rs to match.
      T: valid time steps.

    Returns (x_new (B, Tp, C) or None on the last layer, skip (B, Tp, C)).
    """
    if x.device.type == "cpu":
        return wn_layer_reference(x, d, cond, w_cat, b, w_rs, b_rs, T)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    dev = x.device
    B, Tp, C = x.shape
    n_rs = w_rs.shape[1]
    last = n_rs == C
    if C % 64 or 1024 % C:
        raise ValueError(f"the kernel takes C a multiple of 64 dividing "
                         f"1024, got {C}")
    if not 0 < T <= Tp:
        raise ValueError(f"T={T} outside (0, {Tp}]")
    _build.check_tensor("x", x, (B, Tp, C), dev)
    _build.check_tensor("cond", cond, (B, Tp, 2 * C), dev,
                        contiguous=False)
    ldc = cond.stride(1)
    if cond.stride(2) != 1 or cond.stride(0) != Tp * ldc or ldc % 4:
        raise ValueError("cond must be a row-major (B, Tp, 2C) slice with a "
                         "row stride that is a multiple of 4")
    _build.check_tensor("w_cat", w_cat, (3 * C, 2 * C), dev)
    _build.check_tensor("b", b, (2 * C,), dev)
    if n_rs not in (C, 2 * C):
        raise ValueError(f"w_rs has {n_rs} columns, expected {C} or {2 * C}")
    _build.check_tensor("w_rs", w_rs, (C, n_rs), dev)
    _build.check_tensor("b_rs", b_rs, (n_rs,), dev)

    lib = _lib()
    x_new = None if last else torch.empty_like(x)
    skip = torch.empty(B, Tp, C, device=dev)
    err = lib.wn_layer_f32(
        x.data_ptr(), int(d), cond.data_ptr(), ldc, w_cat.data_ptr(),
        b.data_ptr(), w_rs.data_ptr(), b_rs.data_ptr(),
        None if last else x_new.data_ptr(), skip.data_ptr(), B, Tp, int(T),
        C, int(last), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("wn_layer_f32 failed: "
                           + lib.wavenet_error_string(err).decode())
    wn_layer.launches += 1
    return x_new, skip


wn_layer.launches = 0
