"""K4: the quantized matmul of the serving modes (port of
flowtron_tpu/ops/qmm_pallas.py:quantized_matmul and its bodies
``_qmm_kernel`` and ``_qmm_w8a8_kernel``).

    weight-only (a8=False): out = (x @ float(q).T) * s
    W8A8 (a8=True):         sx  = max|x_row| * fp32(1/127), 1 where 0
                            xq  = clip(round_half_even(x / sx), -127, 127)
                            acc = xq @ q.T, exact integers
                            out = (float32(acc) * sx) * s

``q`` is (N, K) int8 in torch's (out, in) layout (the Pallas kernel takes
(K, N)), ``s`` (N,) fp32 per-output-channel scales, ``x`` (M, K).

The Pallas body writes ``max|x| / 127.0``, but XLA folds a division by a
constant into a multiply by its fp32 reciprocal, so the compiled kernel
computes ``max|x| * fp32(1/127)``, which differs from the true quotient
in the last bit for some rows. The port computes what the JAX package
runs, so its W8A8 output is the JAX kernel's to the bit. ``x / sx`` is
a true division in both (sx is not a constant).

On CUDA tensors ``quantized_matmul`` launches csrc/qmm.cu (its note says
what bounds it and how the design answers), fp32 only; on CPU tensors it
runs ``quantized_matmul_reference``. N need not be a multiple of 128:
that rule of the Pallas kernel is a TPU tiling constraint, and routing
(``utils/weights.py:qdot``) follows the JAX package's, never the shape.
"""

import ctypes

import torch

from flowtron_tpu_torch.ops import _build

INV_127 = 1.0 / 127.0   # rounded to fp32 where it meets an fp32 tensor


def quantized_matmul_reference(x, q, s, out_dtype=None, a8=False):
    """Plain PyTorch version of ``quantized_matmul`` (same arguments and
    output). The W8A8 sum is formed exactly in float64 and rounded to fp32
    once, as ``acc.astype(float32)`` rounds the int32 sum (|acc| can pass
    2**24)."""
    out_dtype = out_dtype or x.dtype
    x = x.float()
    if not a8:
        return ((x @ q.float().t()) * s).to(out_dtype)
    sx = x.abs().amax(dim=1, keepdim=True) * INV_127
    sx = torch.where(sx == 0.0, torch.ones_like(sx), sx)
    xq = torch.clamp(torch.round(x / sx), -127.0, 127.0)
    acc = (xq.double() @ q.double().t()).float()
    return (acc * sx * s).to(out_dtype)


def _lib():
    lib = _build.load_library("qmm")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qmm_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.qmm_f32.restype = i
        lib.qmm_padded_k.argtypes = [i]
        lib.qmm_padded_k.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def quantized_matmul(x, q, s, out_dtype=None, a8=False):
    """(M, K) x, (N, K) int8 q, (N,) fp32 s -> (M, N) in ``out_dtype``
    (default x's dtype). On CPU tensors this is
    ``quantized_matmul_reference``; on CUDA tensors it launches
    csrc/qmm.cu (fp32 in and out) or raises."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, q, s, out_dtype, a8)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if out_dtype not in (None, torch.float32):
        raise TypeError(f"the kernel writes fp32, not {out_dtype}; see "
                        "ROADMAP.md Queue 1, deferred item 3 (bf16 kernels)")
    dev = x.device
    M, K = x.shape
    N = q.shape[0]
    _build.check_tensor("x", x, (M, K), dev)
    _build.check_tensor("q", q, (N, K), dev, dtype=torch.int8)
    _build.check_tensor("s", s, (N,), dev)
    lib = _lib()
    out = torch.empty(M, N, device=dev)
    xq = sx = None
    if a8:
        xq = torch.empty(M, lib.qmm_padded_k(K), dtype=torch.int8,
                         device=dev)
        sx = torch.empty(M, device=dev)
    err = lib.qmm_f32(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                      out.data_ptr(), None if xq is None else xq.data_ptr(),
                      None if sx is None else sx.data_ptr(), M, K, N,
                      int(bool(a8)), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("qmm_f32 failed: "
                           + lib.qmm_error_string(err).decode())
    quantized_matmul.launches += 1
    if a8:
        quantized_matmul.launches_w8a8 += 1
    return out


# launches of either body, and of the W8A8 body alone
quantized_matmul.launches = 0
quantized_matmul.launches_w8a8 = 0
