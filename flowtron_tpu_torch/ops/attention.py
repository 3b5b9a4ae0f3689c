"""K3: additive-attention scores with a hand-written backward (port of
flowtron_tpu/ops/attention_pallas.py: ``attention_scores_pallas``, the
custom VJP ``attention_scores`` and its backward ``_scores_bwd``).

    s[b, q, t] = sum_d v[d] * tanh(Q[b, q, d] + K[b, t, d]) / temperature

without a (B, Tq, Tk, D) tensor in device memory. ``attention_scores`` is
a ``torch.autograd.Function``: its forward is ``attention_scores_fwd`` and
its backward ``attention_scores_bwd``. On CUDA tensors each launches its
kernel in csrc/attention.cu, fp32 or bf16 in with fp32 accumulation, or
raises. Its note says what bounds it and how the design answers: one
reciprocal an element, through tanh(a + b) = 1 - 2 / (1 + exp(2a)
exp(2b)), accurate tanhf where a staged |x| > 20, and one fused backward
pass. On CPU tensors each runs its plain PyTorch version,
``attention_scores_reference`` (the ``attention_scores_xla`` math) and
``attention_scores_backward_reference`` (the Tq-chunked ``_scores_bwd``
math). ``temperature`` is a plain float and gets no gradient, as
``nondiff_argnums=(3,)`` in the JAX package.
"""

import ctypes

import torch

from flowtron_tpu_torch.ops import _build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def attention_scores_reference(q, k, v_w, temperature=1.0):
    """Plain version of the forward: q (B, Tq, D), k (B, Tk, D), v_w (D,)
    -> (B, Tq, Tk), in the inputs' dtype."""
    scores = torch.einsum(
        "bqkd,d->bqk", torch.tanh(q[:, :, None, :] + k[:, None, :, :]), v_w)
    return scores / temperature


def attention_scores_backward_reference(q, k, v_w, ds, temperature=1.0):
    """Plain version of the backward: (dq, dk, dv) for the output gradient
    ``ds`` (B, Tq, Tk), accumulated in fp32 (fp64 for fp64 inputs) over Tq
    chunks that bound the (B, chunk, Tk, D) intermediate to ~256 MB, as
    ``_scores_bwd``; each gradient is returned in its input's dtype."""
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qa, ka, va = q.to(acc), k.to(acc), v_w.to(acc)
    dsa = ds.to(acc) / temperature
    B, Tq, D = q.shape
    Tk = k.shape[1]
    cq = max(1, int(64 * 1024 * 1024 / max(1, B * Tk * D)))
    dq = torch.empty_like(qa)
    dk = torch.zeros_like(ka)
    dv = torch.zeros_like(va)
    for s in range(0, Tq, cq):
        th = torch.tanh(qa[:, s:s + cq, None, :] + ka[:, None, :, :])
        sech2_v = (1.0 - th * th) * va
        dsc = dsa[:, s:s + cq]
        dq[:, s:s + cq] = torch.einsum("bqt,bqtd->bqd", dsc, sech2_v)
        dk += torch.einsum("bqt,bqtd->btd", dsc, sech2_v)
        dv += torch.einsum("bqt,bqtd->d", dsc, th)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v_w.dtype)


def _lib():
    lib = _build.load_library("attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attention_scores_fwd.argtypes = [p] * 4 + [i] * 4 + [f, i, p]
        lib.attention_scores_fwd.restype = i
        lib.attention_scores_bwd.argtypes = [p] * 8 + [i] * 4 + [f, i, p]
        lib.attention_scores_bwd.restype = i
        lib.attention_bwd_workspace_floats.argtypes = [i, i, i, i]
        lib.attention_bwd_workspace_floats.restype = ctypes.c_longlong
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(q, k, v_w, ds=None):
    """Raise unless the tensors are what the kernel takes; returns
    (B, Tq, Tk, D)."""
    dev, dtype = q.device, q.dtype
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"q is {dtype}; the attention kernel takes "
                        "float32 or bfloat16")
    if q.dim() != 3 or k.dim() != 3 or min(q.shape) == 0 or k.shape[1] == 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         "be non-empty (B, T, D) tensors")
    B, Tq, D = q.shape
    Tk = k.shape[1]
    align = q.element_size()
    _build.check_tensor("q", q, (B, Tq, D), dev, dtype=dtype, align=align)
    _build.check_tensor("k", k, (B, Tk, D), dev, dtype=dtype, align=align)
    _build.check_tensor("v_w", v_w, (D,), dev, dtype=dtype, align=align)
    if ds is not None:
        _build.check_tensor("ds", ds, (B, Tq, Tk), dev, dtype=dtype,
                            align=align)
    return B, Tq, Tk, D


def attention_scores_fwd(q, k, v_w, temperature=1.0):
    """Scores (B, Tq, Tk) in q's dtype. CPU tensors run
    ``attention_scores_reference``; CUDA tensors launch the forward kernel
    (contiguous, one dtype of float32 / bfloat16) or raise."""
    if q.device.type == "cpu":
        return attention_scores_reference(q, k, v_w, temperature)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Tq, Tk, D = _check(q, k, v_w)
    lib = _lib()
    out = torch.empty(B, Tq, Tk, device=q.device, dtype=q.dtype)
    err = lib.attention_scores_fwd(
        q.data_ptr(), k.data_ptr(), v_w.data_ptr(), out.data_ptr(), B, Tq,
        Tk, D, float(temperature), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("attention_scores_fwd failed: "
                           + lib.attention_error_string(err).decode())
    attention_scores_fwd.launches += 1
    return out


def attention_scores_bwd(q, k, v_w, ds, temperature=1.0):
    """(dq, dk, dv) for the scores' gradient ``ds``, each in its input's
    dtype. CPU tensors run ``attention_scores_backward_reference``; CUDA
    tensors launch the fused backward kernel (deterministic: no float
    atomics) or raise."""
    if q.device.type == "cpu":
        return attention_scores_backward_reference(q, k, v_w, ds,
                                                   temperature)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    B, Tq, Tk, D = _check(q, k, v_w, ds)
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v_w)
    # the launch zeroes the few words of it that must start at 0
    work = torch.empty(lib.attention_bwd_workspace_floats(B, Tq, Tk, D),
                       device=q.device, dtype=torch.float32)
    err = lib.attention_scores_bwd(
        q.data_ptr(), k.data_ptr(), v_w.data_ptr(), ds.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), B, Tq,
        Tk, D, float(temperature), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("attention_scores_bwd failed: "
                           + lib.attention_error_string(err).decode())
    attention_scores_bwd.launches += 1
    return dq, dk, dv


attention_scores_fwd.launches = 0
attention_scores_bwd.launches = 0


class _AttentionScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v_w, temperature):
        q, k, v_w = q.contiguous(), k.contiguous(), v_w.contiguous()
        ctx.save_for_backward(q, k, v_w)
        ctx.temperature = temperature
        return attention_scores_fwd(q, k, v_w, temperature)

    @staticmethod
    def backward(ctx, ds):
        q, k, v_w = ctx.saved_tensors
        dq, dk, dv = attention_scores_bwd(q, k, v_w, ds.contiguous(),
                                          ctx.temperature)
        return dq, dk, dv, None


def attention_scores(q, k, v_w, temperature=1.0):
    """Differentiable scores: q (B, Tq, D), k (B, Tk, D), v_w (D,) ->
    (B, Tq, Tk). ``temperature`` is a float and gets no gradient."""
    return _AttentionScores.apply(q, k, v_w, float(temperature))
