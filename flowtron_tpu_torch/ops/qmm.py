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
what bounds it and how the design answers), tiled as ``qmm_plan`` says;
the output takes x's dtype: fp32 from fp32 x, bf16 from bf16 x (the body
the Pallas kernel runs under the JAX server's ``--bf16``, whose callers
all pass ``out_dtype=x.dtype``). W8A8 is two launches, a quantize launch
into scratch, then the product. On CPU tensors it runs
``quantized_matmul_reference``, which also takes the Pallas signature's
``out_dtype``.
N need not be a multiple of 128: that rule of the Pallas kernel is a TPU
tiling constraint, and routing (``utils/weights.py:qdot``) follows the
JAX package's, never the shape.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from flowtron_tpu_torch.ops import _build

INV_127 = 1.0 / 127.0   # rounded to fp32 where it meets an fp32 tensor

# csrc/qmm.cu's tiling: output columns a warp (the mma's m), rows of x a
# tile (its n), k a stretch (a quad of lanes' four 16-byte loads),
# stretches a lane keeps in flight, warps a block (half of it with 4 or 8
# row tiles a warp, for their registers), row tiles a warp at most, the
# SMs of an H100 SXM, and the shared memory a block's staged x may take
TILE_N, TILE_M, STRETCH, GROUP = 16, 8, 64, 4
MAX_WARPS, MAX_ROW_TILES, H100_SMS = 16, 8, 132
STAGE_BYTES = 224 * 1024
# the dynamic shared memory a block may take beside its staged scales
# (csrc/qmm.cu:kMaxSmem)
SMEM_LIMIT = 227 * 1024 - 4 * (MAX_WARPS * TILE_N + MAX_ROW_TILES * TILE_M)

QmmPlan = namedtuple("QmmPlan", "ct ks mt grid threads smem")
QmmPlan.__doc__ = """csrc/qmm.cu's launch: ``ct`` column tiles of 16 a
block, ``ks`` warps splitting K a column tile (warp w takes tile w % ct
and part w // ct: stretches p * S // ks up to (p + 1) * S // ks of the
S = ceil(K / 64)), ``mt`` row tiles of 8 a warp; ``grid`` (column
blocks, row blocks), ``threads`` a block, ``smem`` bytes a block."""


def qmm_padded_k(K):
    """K rounded up to a whole stretch: the int8 scratch row of W8A8."""
    return -(-K // STRETCH) * STRETCH


def qmm_smem_bytes(K, a8, ct, ks, mt, bf16=False):
    """Shared memory of a block (csrc/qmm.cu:qmm_smem_bytes): the larger
    of its staged rows of x (the tf32 hi and lo pieces of fp32 x, bf16 x
    rows padded by 16 bytes, or W8A8's int8 rows padded to an odd multiple
    of 64 bytes) and its K parts' partial sums."""
    Kp, rows = qmm_padded_k(K), mt * TILE_M
    if a8:
        stage = rows * (Kp + (0 if Kp % 128 == 64 else 64))
    else:
        stage = rows * (2 * Kp + 16 if bf16 else 8 * Kp)
    return max(stage, ks * ct * mt * 4 * 32 * 4 if ks > 1 else 0)


@functools.lru_cache(maxsize=256)
def qmm_plan(M, K, N, sms=None, a8=False, bf16=False):
    """Tile (M, K) x (N, K)^T for csrc/qmm.cu on a card of ``sms`` SMs
    (None: an H100's 132). Row tiles a warp: as many as M needs, up to 8,
    a power of two, halved while the staged x passes STAGE_BYTES. K parts:
    the fewest, a power of two, that leave each warp at most one group of
    loads in flight. Column tiles a block: the most whose blocks still
    give 7 in 8 SMs one, and at least enough for 4 warps a block. Where
    even one column tile a block leaves SMs idle, K is split further,
    down to two stretches a warp. ``bf16``: x is bf16 (weight-only's
    staged rows are a quarter of fp32's tf32 pieces; W8A8's are int8
    either way). Returns a QmmPlan; raises ValueError for shapes the kernel
    does not take."""
    if min(M, K, N) < 1:
        raise ValueError(f"M, K, N ({M}, {K}, {N}) must be positive")
    sms = sms or H100_SMS
    S, tiles = qmm_padded_k(K) // STRETCH, -(-N // TILE_N)
    mt = 1
    while mt < min(MAX_ROW_TILES, -(-M // TILE_M)):
        mt *= 2
    bf16 = bool(bf16) and not a8
    while mt > 1 and qmm_smem_bytes(K, a8, 1, 1, mt, bf16) > STAGE_BYTES:
        mt //= 2
    if qmm_smem_bytes(K, a8, 1, 1, mt, bf16) > STAGE_BYTES:
        raise ValueError(f"K ({K}) too large: 8 staged rows of x take more "
                         f"than {STAGE_BYTES} bytes of shared memory")
    warps = MAX_WARPS // 2 if mt >= 4 else MAX_WARPS
    rows = -(-M // (mt * TILE_M))
    ks = 1
    while ks < warps and -(-S // ks) > GROUP:
        ks *= 2
    ks = min(ks, S)
    ct = 1
    while 2 * ct * ks <= warps and 2 * ct <= tiles and (
            -(-tiles // (2 * ct)) * rows * 8 >= 7 * sms or ct * ks < 4):
        ct *= 2
    if ct == 1:
        while 2 * ks <= min(warps, S // 2) and tiles * rows < sms:
            ks *= 2
    return QmmPlan(ct, ks, mt, (-(-tiles // ct), rows), 32 * ct * ks,
                   qmm_smem_bytes(K, a8, ct, ks, mt, bf16))


def quantized_matmul_reference(x, q, s, out_dtype=None, a8=False):
    """Plain PyTorch version of ``quantized_matmul`` (same arguments and
    output). The W8A8 sum is formed exactly in float64 and rounded to fp32
    once, as ``acc.astype(float32)`` rounds the int32 sum (|acc| can pass
    2**24). A bf16 x is taken as fp32 (exactly), and the fp32 result is
    rounded to ``out_dtype`` once, as both Pallas bodies cast."""
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
        lib.qmm_launch.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i,
                                   i, p]
        lib.qmm_launch.restype = i
        lib.qmm_error_string.argtypes = [i]
        lib.qmm_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


_sms = {}


def _sm_count(dev):
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev.index]


def quantized_matmul(x, q, s, a8=False):
    """(M, K) x, (N, K) int8 q, (N,) fp32 s -> (M, N) in x's dtype. On CPU
    tensors this is ``quantized_matmul_reference``; on CUDA tensors it
    launches csrc/qmm.cu (fp32 or bf16 x) or raises."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, q, s, a8=a8)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {x.dtype}; the kernel takes torch.float32 "
                        "or torch.bfloat16")
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    M, K = x.shape
    N = q.shape[0]
    _build.check_tensor("x", x, (M, K), dev, dtype=x.dtype)
    _build.check_tensor("q", q, (N, K), dev, dtype=torch.int8)
    _build.check_tensor("s", s, (N,), dev)
    lib = _lib()
    plan = qmm_plan(M, K, N, _sm_count(dev), bool(a8), bf16)
    out = torch.empty(M, N, device=dev, dtype=x.dtype)
    xq = sx = None
    if a8:
        xq = torch.empty(M, qmm_padded_k(K), dtype=torch.int8, device=dev)
        sx = torch.empty(M, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    xq_p = None if xq is None else xq.data_ptr()
    sx_p = None if sx is None else sx.data_ptr()
    err = lib.qmm_launch(x.data_ptr(), int(bf16), q.data_ptr(),
                         s.data_ptr(), out.data_ptr(), xq_p, sx_p, M, K, N,
                         int(bool(a8)), plan.ct, plan.ks, plan.mt, stream)
    if err:
        raise RuntimeError(f"qmm_launch failed at M={M} K={K} N={N}, "
                           f"{plan}: " + lib.qmm_error_string(err).decode())
    quantized_matmul.launches += 1
    if a8:
        quantized_matmul.launches_w8a8 += 1
    if bf16:
        quantized_matmul.launches_bf16 += 1
        if a8:
            quantized_matmul.launches_w8a8_bf16 += 1
    return out


# launches of either body, of the W8A8 body alone, of the bf16 bodies (bf16
# x, either mode) alone, and of the bf16 W8A8 body alone
quantized_matmul.launches = 0
quantized_matmul.launches_w8a8 = 0
quantized_matmul.launches_bf16 = 0
quantized_matmul.launches_w8a8_bf16 = 0
