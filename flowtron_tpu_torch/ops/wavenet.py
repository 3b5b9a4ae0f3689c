"""K2: one fused WaveGlow WN layer (port of
flowtron_tpu/ops/wavenet_pallas.py:wn_layer_fused).

    acts = [x[t-d], x[t], x[t+d]] @ w_cat + b + cond   (zero outside [0, T))
    z    = tanh(acts[..., :C]) * sigmoid(acts[..., C:])
    rs   = z @ w_rs + b_rs
    x'   = x + rs[..., :C], zero on pad rows t >= T;  skip = rs[..., C:]

The last layer has ``w_rs`` of shape (C, C) and returns ``(None, rs)``.
Unlike the Pallas kernel, which takes three pre-shifted copies of x, this
takes x once and the dilation ``d``: the kernel does the shift itself.

On CUDA tensors ``wn_layer`` launches csrc/wavenet.cu through
``wn_layer_launch``. For fp32 tensors it runs the fp32 body (the note of
csrc/wavenet.cu says what bounds it and how the design answers), tiled
as ``wn_plan`` says, the weights split into bf16 hi/lo by
``wn_split_weights``. For bf16 tensors (the body the Pallas kernel runs
under the JAX server's ``--bf16``) it runs the bf16 body of
csrc/wavenet_bf16.cuh: a producer warp feeding TMA tiles through a ring
to ``wgmma`` warpgroups, tiled as ``wn_bf16_plan`` says, the weights
transposed by ``wn_pack_weights`` into the K-major layout its tensor maps
read. Either pack is made once a layer and cached until a weight
changes. On CPU tensors it runs ``wn_layer_reference``.

bf16 follows the Pallas body's dtypes (wavenet_pallas.py:33-54): products
of bf16 operands summed in fp32, the gate in fp32 and z rounded to bf16
before the res/skip product, x' = x + rs in fp32 rounded to bf16, skip
rounded to bf16. The kernel's gate uses tanh.approx (sigmoid(a) = 0.5
tanh(a / 2) + 0.5), whose error lies under z's bf16 rounding.
"""

import ctypes
import functools
import threading
from collections import namedtuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from flowtron_tpu_torch.ops import _build

# csrc/wavenet.cu's builds: {C: {rows a block: column passes}}, its k rows
# a chunk, the SMs of an H100 SXM and a block's shared memory
WN_BUILDS = {64: {64: 1}, 128: {64: 1}, 256: {64: 1, 112: 2},
             512: {64: 4, 32: 2}, 1024: {32: 8}}
KC, H100_SMS, SMEM_LIMIT = 16, 132, 232448
# a row's time in a full wave of each (C, rows a block) build, relative to
# the first build of its width, measured on an H100 (chip_smoke.py's
# k2_bm line: a layer's ms over its waves times its rows a block). A pass
# more stages x again; fewer rows a block read the weights from L2 for
# fewer rows.
WN_ROW_COST = {(64, 64): 1.0, (128, 64): 1.0, (256, 64): 1.0,
               (256, 112): 1.09, (512, 64): 1.0, (512, 32): 0.95,
               (1024, 32): 1.0}

WnPlan = namedtuple("WnPlan", "bm nh stages smem grid")
WnPlan.__doc__ = """csrc/wavenet.cu's fp32 launch: ``bm`` rows a block of
256 threads, the acts columns walked in ``nh`` passes, a ring of
``stages`` chunks, ``smem`` bytes a block, ``grid`` blocks."""


def wn_smem_bytes(C, bm, nh, stages):
    """csrc/wavenet.cu:smem_bytes: the weight ring, and the x ring and the
    two A tiles beside z (one pass: z overlays them)."""
    slot = KC * (2 * C // nh) * 2 * 2
    x_bytes = stages * bm * KC * 4 + 4 * bm * KC * 2
    z_bytes = 2 * bm * C * 2
    return stages * slot + (max(z_bytes, x_bytes) if nh == 1
                            else z_bytes + x_bytes)


def wn_plan(B, Tp, C, sms=None, bm=None):
    """Tile B * Tp rows of width C for csrc/wavenet.cu's fp32 body on a
    card of ``sms`` SMs (None: an H100's 132), one block a SM. ``bm``
    (rows a block) is one of the builds for C; by default the one whose
    busiest SM takes the least time, ceil(blocks / sms) * bm rows at the
    build's measured ``WN_ROW_COST``, the larger on a tie: at C = 256, 112
    rows at B=1 (one wave of 115 blocks) and 64 at B=8. Returns a WnPlan;
    raises ValueError for a shape the kernel does not take."""
    if C not in WN_BUILDS:
        raise ValueError(f"the kernel takes C in {sorted(WN_BUILDS)}, "
                         f"got {C}")
    if B < 1 or Tp < 1:
        raise ValueError(f"B and Tp ({B}, {Tp}) must be positive")
    sms = sms or H100_SMS
    M = B * Tp
    builds = WN_BUILDS[C]
    if bm is None:
        bm = min(builds, key=lambda r: (
            -(-(-(-M // r)) // sms) * r * WN_ROW_COST[(C, r)], -r))
    elif bm not in builds:
        raise ValueError(f"bm={bm} not built for C={C}: {sorted(builds)}")
    nh = builds[bm]
    stages = 4 if wn_smem_bytes(C, bm, nh, 4) <= SMEM_LIMIT else 3
    return WnPlan(bm, nh, stages, wn_smem_bytes(C, bm, nh, stages),
                  -(-M // bm))


# csrc/wavenet_bf16.cuh's builds: {C: {rows a tile: (acts columns a
# pass, ring slots)}}. A tile is 64 rows a consumer warpgroup; a pass is
# N1 packed acts columns (N1 / 2 channels, tanh and sigmoid) and N1 rs
# columns, wgmma's n; K is walked 64 rows a slot.
WN_BF16_BUILDS = {64: {128: (128, 4)}, 128: {128: (256, 4)},
                  256: {128: (256, 3), 64: (256, 4)},
                  512: {64: (256, 4)}, 1024: {64: (128, 4)}}
WN_BF16_KS = 64            # k rows a ring slot (a 128-byte swizzled row)
# a tile's time relative to the width's first build, measured on an H100
# (chip_smoke.py's k2_bf16 line of layer 3 at B=1, builds_ms: a build's
# ms over its tiles a block; 0.58 at B=8); a width's one build costs 1
WN_BF16_TILE_COST = {(256, 128): 1.0, (256, 64): 0.62}

WnBf16Plan = namedtuple("WnBf16Plan", "bm n1 nh stages smem tiles grid")
WnBf16Plan.__doc__ = """csrc/wavenet_bf16.cuh's launch: tiles of ``bm``
rows of one stream (``bm / 64`` consumer warpgroups and a producer
warpgroup a block), ``n1`` acts columns a pass in ``nh`` passes, a ring
of ``stages`` slots, ``smem`` bytes a block, ``tiles`` = B ceil(Tp / bm)
walked by ``grid`` = min(tiles, SMs) persistent blocks (measured on an
H100 against one block a tile: level at B=1, 4% faster at B=8, PERF.md
§6)."""


def wn_bf16_smem_bytes(C, bm, n1, stages):
    """csrc/wavenet_bf16.cuh:Cfg::SMEM: 1024 bytes to align the ring to
    the swizzle's 1024, ``stages`` slots of an x box (bm rows of 128
    bytes) and a weight box (n1 rows of 128 bytes), z (C / 64 boxes of bm
    rows), and a full and an empty barrier a slot."""
    return (1024 + stages * (bm + n1) * 128 + C // WN_BF16_KS * bm * 128
            + 2 * 8 * stages)


def wn_bf16_plan(B, Tp, C, sms=None, bm=None):
    """Tile B streams of Tp rows, width C, for the bf16 body on a card of
    ``sms`` SMs (None: an H100's 132): tiles of ``bm`` rows never cross a
    stream. ``bm`` is a build of ``WN_BF16_BUILDS[C]``; by default the one
    whose busiest SM finishes first, ceil(tiles / sms) tiles at the
    build's measured ``WN_BF16_TILE_COST``, the larger on a tie: at C =
    256, 128 rows at 400 frames (100 tiles at B=1, 800 at B=8) and 64 at
    a stream window of 2560 rows (40 tiles, not 20 on 132 SMs). Returns a
    WnBf16Plan; raises ValueError for a shape the kernel does not
    take."""
    if C not in WN_BF16_BUILDS:
        raise ValueError(f"the kernel takes C in {sorted(WN_BF16_BUILDS)}, "
                         f"got {C}")
    if B < 1 or Tp < 1:
        raise ValueError(f"B and Tp ({B}, {Tp}) must be positive")
    builds = WN_BF16_BUILDS[C]
    sms = sms or H100_SMS
    if bm is None:
        bm = min(builds, key=lambda r: (
            -(-B * -(-Tp // r) // sms) * WN_BF16_TILE_COST.get((C, r), 1.0),
            -r))
    elif bm not in builds:
        raise ValueError(f"bm={bm} not built for C={C}: {sorted(builds)}")
    n1, stages = builds[bm]
    tiles = B * -(-Tp // bm)
    return WnBf16Plan(bm, n1, 2 * C // n1, stages,
                      wn_bf16_smem_bytes(C, bm, n1, stages), tiles,
                      min(tiles, sms))


def _split_bf16(w):
    hi = w.to(torch.bfloat16)
    return hi, (w - hi.float()).to(torch.bfloat16)


def _paired(w_cat):
    """w_cat's columns paired per 8 channels ([tanh 8 | sigmoid 8], so
    packed column 16 q + 8 s + e is column s * C + 8 q + e)."""
    C = w_cat.shape[1] // 2
    perm = torch.arange(2 * C, device=w_cat.device).view(2, C // 8, 8) \
        .transpose(0, 1).reshape(-1)
    return w_cat[:, perm]


def _pass_views(w_cat, w_rs, nh):
    """``_paired(w_cat)`` cut into ``nh`` passes, (nh, 3C, 2C / nh); w_rs
    cut into np2 passes, (np2, C, n_rs / np2), np2 = nh, or max(1, nh //
    2) on the last layer."""
    C = w_cat.shape[1] // 2
    n_rs = w_rs.shape[1]
    np2 = max(1, nh // 2) if n_rs == C else nh
    w1 = _paired(w_cat).view(3 * C, nh, 2 * C // nh).transpose(0, 1)
    w2 = w_rs.view(C, np2, n_rs // np2).transpose(0, 1)
    return w1, w2


def wn_pack_weights(w_cat, w_rs):
    """The bf16 body's packs, K-major as its tensor maps read them: w1 =
    ``_paired(w_cat)``.T (2C, 3C) (row n, packed column n, holds its 3C
    taps' weights; pass h of N1 columns is rows h N1 .. h N1 + N1 - 1) and
    w2 = w_rs.T (n_rs, C), contiguous bf16."""
    return (_paired(w_cat).t().to(torch.bfloat16).contiguous(),
            w_rs.t().to(torch.bfloat16).contiguous())


def wn_split_weights(w_cat, w_rs, nh):
    """The kernel's bf16 hi/lo packs of a layer's weights for ``nh``
    column passes: w1 (nh, 3C, 2, 2C / nh) from w_cat with its columns
    paired per 8 channels ([tanh 8 | sigmoid 8], so packed column
    16 q + 8 s + e is column s * C + 8 q + e), pass h the packed columns
    h * 2C / nh on; w2 (np2, C, 2, n_rs / np2) from w_rs, np2 = nh, or
    max(1, nh // 2) on the last layer. [..., 0, :] is hi = bf16(w),
    [..., 1, :] lo = bf16(w - hi)."""
    return tuple(torch.stack(_split_bf16(w), dim=2).contiguous()
                 for w in _pass_views(w_cat, w_rs, nh))


# w_cat -> {nh: (w_rs, versions, w1, w2)}: a layer's packs (split for
# fp32 weights, nh passes; transposed for bf16 ones, one pack, nh = 0),
# made once and made again when a weight changes (its _version moves);
# the lock, because the server's dispatcher and stream threads vocode
# side by side
_SPLITS = WeakIdKeyDictionary()
_SPLITS_LOCK = threading.Lock()


def _packed(w_cat, w_rs, nh):
    versions = (w_cat._version, w_rs._version)
    with _SPLITS_LOCK:
        per_nh = _SPLITS.setdefault(w_cat, {})
        hit = per_nh.get(nh)
        if hit is None or hit[0] is not w_rs or hit[1] != versions:
            with torch.no_grad():
                hit = (w_rs, versions) + (
                    wn_pack_weights(w_cat, w_rs) if nh == 0
                    else wn_split_weights(w_cat, w_rs, nh))
            per_nh[nh] = hit
    return hit[2], hit[3]


def wn_layer_reference(x, d, cond, w_cat, b, w_rs, b_rs, T):
    """Plain PyTorch version of ``wn_layer`` (same arguments and outputs).
    bf16 tensors: the bf16 operands' products summed in fp32, z rounded
    to bf16 before the res/skip product, the outputs rounded once."""
    C = x.shape[-1]
    Tp = x.shape[1]
    dt = x.dtype
    f32 = (lambda t: t.float()) if dt == torch.bfloat16 else (lambda t: t)
    valid = (torch.arange(Tp, device=x.device) < T)[None, :, None]
    xv = torch.where(valid, x, 0.0)
    x_m = F.pad(xv, (0, 0, d, 0))[:, :Tp]            # x[t - d]
    x_p = F.pad(xv, (0, 0, 0, d))[:, d:]             # x[t + d]
    acts = f32(torch.cat([x_m, xv, x_p], dim=-1)) @ f32(w_cat) + f32(b) \
        + f32(cond)
    z = torch.tanh(acts[..., :C]) * torch.sigmoid(acts[..., C:])
    rs = f32(z.to(dt)) @ f32(w_rs) + f32(b_rs)
    if w_rs.shape[1] == C:
        return None, rs.to(dt)
    return (torch.where(valid, f32(x) + rs[..., :C], 0.0).to(dt),
            rs[..., C:].to(dt))


def wn_cond_stride(cond, bf16):
    """cond's row stride ldc (elements), after checking that cond (B, Tp,
    2C) is a row-major slice the kernel reads: a multiple of 4 for the
    fp32 body, of 8 for the bf16 body (TMA's 16-byte strides). Raises
    ValueError otherwise."""
    ldc = cond.stride(1)
    if cond.stride(2) != 1 or cond.stride(0) != cond.shape[1] * ldc \
            or ldc % 4:
        raise ValueError("cond must be a row-major (B, Tp, 2C) slice with a "
                         "row stride that is a multiple of 4")
    if bf16 and ldc % 8:
        raise ValueError(
            f"the bf16 body reads cond by TMA, whose row stride must be a "
            f"multiple of 16 bytes: ldc={ldc} is not a multiple of 8")
    return ldc


def _lib():
    lib = _build.load_library("wavenet")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wn_layer_launch.argtypes = [i, p, i, p, i, p, p, p, p, p, p,
                                        i, i, i, i, i, i, p, i]
        lib.wn_layer_launch.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.wn_layer_config.argtypes = [i, i, i, ip]
        lib.wn_layer_config.restype = i
        lib.wavenet_error_string.argtypes = [i]
        lib.wavenet_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def _built_config(C, bm, bf16=False):
    """(nh, stages, smem) of the library's build for (C, bm) and dtype."""
    cfg = (ctypes.c_int * 3)()
    if _lib().wn_layer_config(C, bm, int(bf16), cfg):
        raise RuntimeError(f"csrc/wavenet.cu has no build for C={C}, bm={bm}"
                           f", bf16={bf16}")
    return tuple(cfg)


def wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T, *, bm=None):
    """One WN layer.

    Args:
      x: (B, Tp, C) activations, Tp >= T (rows t >= T are padding); fp32,
        or bf16 with every other tensor bf16 too.
      d: dilation. cond: (B, Tp, 2C), last dim contiguous; may be a slice
        of the all-layer conditioning tensor.
      w_cat: (3C, 2C) conv taps [w[:,:,0].T; w[:,:,1].T; w[:,:,2].T];
        b: (2C,). w_rs: (C, 2C), or (C, C) on the last layer; b_rs to match.
      T: valid time steps.
      bm: rows a kernel block (fp32) or tile (bf16); ``wn_plan`` or
        ``wn_bf16_plan`` picks by default.

    Returns (x_new (B, Tp, C) or None on the last layer, skip (B, Tp, C)).
    """
    if x.device.type == "cpu":
        return wn_layer_reference(x, d, cond, w_cat, b, w_rs, b_rs, T)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, cond, w_cat, b, w_rs, b_rs)):
        raise RuntimeError(
            "wn_layer has no backward: the kernel's outputs would be cut "
            "from the autograd graph. Call it under torch.no_grad(); "
            "training runs vocoder/waveglow.py:waveglow_forward, which "
            "never reaches it")
    dev = x.device
    B, Tp, C = x.shape
    n_rs = w_rs.shape[1]
    last = n_rs == C
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {dt}; the kernel takes torch.float32 or "
                        "torch.bfloat16")
    bf16 = dt == torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wn_bf16_plan(B, Tp, C, sms, bm) if bf16 \
        else wn_plan(B, Tp, C, sms, bm)
    if not 0 < T <= Tp:
        raise ValueError(f"T={T} outside (0, {Tp}]")
    _build.check_tensor("x", x, (B, Tp, C), dev, dtype=dt)
    _build.check_tensor("cond", cond, (B, Tp, 2 * C), dev,
                        contiguous=False, dtype=dt)
    ldc = wn_cond_stride(cond, bf16)
    _build.check_tensor("w_cat", w_cat, (3 * C, 2 * C), dev, dtype=dt)
    _build.check_tensor("b", b, (2 * C,), dev, dtype=dt)
    if n_rs not in (C, 2 * C):
        raise ValueError(f"w_rs has {n_rs} columns, expected {C} or {2 * C}")
    _build.check_tensor("w_rs", w_rs, (C, n_rs), dev, dtype=dt)
    _build.check_tensor("b_rs", b_rs, (n_rs,), dev, dtype=dt)

    lib = _lib()
    if _built_config(C, plan.bm, bf16) != (plan.nh, plan.stages, plan.smem):
        raise RuntimeError(f"plan {plan} disagrees with csrc/wavenet.cu's "
                           f"build {_built_config(C, plan.bm, bf16)}")
    w1, w2 = _packed(w_cat, w_rs, 0 if bf16 else plan.nh)
    x_new = None if last else torch.empty_like(x)
    skip = torch.empty(B, Tp, C, device=dev, dtype=dt)
    err = lib.wn_layer_launch(
        int(bf16), x.data_ptr(), int(d), cond.data_ptr(), ldc, w1.data_ptr(),
        b.data_ptr(), w2.data_ptr(), b_rs.data_ptr(),
        None if last else x_new.data_ptr(), skip.data_ptr(), B, Tp, int(T),
        C, plan.bm, int(last), torch.cuda.current_stream(dev).cuda_stream,
        plan.grid if bf16 else 0)
    if err:
        raise RuntimeError("wn_layer_launch failed: "
                           + lib.wavenet_error_string(err).decode())
    wn_layer.launches += 1
    if bf16:
        wn_layer.launches_bf16 += 1
    return x_new, skip


# launches of either body, and of the bf16 body alone
wn_layer.launches = 0
wn_layer.launches_bf16 = 0
