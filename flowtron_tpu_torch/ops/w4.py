"""P1 and P2: the int4 dequant-matmul probe kernels (ports of the Pallas
bodies of scripts/exp_w4_kernel_bisect.py, ``k1``-``k5``, and of
scripts/exp_int4_variants.py, ``k_w4_concat`` and ``k_w4_2dot``).

x (B, IN) bf16 times the int4 weight packed in q (IN/2, OUT) int8 (low
nibble row r, high nibble row r + IN/2, both sign-extended), fp32 sums,
out (B, OUT) bf16; s (NG, OUT) fp32 scales. The bodies:

    "k1"      x[:, :IN/2] @ lo, no scale
    "k2"      x @ [lo; hi], no scale
    "k3"      w_r = bf16(w_r * bf16(s[r // G])), G = IN / NG = 128
    "concat"  the same math (P2's k_w4_concat)
    "2dot"    the same with G = 64, as two dots on the halves of x
    "k4"      w_r = bf16(w_r * bf16(s[r % NG])): ``pltpu.repeat(s, G, 0)``
              tiles the whole (NG, TN) block G times, so row r meets
              s[r % NG], not s[r // G] as k3 does; the TPU bisect's
              "+repeat-scale" variant scaled other rows than it meant to
    "k5"      64-row partial sums, each times s[r // G] in fp32

Where the scaled weight is rounded to bf16 is where JAX rounds it (TPU
interpret mode on the CPU; tests/test_torch_port_probes_w4.py). On CUDA
tensors ``w4_matmul`` launches csrc/w4.cu (tensor cores, one launch a
call: a thread-block cluster of ``w4_plan``'s split blocks along the rows
per column tile); on CPU tensors it runs ``w4_matmul_reference``. Either
way ``w4_plan`` first checks the shapes the kernel takes.
"""

import ctypes

import torch

from flowtron_tpu_torch.ops import _build

# body -> (kernel mode, rows of the weight used: IN/2 or IN)
BODIES = {"k1": (0, "half"), "k2": (0, "all"), "k3": (1, "all"),
          "k4": (2, "all"), "k5": (3, "all"), "concat": (1, "all"),
          "2dot": (1, "all")}
CHUNK = 64          # k5's partial sums
# csrc/w4.cu's tiling: output columns a block, packed rows a chunk (two
# 64-row chunks of the weight, one in each half), blocks along the rows
# (a cluster) at most, scale rows staged at most
TILE_N, TILE_ROWS, MAX_SPLIT, MAX_NG = 64, 64, 8, 64


def w4_plan(B, IN, OUT, NG, body, sms=None, clusters=None):
    """Check that csrc/w4.cu takes these shapes, raising ValueError that
    names the constraint; with ``sms`` (the card's SM count) also choose
    the split along the rows: the largest, at most 8 and at most one a
    128-row chunk pair, whose (OUT / 64) x split blocks make at most one
    wave, and, with ``clusters`` (split -> clusters of that many blocks the
    card runs at once), whose clusters all run at once. Returns the
    split, or None without ``sms``."""
    if body not in BODIES:
        raise ValueError(f"body {body!r} not in {sorted(BODIES)}")
    mode, _ = BODIES[body]
    if B < 1:
        raise ValueError(f"B ({B}) must be at least 1")
    if IN < 2 * TILE_ROWS or IN % (2 * TILE_ROWS):
        raise ValueError(f"IN ({IN}) must be a positive multiple of "
                         f"{2 * TILE_ROWS}: whole {TILE_ROWS}-row chunks in "
                         "each half of the packed weight")
    if OUT < TILE_N or OUT % TILE_N:
        raise ValueError(f"OUT ({OUT}) must be a positive multiple of "
                         f"{TILE_N}, the kernel's column tile")
    if mode != 0:
        if not 1 <= NG <= MAX_NG:
            raise ValueError(f"NG ({NG}) must be in 1..{MAX_NG}: the "
                             "scale rows a block stages")
        if mode in (1, 3) and (IN % NG or (IN // NG) % CHUNK):
            raise ValueError(f"the group IN / NG ({IN} / {NG}) must be a "
                             f"whole multiple of {CHUNK} rows")
    if sms is None:
        return None
    tiles, split = OUT // TILE_N, 1
    for k in range(2, min(MAX_SPLIT, IN // (2 * TILE_ROWS)) + 1):
        if tiles * k <= sms and (clusters is None or clusters(k) >= tiles):
            split = k
    return split


def _bf16(t):
    return t.to(torch.bfloat16).float()


def unpack_int4(q):
    """(IN/2, OUT) int8 -> (lo, hi) int32, each (IN/2, OUT), sign-extended
    as the Pallas bodies do on int32: (q << 28) >> 28 and q >> 4."""
    qi = q.to(torch.int32)
    return (qi << 28) >> 28, qi >> 4


def dequantize(q, s, body):
    """The fp32 weight (rows, OUT) a body multiplies x by: bf16-rounded
    where the body rounds it; for "k5", whose scale meets the fp32 partial
    sums, the unrounded product w_r * s[r // G]."""
    mode, rows = BODIES[body]
    lo, hi = unpack_int4(q)
    if rows == "half":
        return lo.float()
    w = torch.cat([lo, hi]).float()
    IN, NG = w.shape[0], s.shape[0]
    r = torch.arange(IN, device=q.device)
    if mode == 0:
        return w
    if mode == 2:
        return _bf16(w * _bf16(s)[r % NG])
    if mode == 1:
        return _bf16(w * _bf16(s)[r // (IN // NG)])
    return w * s[r // (IN // NG)]


def w4_matmul_reference(x, q, s, body):
    """Plain PyTorch version of ``w4_matmul`` (same arguments and
    output)."""
    mode, _ = BODIES[body]
    xf = x.float()
    if mode == 3:
        lo, hi = unpack_int4(q)
        w = torch.cat([lo, hi]).float()
        G = w.shape[0] // s.shape[0]
        y = torch.zeros(x.shape[0], w.shape[1], device=x.device)
        for c0 in range(0, w.shape[0], CHUNK):
            part = xf[:, c0:c0 + CHUNK] @ w[c0:c0 + CHUNK]
            y = y + part * s[c0 // G]
        return y.to(torch.bfloat16)
    w = dequantize(q, s, body)
    if body == "2dot":
        h = w.shape[0] // 2
        y = xf[:, :h] @ w[:h] + xf[:, h:] @ w[h:]
    else:
        y = xf[:, :w.shape[0]] @ w
    return y.to(torch.bfloat16)


def _lib():
    lib = _build.load_library("w4")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.w4_matmul.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
        lib.w4_matmul.restype = i
        lib.w4_max_clusters.argtypes = [i, i, i]
        lib.w4_max_clusters.restype = i
        lib.w4_error_string.argtypes = [i]
        lib.w4_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


_clusters = {}


def _max_clusters(dev, mode, NG, split):
    """Clusters of ``split`` blocks the card runs at once (csrc/w4.cu asks
    the runtime; once per device, mode, NG and split)."""
    key = (dev.index, mode, NG, split)
    if key not in _clusters:
        n = _lib().w4_max_clusters(mode, NG, split)
        if n < 0:
            raise RuntimeError("w4_max_clusters failed: "
                               + _lib().w4_error_string(-n).decode())
        _clusters[key] = n
    return _clusters[key]


def w4_matmul(x, q, s, body):
    """(B, IN) bf16 x, (IN/2, OUT) int8 q, (NG, OUT) fp32 s -> (B, OUT)
    bf16 for one of ``BODIES``. On CPU tensors this is
    ``w4_matmul_reference``; on CUDA tensors it launches csrc/w4.cu or
    raises. Shapes the kernel does not take raise ValueError on either
    device (``w4_plan``)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    B, IN = x.shape
    OUT = q.shape[1]
    dev = x.device
    if dev.type == "cpu":
        w4_plan(B, IN, OUT, s.shape[0], body)
        return w4_matmul_reference(x, q, s, body)
    mode, rows = BODIES[body]
    NG = s.shape[0]
    split = w4_plan(B, IN, OUT, NG, body,
                    torch.cuda.get_device_properties(dev).multi_processor_count,
                    lambda k: _max_clusters(dev, mode, NG, k))
    _build.check_tensor("x", x, (B, IN), dev, dtype=torch.bfloat16)
    _build.check_tensor("q", q, (IN // 2, OUT), dev, dtype=torch.int8)
    _build.check_tensor("s", s, (s.shape[0], OUT), dev)
    out = torch.empty(B, OUT, dtype=torch.bfloat16, device=dev)
    lib = _lib()
    err = lib.w4_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                        out.data_ptr(), B, IN, OUT,
                        IN // 2 if rows == "half" else IN, s.shape[0], mode,
                        split,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("w4_matmul failed: "
                           + lib.w4_error_string(err).decode())
    w4_matmul.launches += 1
    w4_matmul.last_split = split
    setattr(w4_matmul, f"launches_{body}",
            getattr(w4_matmul, f"launches_{body}") + 1)
    return out


# launches of any body, and of each body; the last launch's split
w4_matmul.launches = 0
w4_matmul.last_split = None
for _body in BODIES:
    setattr(w4_matmul, f"launches_{_body}", 0)
del _body
