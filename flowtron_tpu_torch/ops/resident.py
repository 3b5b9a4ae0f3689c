"""P3 and P4: scans whose weights stay on chip across steps (ports of the
TPU probes scripts/exp_resident_weight.py:pallas_scan and
scripts/exp_fused_int8.py:make_bf16 / make_w8a8).

Three bodies, each a whole ``steps``-long scan in one call:

    "p3"    state (B, S) bf16, one (S, N) bf16 weight:
            y = state @ w (fp32 sums)
            state = bf16(0.999 * f32(state) + 0.001 * y[:, :S])
    "bf16"  state (B, S) fp32, a chain of dots (K_i, N), bf16 weights;
            per dot y = bf16(h[:, :K_i]) @ w_i (fp32 sums), then
            h = tile(g, ...)[:, :S] with g = sig(y_0) tanh(y_1)
            + sig(y_2) tanh(y_3) over the four N/4-wide quarters
            (exp_fused_int8.py:_consume_gates); after the last dot
            state = 0.999 * state + 0.001 * h.
    "w8a8"  the same chain with int8 weights and (N,) fp32 per-column
            scales: sx = max|h_row| * fp32(1/127) + 1e-12 rounded once,
            q = round_half_even(h / sx) (no clip), exact integer sums,
            y = (f32(acc) * sx) * s.

The W8A8 body writes ``max|h| / 127.0 + 1e-12``; run by JAX (TPU
interpret mode on the CPU) it computes ``fma(max|h|, fp32(1/127),
1e-12)`` with one rounding, which differs from both the true quotient
and the rounded reciprocal product in the last bit for some rows. The
port computes what JAX runs (tests/test_torch_port_probes_scans.py
checks the quantized activations bit for bit).

Each call returns ``(state, last)``: the final state, and the last step's
full product y (B, N) fp32 for "p3" or the last dot's gate output g
(B, N/4) fp32 for the chains. On CUDA tensors ``resident_scan`` launches
csrc/resident.cu (its note says what bounds it and how the design
answers): P3 as laid out by ``p3_check``, the chains as ``chain_plan``
lays them out (which dots stay in shared memory, the grid barrier's
count); on CPU tensors it runs ``resident_scan_reference``.
"""

import ctypes
import functools
from collections import namedtuple

import torch

from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.ops._layout import interleave_gates

BODIES = ("p3", "bf16", "w8a8")
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
EPS = torch.tensor(1e-12, dtype=torch.float32).item()
# csrc/resident.cu's P3 tiling: batch rows a pass, state columns a ring
# stage, ring stages, output columns a block at most, bf16 of row padding
P3_ROWS, P3_CHUNK, P3_STAGES, P3_COLS, P3_PAD = 64, 128, 4, 32, 8
SMEM_OPTIN = 232448     # shared memory a block may opt in to on sm_90
H100_SMS = 132          # the SMs chain_plan assumes when it checks on the CPU
# csrc/resident.cu's chain kernel: warps a block, batch rows a pass, dots
# at most, bytes of k a lane's 16-byte fragment loads cover per quad of
# lanes (a "stretch"), shared memory kept for the kernel's static arrays
CHAIN_WARPS, CHAIN_ROWS, CHAIN_DOTS, STRETCH, CHAIN_STATIC = 8, 8, 4, 64, 1024

ChainPlan = namedtuple("ChainPlan", [
    "grid", "quads", "m_tiles", "rows", "stage_off", "xf_off", "red_off",
    "scale_off", "res_off", "smem", "resident", "resident_bytes"])
ChainPlan.__doc__ = """How csrc/resident.cu lays out a chain (byte offsets
into a block's dynamic shared memory). ``grid`` blocks, each owning at
most ``quads`` row quads (N / 4 split evenly, ``resident_grid``'s
rule) in ``m_tiles`` 16-row tiles of the mma; ``rows`` batch rows staged
a pass; ``res_off[i]`` the offset of dot i's resident rows or -1 (read
from L2 in the dot); ``smem`` the dynamic bytes in all;
``resident_bytes`` the bytes of the resident dots' weights over the whole
grid."""


def row_stride(nbytes):
    """Bytes between two rows of ``nbytes`` (a multiple of 64) in the
    chain kernel's shared memory: an odd multiple of 64, so that the two
    rows a quarter-warp's 16-byte fragment loads touch fall in different
    halves of the 32 banks."""
    return nbytes if nbytes % 128 else nbytes + 64


def _align(n, a=128):
    return -(-n // a) * a


@functools.lru_cache(maxsize=64)
def chain_plan(body, B, Ks, N, S, sms):
    """Lay out a chain of dots (K_i, N), ``Ks`` a tuple, on ``sms`` blocks
    (one a SM), as csrc/resident.cu:resident_chain takes it. Raises
    ValueError naming the constraint the kernel does not meet.

    Each block owns a contiguous range of N / 4 row quads. In shared
    memory, in order: the staged input rows (bf16 or int8, and W8A8's fp32
    rows before they are quantized), the k-parts' partial sums, W8A8's
    scales, then every dot that fits, in order, kept resident for the
    whole scan; a dot that does not fit is read from global memory (L2)
    every step in the dot itself."""
    if body not in ("bf16", "w8a8"):
        raise ValueError(f"chain_plan: body {body!r} is not a chain")
    if B < 1 or sms < 1:
        raise ValueError(f"chain_plan: B ({B}) and sms ({sms}) must be "
                         "positive")
    if not 1 <= len(Ks) <= CHAIN_DOTS:
        raise ValueError(f"chain_plan: {len(Ks)} dots; the kernel takes 1 "
                         f"to {CHAIN_DOTS}")
    esize = 1 if body == "w8a8" else 2
    for i, K in enumerate(Ks):
        if K < 1 or K * esize % STRETCH:
            raise ValueError(f"chain_plan: dot {i}'s K ({K}) must be a "
                             f"positive multiple of {STRETCH // esize} "
                             f"({STRETCH}-byte stretches of {body})")
        if K > S:
            raise ValueError(f"chain_plan: dot {i}'s K ({K}) exceeds the "
                             f"state width ({S})")
    if N % 16 or S % 4:
        raise ValueError(f"chain_plan: N ({N}) must be a multiple of 16 "
                         f"and S ({S}) of 4 (16-byte input loads)")
    grid = min(sms, N // 4)
    quads = -(-(N // 4) // grid)
    m_tiles = 1
    while 16 * m_tiles < 4 * quads:
        m_tiles *= 2
    if m_tiles > CHAIN_WARPS:
        raise ValueError(f"chain_plan: {quads} row quads a block (N = {N} "
                         f"over {grid} blocks) exceed "
                         f"{4 * CHAIN_WARPS}, one 16-row tile a warp")
    rows = min(B, CHAIN_ROWS)
    kmax = max(Ks)
    stage_off = 0
    xf_off = _align(rows * row_stride(kmax * esize))
    red_off = xf_off + (_align(rows * kmax * 4) if body == "w8a8" else 0)
    scale_off = red_off + CHAIN_WARPS * 16 * CHAIN_ROWS * 4
    used = scale_off + (_align(len(Ks) * 16 * m_tiles * 4)
                        if body == "w8a8" else 0)
    budget = SMEM_OPTIN - CHAIN_STATIC
    if used > budget:
        raise ValueError(f"chain_plan: {used} bytes of staged rows and "
                         f"partial sums exceed the {budget} of shared "
                         "memory a block may use")
    res_off, resident = [], []
    for K in Ks:
        slice_bytes = _align(4 * quads * row_stride(K * esize))
        fits = used + slice_bytes <= budget
        res_off.append(used if fits else -1)
        resident.append(int(fits))
        used += slice_bytes if fits else 0
    resident_bytes = sum(N * K * esize for K, r in zip(Ks, resident) if r)
    return ChainPlan(grid, quads, m_tiles, rows, stage_off, xf_off, red_off,
                     scale_off, tuple(res_off), used, tuple(resident),
                     resident_bytes)


def p3_check(B, S, N, K, sms=None):
    """Raise ValueError, naming the constraint, unless csrc/resident.cu's
    P3 kernel takes these shapes: K == S (the weight's rows are the
    state), K a multiple of the ring's chunk, N a multiple of 4 and at
    least S, and the resident slice, ring and partial sums within the
    shared memory a block may use; with ``sms`` (the card's SM count) also
    at most 32 output columns a block."""
    if B < 1:
        raise ValueError(f"B ({B}) must be at least 1")
    if K != S:
        raise ValueError(f"p3: the weight's rows ({K}) must equal the state "
                         f"width ({S})")
    if K < P3_CHUNK or K % P3_CHUNK:
        raise ValueError(f"p3: the state width ({K}) must be a positive "
                         f"multiple of {P3_CHUNK}, the ring's chunk")
    if N % 4 or N < S:
        raise ValueError(f"p3: N ({N}) must be a multiple of 4 and at least "
                         f"the state width ({S})")
    smem = (P3_COLS * (K + P3_PAD) * 2
            + P3_STAGES * P3_ROWS * (P3_CHUNK + P3_PAD) * 2
            + P3_ROWS * (P3_COLS + 4) * 4)
    if smem > SMEM_OPTIN:
        raise ValueError(f"p3: {smem} bytes of shared memory a block (K = "
                         f"{K}) exceed the {SMEM_OPTIN} a block may use")
    if sms is not None:
        grid = min(sms, N // 4)
        cols = 4 * -(-(N // 4) // grid)
        if cols > P3_COLS:
            raise ValueError(f"p3: {cols} output columns a block (N = {N} "
                             f"over {grid} blocks) exceed {P3_COLS}")


def _bf16(t):
    return t.to(torch.bfloat16).float()


def blend(a, b):
    """0.999 * a + 0.001 * b in fp32, each product and the sum rounded."""
    return 0.999 * a + 0.001 * b


def quantize_rows(h):
    """W8A8's activation quantizer on (B, K) fp32 rows: returns the int8
    values as fp32 and sx (B, 1). sx is fma(max|h|, fp32(1/127), 1e-12):
    the product is exact in float64, so one rounding to fp32 after the
    add gives the fused result."""
    amax = h.abs().amax(dim=1, keepdim=True)
    sx = (amax.double() * INV_127 + EPS).float()
    return torch.round(h / sx), sx


def consume_gates(y, width):
    """exp_fused_int8.py:_consume_gates: every column of the 4-quarter
    product y feeds g, which is tiled to ``width`` columns."""
    h4 = y.shape[1] // 4
    g = (torch.sigmoid(y[:, :h4]) * torch.tanh(y[:, h4:2 * h4])
         + torch.sigmoid(y[:, 2 * h4:3 * h4]) * torch.tanh(y[:, 3 * h4:]))
    reps = -(-width // h4)
    return g, g.repeat(1, reps)[:, :width]


def resident_scan_reference(body, x, ws, scales=None, steps=1):
    """Plain PyTorch version of ``resident_scan`` (same arguments, same
    ``(state, last)``). ``ws`` are the scripts' (K_i, N) weights: bf16 for
    "p3" and "bf16", int8 for "w8a8" with ``scales`` (N,) or (1, N) fp32.
    ``x`` is the initial state: bf16 for "p3" and "bf16", fp32 for
    "w8a8"."""
    if body not in BODIES:
        raise ValueError(f"body {body!r} not in {BODIES}")
    S = x.shape[1]
    if body == "p3":
        w = ws[0].float()
        state = x.to(torch.bfloat16)
        for _ in range(steps):
            y = state.float() @ w
            state = blend(state.float(), y[:, :S]).to(torch.bfloat16)
        return state, y
    state = x.float()
    for _ in range(steps):
        h = state
        for i, w in enumerate(ws):
            hx = h[:, :w.shape[0]]
            if body == "bf16":
                y = _bf16(hx) @ w.float()
            else:
                q, sx = quantize_rows(hx)
                acc = (q.double() @ w.double()).float()
                y = acc * sx * scales[i].reshape(1, -1).float()
            g, h = consume_gates(y, S)
        state = blend(state, h)
    return state, g


@torch.no_grad()
def pack_resident_weights(body, ws, scales=None):
    """The kernel's layout: each (K_i, N) weight as (N, K_i) rows, k
    contiguous; for the chains row 4u + c holds column c * N/4 + u (the
    four gate columns of unit u side by side), and the (N,) scales follow
    the same order. Returns (weights, scales or None), new storage."""
    out_w, out_s = [], None if scales is None else []
    for i, w in enumerate(ws):
        wt = w.t() if body == "p3" else interleave_gates(w.t())
        out_w.append(wt.contiguous())
        if scales is not None:
            s = scales[i].reshape(-1).float()
            out_s.append(interleave_gates(s).contiguous())
    return out_w, out_s


def _lib():
    lib = _build.load_library("resident")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.resident_scan.argtypes = [i] * 5 + [p] * 5
        lib.resident_scan.restype = i
        lib.resident_chain.argtypes = [i] * 9 + [p] * 12
        lib.resident_chain.restype = i
        lib.resident_grid.argtypes = [i]
        lib.resident_grid.restype = i
        lib.resident_max_persisting_l2.argtypes = []
        lib.resident_max_persisting_l2.restype = ctypes.c_longlong
        lib.resident_error_string.argtypes = [i]
        lib.resident_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def max_persisting_l2_bytes():
    """Bytes an L2 access-policy window may pin on the current card."""
    return int(_lib().resident_max_persisting_l2())


def resident_scan(body, x, ws, scales=None, steps=1, packed=None,
                  clock=None):
    """The ``steps``-long scan of ``body`` from initial state ``x`` (see
    the module docstring); returns ``(state, last)``. On CPU tensors this
    is ``resident_scan_reference``; on CUDA tensors it launches
    csrc/resident.cu once, with ``packed`` (``pack_resident_weights``)
    when given, or raises. The bytes of weights kept in shared memory and
    which dots were kept go to ``resident_scan.last_resident``. Shapes the
    kernels do not take raise ValueError on either device (``p3_check``,
    ``chain_plan``).

    Chains only, for measurements: ``clock`` (steps x dots int64 on the
    card) receives the ns time at which block 0 passes each grid
    barrier."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    if body not in BODIES:
        raise ValueError(f"body {body!r} not in {BODIES}")
    dev = x.device
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else None)
    if body == "p3":
        p3_check(x.shape[0], x.shape[1], ws[0].shape[1], ws[0].shape[0], sms)
    else:
        plan = chain_plan(body, x.shape[0], tuple(w.shape[0] for w in ws),
                          ws[0].shape[1], x.shape[1], sms or H100_SMS)
        _build.check_barriers(steps * len(ws), plan.grid)
    if dev.type == "cpu":
        return resident_scan_reference(body, x, ws, scales, steps)
    pw, ps = packed if packed is not None else pack_resident_weights(
        body, ws, scales)
    n = len(pw)
    B, S = x.shape
    N = pw[0].shape[0]
    wdt = torch.int8 if body == "w8a8" else torch.bfloat16
    for i, w in enumerate(pw):
        _build.check_tensor(f"w[{i}]", w, (N, w.shape[1]), dev, dtype=wdt)
        if body == "w8a8":
            _build.check_tensor(f"scale[{i}]", ps[i], (N,), dev)
    if body == "p3":
        state0 = x.to(torch.bfloat16).contiguous().clone()
    else:
        state0 = x.float().contiguous().clone()
    states = (state0, torch.empty_like(state0))
    wp = (ctypes.c_void_p * n)(*[w.data_ptr() for w in pw])

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if body == "p3":
        y_last = torch.empty(B, N, device=dev)
        err = lib.resident_scan(B, steps, N, S, pw[0].shape[1], wp,
                                ptr(states[0]), ptr(states[1]), ptr(y_last),
                                stream)
        last = y_last
        res = (N * pw[0].shape[1] * 2, [1])
    else:
        g = [torch.empty(B, N // 4, device=dev) for _ in range(2)]
        bar = torch.zeros(1, dtype=torch.int32, device=dev)
        ints = lambda v: (ctypes.c_int * CHAIN_DOTS)(*v)   # noqa: E731
        sp = (ctypes.c_void_p * n)(*([s.data_ptr() for s in ps]
                                     if body == "w8a8" else [None] * n))
        if clock is not None:
            _build.check_tensor("clock", clock, (steps * n,), dev,
                                dtype=torch.int64)
        layout = (ctypes.c_int * 4)(plan.stage_off, plan.xf_off, plan.red_off,
                                    plan.scale_off)
        err = lib.resident_chain(
            BODIES.index(body), B, steps, n, N, S, plan.grid, plan.m_tiles,
            plan.smem, ints([w.shape[1] for w in pw]), layout,
            ints(plan.res_off), wp, sp, ptr(states[0]), ptr(states[1]),
            ptr(g[0]), ptr(g[1]), ptr(clock), bar.data_ptr(), stream)
        last = g[(n - 1) & 1]
        res = (plan.resident_bytes, list(plan.resident))
    if err:
        raise RuntimeError("resident_scan failed: "
                           + lib.resident_error_string(err).decode())
    resident_scan.launches += 1
    setattr(resident_scan, f"launches_{body}",
            getattr(resident_scan, f"launches_{body}") + 1)
    resident_scan.last_resident = res
    return states[steps & 1], last


# launches of any body, and of each body
resident_scan.launches = 0
resident_scan.launches_p3 = 0
resident_scan.launches_bf16 = 0
resident_scan.launches_w8a8 = 0
resident_scan.last_resident = None
