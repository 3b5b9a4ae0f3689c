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
answers); on CPU tensors it runs ``resident_scan_reference``.
"""

import ctypes

import torch

from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.ops._layout import interleave_gates

BODIES = ("p3", "bf16", "w8a8")
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()
EPS = torch.tensor(1e-12, dtype=torch.float32).item()


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
        lib.resident_scan.argtypes = [i, i, i, i, i, i, p, p, p, p, p, p, p,
                                      p, p, p, p]
        lib.resident_scan.restype = i
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


def resident_scan(body, x, ws, scales=None, steps=1, packed=None):
    """The ``steps``-long scan of ``body`` from initial state ``x`` (see
    the module docstring); returns ``(state, last)``. On CPU tensors this
    is ``resident_scan_reference``; on CUDA tensors it launches
    csrc/resident.cu once, with ``packed`` (``pack_resident_weights``)
    when given, or raises. The bytes of weights kept in shared memory and
    which dots were kept go to ``resident_scan.last_resident``."""
    if x.device.type == "cpu":
        return resident_scan_reference(body, x, ws, scales, steps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if body not in BODIES:
        raise ValueError(f"body {body!r} not in {BODIES}")
    dev = x.device
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
    g = [torch.empty(B, N // 4, device=dev) for _ in range(2)] \
        if body != "p3" else [None, None]
    y_last = torch.empty(B, N, device=dev) if body == "p3" else None
    K = (ctypes.c_int * n)(*[w.shape[1] for w in pw])
    wp = (ctypes.c_void_p * n)(*[w.data_ptr() for w in pw])
    sp = (ctypes.c_void_p * n)(*([s.data_ptr() for s in ps]
                                 if body == "w8a8" else [None] * n))
    res_bytes = ctypes.c_longlong(0)
    resident = (ctypes.c_int * n)()

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    err = lib.resident_scan(
        BODIES.index(body), B, steps, n, N, S, K, wp, sp, ptr(states[0]),
        ptr(states[1]), ptr(g[0]), ptr(g[1]), ptr(y_last),
        ctypes.byref(res_bytes), resident,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("resident_scan failed: "
                           + lib.resident_error_string(err).decode())
    resident_scan.launches += 1
    setattr(resident_scan, f"launches_{body}",
            getattr(resident_scan, f"launches_{body}") + 1)
    resident_scan.last_resident = (res_bytes.value, list(resident))
    last = y_last if body == "p3" else g[(n - 1) & 1]
    return states[steps & 1], last


# launches of any body, and of each body
resident_scan.launches = 0
resident_scan.launches_p3 = 0
resident_scan.launches_bf16 = 0
resident_scan.launches_w8a8 = 0
resident_scan.last_resident = None
