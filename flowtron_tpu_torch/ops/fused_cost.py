"""P5: K1 stripped to its dots, its LSTM cells or its attention (port of
the TPU probe scripts/exp_fused_cost.py: ``run`` and its bodies
``v_dots``, ``v_lstm``, ``v_attn``).

Each variant runs N steps of a recurrence over scratch h, h2 (B, H) and
prev (B, M) that start at zero, with bf16 weights in the scripts' (K, N)
layout, fp32 sums, latents z (N, B, M) fp32 and keys/values kv (B, Tk, D)
bf16, and returns mel (N, B, M) fp32 (csrc/fused_cost.cu spells out the
three recurrences). Every dot input is rounded to bf16 first. Where the
script slices a dot's output, the kernel still computes the whole product
(the probe measures what reading every weight of a K1 frame costs).

On CUDA tensors ``fused_cost`` makes one persistent cooperative launch of
csrc/fused_cost.cu for the whole recurrence, K1's structure stripped
down: one block a SM, the step loop inside the kernel, each step a chain
of dependent stages (``p5_plan``) split over all blocks and separated by
grid barriers; on CPU tensors it runs ``fused_cost_reference``, the plain
PyTorch version on the same (K, N) weights.
"""

import ctypes
import functools
from collections import namedtuple

import torch
import torch.nn.functional as F

from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.ops._layout import interleave_gates
from flowtron_tpu_torch.ops.resident import SMEM_OPTIN

VARIANTS = ("dots", "lstm", "attn")
# csrc/fused_cost.cu's limits: batch rows a pass over the weights, jobs a
# stage, threads a block, shared memory kept for its static arrays
MAX_ROWS, MAX_JOBS, THREADS, STATIC_SMEM = 8, 2, 256, 2048

P5Stage = namedtuple("P5Stage", "name jobs bounds")
P5Stage.__doc__ = """One dependent stage of a P5 step: ``jobs`` its
matrices as (name, rows, bf16 a row); ``bounds[j]`` splits job j's row
quads over the blocks, block i taking quads ``bounds[j][i]`` up to
``bounds[j][i + 1]``."""
P5Plan = namedtuple("P5Plan", "stages n_blocks fixed_bytes")


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


def _pad8(n):
    return -(-n // 8) * 8


@functools.lru_cache(maxsize=64)
def p5_plan(variant, B, M, H, D, Tk, Nc, n_blocks):
    """The dependent stages of one P5 step, each job's row quads split
    evenly over ``n_blocks`` blocks as ops/decoder.py:k1_plan splits K1's
    (block i takes the contiguous range from i * Q // n_blocks).
    csrc/fused_cost.cu builds the same list, in this order:

      dots  cell   w0 . prev(t), plus the waiting h(t - 1) . w1: h
            cell2  w2 . h(t): h2; w1 . h(t), kept for step t + 1
            head   w3 . h2(t): mel
      lstm  cell   w0 . prev(t), plus h(t - 1) . w1: the LSTM cell, h
            cell2  w2 . h(t), plus h2(t - 1) . w3: h2; w1 . h(t)
            head   w4 . h2(t): mel; w3 . h2(t), kept for step t + 1
      attn  query  the previous step's softmax and first M context
                   channels (every block; mel), then w0 . prev(t): q
            attention  a score a (batch row, key position), and the
                   previous step's other context channels, over all
                   blocks' warps

    The recurrent halves h . w1 and h2 . w3 depend only on state already
    known, so they run off the dependent chain and their sums wait in
    scratch, added as the script adds its separate dots. ``fixed_bytes``
    is the shared memory a block needs beside its prefetch buffer: the
    widest stage's staged inputs and, for attn, every row's softmax
    weights and the context's partial sums. Raises ValueError naming the
    constraint the kernel does not meet."""
    if variant not in VARIANTS:
        raise ValueError(f"p5_plan: variant {variant!r} not in {VARIANTS}")
    if min(B, M, D, Tk, Nc, n_blocks) < 1 or (variant != "attn" and H < 4):
        raise ValueError("p5_plan: every size must be positive (H at "
                         "least 4)")
    rows = min(B, MAX_ROWS)
    Mp, Hp = _pad8(M), _pad8(H)
    if variant == "attn":
        if D < M or M % 8 or D % 8:
            raise ValueError(f"p5_plan: attn needs M ({M}) <= D ({D}), "
                             "both multiples of 8 (16-byte context chunks)")
        if M > 256:
            raise ValueError(f"p5_plan: M ({M}) exceeds 256 channels, 8 a "
                             "thread of a row's 32")
        stages = [("query", [("w0", D, Mp)]), ("attention", [])]
        # staged prev, every row's softmax weights (the attention stage
        # reads them for the context's other channels), 8 partial context
        # sums a thread
        fixed = 2 * rows * Mp + 4 * B * Tk + 4 * 8 * THREADS
    else:
        if H % 4 or Nc % 4 or M % 4 or Nc < M:
            raise ValueError(f"p5_plan: H ({H}), Nc ({Nc}) and M ({M}) "
                             "must be multiples of 4 (4-float input "
                             "loads) and Nc at least M")
        rec1 = ("w1", 4 * H, Hp)
        head = [("w3", Nc, Hp)] if variant == "dots" else \
            [("w4", Nc, Hp), ("w3", 4 * H, Hp)]
        stages = [("cell", [("w0", 4 * H, Mp)]),
                  ("cell2", [("w2", 4 * H, Hp), rec1]), ("head", head)]
        # a stage's jobs share one input: the widest staged rows
        fixed = 2 * rows * max(Mp, Hp)
    if fixed > SMEM_OPTIN - STATIC_SMEM:
        raise ValueError(f"p5_plan: {fixed} bytes of staged inputs exceed "
                         f"the {SMEM_OPTIN - STATIC_SMEM} of shared memory "
                         "a block may use")
    return P5Plan(tuple(
        P5Stage(name, tuple(jobs), tuple(
            tuple(i * -(-n // 4) // n_blocks for i in range(n_blocks + 1))
            for _, n, _ in jobs))
        for name, jobs in stages), n_blocks, fixed)


def p5_bounds_array(plan):
    """The plan as csrc/fused_cost.cu reads it: (stages, MAX_JOBS,
    n_blocks + 1) quad boundaries, flattened; missing jobs are empty."""
    flat = []
    for st in plan.stages:
        for j in range(MAX_JOBS):
            flat += (st.bounds[j] if j < len(st.bounds)
                     else (0,) * (plan.n_blocks + 1))
    return flat


def _interleave(w):
    """(K, N) -> (N, P(K)) rows with row 4u + c = column c * N/4 + u."""
    t = interleave_gates(w.t())
    return F.pad(t, (0, _pad8(t.shape[1]) - t.shape[1]))


def _columns(w):
    """(K, N) -> (N, P(K)) rows in column order."""
    return F.pad(w.t(), (0, _pad8(w.shape[0]) - w.shape[0]))


@torch.no_grad()
def pack_weights(variant, ws):
    """The kernel's bf16 layout (documented at ``fused_cost_f32`` in
    csrc/fused_cost.cu): each of the script's (K, N) weights as (N, P(K))
    rows, k contiguous and zero-padded to a multiple of 8; cell weights
    (those whose quarters are gates) with row 4u + c = column c * N/4 + u,
    the head and query weights in column order. New storage."""
    if variant == "attn":
        packed = [_columns(ws[0])]
    elif variant == "dots":
        packed = [_interleave(w) for w in ws[:3]] + [_columns(ws[3])]
    elif variant == "lstm":
        packed = [_interleave(w) for w in ws[:4]] + [_columns(ws[4])]
    else:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    return tuple(w.to(torch.bfloat16).contiguous() for w in packed)


def _lib():
    lib = _build.load_library("fused_cost")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fused_cost_f32.argtypes = [i] + [p] * 8 + [i] * 9 + [p]
        lib.fused_cost_f32.restype = i
        lib.fused_cost_workspace_floats.argtypes = [i] * 4
        lib.fused_cost_workspace_floats.restype = ctypes.c_longlong
        lib.fused_cost_coresident_blocks.argtypes = [i]
        lib.fused_cost_coresident_blocks.restype = i
        lib.fused_cost_error_string.argtypes = [i]
        lib.fused_cost_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


_bounds = {}


def _bounds_tensor(plan, dev):
    key = (plan, dev)
    if key not in _bounds:
        _bounds[key] = torch.tensor(p5_bounds_array(plan), dtype=torch.int32,
                                    device=dev)
    return _bounds[key]


def _sizes(variant, z, kv, ws):
    """(B, M, H, D, Tk, Nc) of a call, as ``p5_plan`` takes them; raises
    ValueError unless ``ws`` have the script's shapes."""
    _, B, M = z.shape
    _, Tk, D = kv.shape
    shapes = [tuple(w.shape) for w in ws]
    H = shapes[1][0] if variant != "attn" else 0
    Nc = shapes[-1][1] if variant != "attn" else D
    if shapes != weight_shapes(variant, M, H or 1024, D):
        raise ValueError(f"{variant} weights {shapes} are not the script's "
                         f"{weight_shapes(variant, M, H or 1024, D)}")
    return B, M, H, D, Tk, Nc


def fused_cost(variant, z, kv, ws, packed=None, clock=None):
    """mel (N, B, M) fp32 of ``variant`` over latents z (N, B, M) fp32 and
    kv (B, Tk, D) bf16 with the (K, N) bf16 weights ``ws``. On CPU
    tensors this is ``fused_cost_reference``; on CUDA tensors it makes one
    cooperative launch of csrc/fused_cost.cu, on ``packed``
    (``pack_weights``) when given, or raises. ``clock`` (N x stages int64
    on the card, for measurements) receives the ns time at which block 0
    passes each stage's grid barrier."""
    if z.device.type == "cpu":
        return fused_cost_reference(variant, z, kv, ws)
    if z.device.type != "cuda":
        raise ValueError(f"no kernel for device {z.device}")
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    dev = z.device
    N = z.shape[0]
    B, M, H, D, Tk, Nc = _sizes(variant, z, kv, ws)
    pw = packed if packed is not None else pack_weights(variant, ws)
    _build.check_tensor("z", z, (N, B, M), dev)
    _build.check_tensor("kv", kv, (B, Tk, D), dev, dtype=torch.bfloat16)
    for i, (w, src) in enumerate(zip(pw, ws)):
        _build.check_tensor(f"packed[{i}]", w,
                            (src.shape[1], _pad8(src.shape[0])), dev,
                            dtype=torch.bfloat16)
    n_blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = p5_plan(variant, B, M, H, D, Tk, Nc, n_blocks)
    n_stages = len(plan.stages)
    _build.check_barriers(N * n_stages, n_blocks)
    lib = _lib()
    most = lib.fused_cost_coresident_blocks(plan.fixed_bytes)
    if most < n_blocks:
        raise RuntimeError(
            f"P5 needs {n_blocks} co-resident blocks (one a SM) for its "
            f"cooperative launch; this card holds {most}")
    if clock is not None:
        _build.check_tensor("clock", clock, (N * n_stages,), dev,
                            dtype=torch.int64)
    work = torch.empty(int(lib.fused_cost_workspace_floats(B, H, D, Tk)),
                       device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    mel = torch.empty(N, B, M, device=dev)
    wp = (ctypes.c_void_p * len(pw))(*[w.data_ptr() for w in pw])
    err = lib.fused_cost_f32(
        VARIANTS.index(variant), z.data_ptr(), kv.data_ptr(), wp,
        mel.data_ptr(), work.data_ptr(), bar.data_ptr(),
        _bounds_tensor(plan, dev).data_ptr(),
        None if clock is None else clock.data_ptr(), n_blocks,
        plan.fixed_bytes, N, B, M, H, D, Tk, Nc,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("fused_cost_f32 failed: "
                           + lib.fused_cost_error_string(err).decode())
    fused_cost.launches += 1
    setattr(fused_cost, f"launches_{variant}",
            getattr(fused_cost, f"launches_{variant}") + 1)
    return mel


def fused_cost_stage_split(variant, z, kv, ws, packed=None):
    """One launch of P5 on CUDA tensors with its stage clock on: the mean
    us a step from one grid barrier to the next, by stage (p5_plan's
    names), steps 1 .. N - 1, as block 0 sees them, and the mel. A
    measurement: the launch is counted in ``fused_cost.launches``."""
    N = z.shape[0]
    sms = torch.cuda.get_device_properties(z.device).multi_processor_count
    stages = p5_plan(variant, *_sizes(variant, z, kv, ws), sms).stages
    clock = torch.zeros(N * len(stages), dtype=torch.int64, device=z.device)
    mel = fused_cost(variant, z, kv, ws, packed, clock)
    ns = clock.double().diff()[len(stages) - 1:]
    per = ns.view(N - 1, len(stages)).mean(dim=0) / 1e3
    return {st.name: float(us) for st, us in zip(stages, per.cpu())}, mel


# launches of any variant, and of each variant
fused_cost.launches = 0
fused_cost.launches_dots = 0
fused_cost.launches_lstm = 0
fused_cost.launches_attn = 0
