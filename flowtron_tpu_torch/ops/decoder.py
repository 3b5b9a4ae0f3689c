"""K1: one flow's whole inverse AR scan in one host call (port of
flowtron_tpu/ops/decoder_pallas.py: ``pack_flow_weights`` and
``fused_flow_infer``).

On CUDA tensors ``fused_flow_infer`` makes one persistent cooperative
launch of ``csrc/decoder.cu`` (its note says what bounds it and how the
design answers), its stages split over the blocks as ``k1_plan`` says; on
CPU tensors it runs ``fused_flow_infer_reference``, the plain PyTorch
version of the same math on the same packed weights.

Supported subset, as on the TPU: no attention prior, no cumulative or
external attention, unquantized weights, scalar temperature. The weights
are packed in fp32 or bf16 (``pack_flow_weights(flow, dtype)``; the
Pallas kernel computes in the params' dtype, bf16 under the JAX server's
``--bf16``). The bf16 body (``fused_flow_infer_launch``'s bf16 flag)
takes the matrices, k_proj and vals bf16; state, softmax, gate and the
affine inversion fp32, the activations rounded to bf16 where the Pallas
body casts them (each dot's input, q + k and its tanh, the context); mel,
attn and gates come out fp32, as the Pallas kernel's ``out_shape``.

Early exit (``early_exit=True``): once every stream has finished — its
gate fired above ``gate_threshold`` or its frame index reached
``n_valid_in`` — every later frame does no work and writes mel = 0,
attn = 0, gate = 1. Frames up to each stream's finish equal the
``early_exit=False`` run. The TPU kernel decides this per 16-frame chunk;
here it is decided per frame.
"""

import ctypes
import functools
from collections import namedtuple

import torch
import torch.nn.functional as F

from flowtron_tpu_torch.ops import _build
from flowtron_tpu_torch.ops._layout import interleave_gates

MASK_VALUE = -1e9
# csrc/decoder.cu's limits: decoder LSTM layers, dense layers, attention
# partials, batch rows a pass over the weights
MAX_LAYERS, MAX_DENSE, MAX_PARTS, MAX_ROWS = 4, 4, 16, 8

K1Stage = namedtuple("K1Stage", "name jobs bounds")
K1Stage.__doc__ = """One dependent stage of K1's frame: ``jobs`` its
matrices as (name, rows, streamed floats a row); ``bounds[j]`` splits
job j's row quads over the blocks, block i taking quads ``bounds[j][i]``
up to ``bounds[j][i + 1]``."""
K1Plan = namedtuple("K1Plan", "stages n_blocks")


def _pad4(n):
    return (n + 3) // 4 * 4


def _padk(n, bf16=False):
    """A packed row's length: 16 bytes, a multiple of 4 fp32 or 8 bf16
    elements (csrc/decoder.cu:padk)."""
    return (n + 7) // 8 * 8 if bf16 else _pad4(n)


def _pad_cols(w, n):
    return F.pad(w, (0, n - w.shape[-1]))


def _pack_lstm(w_ih, w_hh, b_ih, b_hh, dtype=torch.float32):
    """(4H, K) + (4H, H) torch-layout LSTM weights -> the input half (4H,
    P(K)) and the recurrent half (4H, P(H)) in ``dtype``, each with row
    4u + g = gate g of unit u, and the pre-summed bias (summed in the
    params' dtype, then cast to ``dtype``, as the Pallas packer's
    ``(b_ih + b_hh).astype(dtype)``) interleaved the same way, in fp32.
    The halves are apart so that a block's rows of either are one
    contiguous range."""
    H = w_hh.shape[1]
    bf = dtype == torch.bfloat16
    return (interleave_gates(_pad_cols(w_ih.to(dtype),
                                       _padk(w_ih.shape[1], bf)))
            .contiguous(),
            interleave_gates(_pad_cols(w_hh.to(dtype), _padk(H, bf)))
            .contiguous(),
            interleave_gates((b_ih + b_hh).to(dtype).float()).contiguous())


@torch.no_grad()
def pack_flow_weights(flow, dtype=None):
    """Flatten one ``ARStep`` module into the kernel's packed layout
    (documented at ``fused_flow_infer_launch`` in csrc/decoder.cu), its
    matrices in ``dtype`` (default: the flow's own, as the Pallas
    packer's ``dtype=None``): fp32, or bf16 for the bf16 body. The vectors
    (biases, v, the gate row) are fp32 tensors holding ``dtype`` values.

    Rows are padded to 16 bytes (4 fp32 or 8 bf16 elements) so every row
    starts 16-byte aligned; the result is new storage, never a view.
    """
    H = flow.lstm.hidden_size
    att = flow.attention_layer
    head_w = flow.conv.weight[:, :, 0]                    # (2M, H)
    M = head_w.shape[0] // 2
    dtype = dtype or flow.attention_lstm.layer_weights(0)[0].dtype
    bf = dtype == torch.bfloat16
    att_wi, att_wh, att_b = _pack_lstm(
        *flow.attention_lstm.layer_weights(0), dtype=dtype)

    def rows(w):                                          # (out, P(in))
        return _pad_cols(w.to(dtype), _padk(w.shape[1], bf)).contiguous()

    def vec(v):
        return v.to(dtype).float().contiguous()

    out = {
        "att_wi": att_wi, "att_wh": att_wh, "att_b": att_b,
        "q_w": rows(att.query.linear_layer.weight),
        "q_b": torch.zeros(att.query.linear_layer.weight.shape[0],
                           device=head_w.device),
        "v_w": vec(att.v.linear_layer.weight[0].clone()),
        "lstm": [_pack_lstm(*flow.lstm.layer_weights(k), dtype=dtype)
                 for k in range(flow.lstm.num_layers)],
        "dense": [(rows(lin.linear_layer.weight),
                   vec(lin.linear_layer.bias.clone()))
                  for lin in flow.dense_layer.layers],
        # (2M, H) -> rows (2m, 2m+1) = (log_s_m, b_m)
        "head_w": rows(head_w.reshape(2, M, H).transpose(0, 1)
                       .reshape(2 * M, H)),
        "head_b": vec(flow.conv.bias.reshape(2, M).t().reshape(-1)),
    }
    if hasattr(flow, "gate_layer"):
        out["gate_w"] = vec(flow.gate_layer.linear_layer.weight[0].clone())
        out["gate_b"] = vec(flow.gate_layer.linear_layer.bias.clone())
    return out


@functools.lru_cache(maxsize=64)
def k1_plan(B, M, H, D, n_layers, n_dense, n_blocks):
    """Split every stage of K1's frame over ``n_blocks`` blocks by bytes.

    The stages, in csrc/decoder.cu's order (``fused_flow_infer_launch``
    builds the same list): the attention LSTM's input half with decoder
    layers 1..'s recurrent halves W_hh . h(t - 1); the query with layer
    0's recurrent half; the attention LSTM's recurrent half (beside the
    attention partials); each decoder layer's input half; each dense
    layer; the head. A row quad is four rows (one LSTM unit's gates, or
    four outputs) of one job's matrix, and all quads of a job stream the
    same bytes, so each job's quads are split evenly: block i takes the
    contiguous range from i * Q // n_blocks, at most one quad over the
    mean, and every block streams about 1 / n_blocks of every stage. (A
    split of a stage's bytes alone would give one block a hundred of the
    attention LSTM's narrow quads, each a round trip of its own.) ``B``
    checks the sizes only: every quad is read once for each group of up
    to 8 batch rows, on every block alike. Returns a K1Plan."""
    if min(B, M, H, D, n_layers, n_blocks) < 1 or n_dense < 0:
        raise ValueError("k1_plan: every size must be positive")
    Mp, Hp, Lp = _pad4(M), _pad4(H), _pad4(H + D)
    rec = [(f"rec_{l}", 4 * H, Hp) for l in range(n_layers)]
    stages = [("att", [("att_ih", 4 * H, Mp)] + rec[1:]),
              ("query", [("q", D, Hp), rec[0]]),
              ("attn", [("rec_att", 4 * H, Hp)])]
    stages += [(f"lstm_{l}", [(f"ih_{l}", 4 * H, Lp if l == 0 else Hp)])
               for l in range(n_layers)]
    stages += [(f"dense_{i}", [(f"dense_{i}", H, Hp)])
               for i in range(n_dense)]
    stages += [("head", [("head", 2 * M, Hp)])]
    return K1Plan(tuple(
        K1Stage(name, tuple(jobs), tuple(
            tuple(i * -(-rows // 4) // n_blocks for i in range(n_blocks + 1))
            for _, rows, _ in jobs))
        for name, jobs in stages), n_blocks)


def k1_bounds_array(plan):
    """The plan as csrc/decoder.cu reads it: (stages, MAX_LAYERS jobs,
    n_blocks + 1) quad boundaries, flattened; missing jobs are empty."""
    flat = []
    for st in plan.stages:
        for j in range(MAX_LAYERS):
            flat += (st.bounds[j] if j < len(st.bounds)
                     else (0,) * (plan.n_blocks + 1))
    return flat


def k1_attn_parts(B, Tk, n_blocks):
    """Attention partials a frame: each of these blocks takes a range of
    key positions of every batch row. Every block of the next stage reads
    all of them (parts x rows x D floats), so fewer for more rows."""
    return min(Tk, n_blocks, MAX_PARTS, max(4, 32 // min(B, MAX_ROWS)))


def k1_attn_slices(B, Tk, D, n_blocks):
    """Channel slices of each attention partial: every (row, key range,
    slice) is one block's slot, each slice computing its keys' scores
    again and its channels of the context, so that B x parts x slices
    fills the blocks (at least 32 channels a slice)."""
    parts = k1_attn_parts(B, Tk, n_blocks)
    return max(1, min(D // 32, n_blocks // (B * parts)))


def _is_bf16(w):
    return w["att_wi"].dtype == torch.bfloat16


def _dims(w):
    H = w["att_wh"].shape[0] // 4
    M = w["head_b"].shape[0] // 2
    D = w["q_w"].shape[0]
    return M, H, D


def fused_flow_infer_reference(weights, residual, k_proj, vals, key_mask,
                               temperature, early_exit=False,
                               gate_threshold=1e6, n_valid_in=None):
    """Plain PyTorch version of ``fused_flow_infer`` (same arguments, same
    packed weights, same outputs). With a bf16 pack it rounds to bf16 at
    the kernel's points (the Pallas body's casts): each dot's input, q
    (and q + k, and its tanh), the context, and the latents."""
    w = weights
    N, B, _ = residual.shape
    M, H, D = _dims(w)
    Tk = k_proj.shape[1]
    dev = residual.device
    if n_valid_in is None:
        n_valid_in = torch.full((B,), N, dtype=torch.int32, device=dev)
    bf = w["att_wi"].dtype == torch.bfloat16
    if bf:
        def rnd(t):
            return t.to(torch.bfloat16).float()
        residual = rnd(residual)
        k_proj, vals = k_proj.float(), vals.float()
        w = dict(w, lstm=[(wi.float(), wh.float(), lb)
                          for wi, wh, lb in w["lstm"]],
                 dense=[(dw.float(), db) for dw, db in w["dense"]],
                 **{k: w[k].float() for k in ("att_wi", "att_wh", "q_w",
                                               "head_w")})
    else:
        def rnd(t):
            return t

    def cell(wi, wh, bias, x, h, c):
        g = (_pad_cols(rnd(x), wi.shape[1]) @ wi.t()
             + _pad_cols(rnd(h), wh.shape[1]) @ wh.t() + bias).view(B, H, 4)
        c = torch.sigmoid(g[..., 1]) * c \
            + torch.sigmoid(g[..., 0]) * torch.tanh(g[..., 2])
        return torch.sigmoid(g[..., 3]) * torch.tanh(c), c

    def matvec(wt, bias, x):
        return _pad_cols(rnd(x), wt.shape[1]) @ wt.t() + bias

    mel = residual.new_zeros(N, B, M)
    attn = residual.new_zeros(N, B, Tk)
    gates = residual.new_zeros(N, B)
    zeros = residual.new_zeros(B, H)
    h_att, c_att = zeros, zeros
    hs = [zeros] * len(w["lstm"])
    cs = [zeros] * len(w["lstm"])
    prev = residual.new_zeros(B, M)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(N):
        h_att, c_att = cell(w["att_wi"], w["att_wh"], w["att_b"], prev,
                            h_att, c_att)
        q = matvec(w["q_w"], w["q_b"], h_att)
        scores = rnd(torch.tanh(rnd(rnd(q)[:, None, :] + k_proj))) @ w["v_w"]
        scores = scores / temperature
        scores = torch.where(key_mask > 0.5, scores, MASK_VALUE)
        e = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
        a = e / e.sum(dim=-1, keepdim=True)
        ctx = rnd(torch.einsum("bk,bkd->bd", a, vals))
        x = torch.cat([h_att, ctx], dim=-1)
        gate = torch.sigmoid(rnd(x) @ w["gate_w"] + w["gate_b"]) \
            if "gate_w" in w else residual.new_zeros(B)
        for k, (wi, wh, lb) in enumerate(w["lstm"]):
            hs[k], cs[k] = cell(wi, wh, lb, x, hs[k], cs[k])
            x = hs[k]
        for dw, db in w["dense"]:
            x = torch.tanh(matvec(dw, db, x))
        out2 = matvec(w["head_w"], w["head_b"], x).view(B, M, 2)
        prev = (residual[t] - out2[..., 1]) * torch.exp(-out2[..., 0])
        mel[t], attn[t], gates[t] = prev, a, gate
        if early_exit:
            done |= (gate > gate_threshold) | (t + 1 >= n_valid_in)
            if bool(done.all()):
                gates[t + 1:] = 1.0
                break
    return mel, attn, gates


def _lib():
    lib = _build.load_library("decoder")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_flow_infer_launch.argtypes = (
            [i] + [p] * 11 + [pp, pp, pp, i, pp, pp, i] + [p] * 10
            + [i, i, i, p] + [i] * 6 + [f, f, i, p])
        lib.fused_flow_infer_launch.restype = i
        lib.decoder_workspace_floats.argtypes = [i] * 6
        lib.decoder_workspace_floats.restype = ctypes.c_longlong
        lib.decoder_workspace_ints.argtypes = [i]
        lib.decoder_workspace_ints.restype = i
        lib.decoder_coresident_blocks.argtypes = [i]
        lib.decoder_coresident_blocks.restype = i
        lib.decoder_prefetch_bytes.argtypes = [i] * 8
        lib.decoder_prefetch_bytes.restype = ctypes.c_longlong
        lib.decoder_barrier_bench.argtypes = [i, i, i, p, p]
        lib.decoder_barrier_bench.restype = i
        lib.decoder_error_string.argtypes = [i]
        lib.decoder_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(lib, err, what):
    if err:
        raise RuntimeError(f"{what} failed: "
                           + lib.decoder_error_string(err).decode())


_bounds = {}


def _bounds_tensor(plan, dev):
    key = (plan, dev)
    if key not in _bounds:
        _bounds[key] = torch.tensor(k1_bounds_array(plan), dtype=torch.int32,
                                    device=dev)
    return _bounds[key]


def k1_blocks(dev):
    """Blocks of K1's launch on ``dev``: one a SM."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def barrier_bench(mode, iters, dev, n_blocks=None):
    """Launch ``iters`` grid barriers over ``n_blocks`` (default
    ``k1_blocks``) blocks of 256 threads, one cooperative launch: mode 0
    the barrier K1 uses, 1 cooperative_groups' grid sync. For timing
    them; returns nothing."""
    lib = _lib()
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    _check(lib, lib.decoder_barrier_bench(
        int(mode), int(iters), int(n_blocks or k1_blocks(dev)),
        counter.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        "decoder_barrier_bench")


def k1_launch_info(weights, B, Tk, dev):
    """How ``fused_flow_infer`` launches on ``dev`` for these weights, B
    and Tk: its blocks, attention partials and channel slices, the bytes
    of weights a block prefetches for a stage at most, and the bytes kept
    resident in shared memory across frames (none: every frame streams
    the weights)."""
    M, H, D = _dims(weights)
    n_blocks = k1_blocks(dev)
    parts = k1_attn_parts(B, Tk, n_blocks)
    return dict(blocks=n_blocks, attn_parts=parts,
                attn_slices=k1_attn_slices(B, Tk, D, n_blocks),
                prefetch_bytes_per_block=_lib().decoder_prefetch_bytes(
                    B, M, H, D, Tk, len(weights["lstm"]), parts,
                    int(_is_bf16(weights))),
                resident_bytes=0)


def k1_stage_split(weights, residual, k_proj, vals, key_mask, temperature):
    """One launch of K1 on CUDA tensors with its stage clock on: the mean
    us a frame from one grid barrier to the next, by stage (k1_plan's
    names), frames 1 .. N - 1, as block 0 sees them. A measurement: the
    launch is not counted in ``fused_flow_infer.launches``."""
    N, B, M = residual.shape
    _, H, D = _dims(weights)
    n_stages = 4 + len(weights["lstm"]) + len(weights["dense"])
    clock = torch.zeros(N * n_stages, dtype=torch.int64,
                        device=residual.device)
    _launch(weights, residual, k_proj, vals, key_mask, temperature, False,
            1e6, None, clock)
    ns = clock.flatten().double().diff()[n_stages - 1:]
    per = ns.view(N - 1, n_stages).mean(dim=0) / 1e3
    plan = k1_plan(B, M, H, D, len(weights["lstm"]), len(weights["dense"]),
                   k1_blocks(residual.device))
    return {st.name: float(us) for st, us in zip(plan.stages, per.cpu())}


def fused_flow_infer(weights, residual, k_proj, vals, key_mask, temperature,
                     early_exit=False, gate_threshold=1e6, n_valid_in=None):
    """Run one flow's full inverse scan.

    Args:
      weights: dict from ``pack_flow_weights``.
      residual: (N, B, M) latents. k_proj / vals: (B, Tk, D) from
        ``attention_precompute``. key_mask: (B, Tk) float, 1 = valid.
      temperature: scalar. gate_threshold / n_valid_in ((B,) ints or None
        for N): only consulted when ``early_exit``.

    Returns (mel (N, B, M), attn (N, B, Tk), gates (N, B)), float32.
    On CPU tensors this is ``fused_flow_infer_reference``; on CUDA tensors
    it makes one cooperative launch of csrc/decoder.cu, one block a SM
    (``fused_flow_infer_launch``, its fp32 body for an fp32 pack, its
    bf16 body for a bf16 one, whose k_proj and vals are bf16 too), or
    raises (also when the card cannot hold that many blocks at once).
    """
    if residual.device.type == "cpu":
        return fused_flow_infer_reference(
            weights, residual, k_proj, vals, key_mask, temperature,
            early_exit, gate_threshold, n_valid_in)
    if residual.device.type != "cuda":
        raise ValueError(f"no kernel for device {residual.device}")
    out = _launch(weights, residual, k_proj, vals, key_mask, temperature,
                  early_exit, gate_threshold, n_valid_in)
    fused_flow_infer.launches += 1
    if _is_bf16(weights):
        fused_flow_infer.launches_bf16 += 1
    return out


def _launch(weights, residual, k_proj, vals, key_mask, temperature,
            early_exit, gate_threshold, n_valid_in, clock=None):
    dev = residual.device
    N, B, M = residual.shape
    M_w, H, D = _dims(weights)
    Tk = k_proj.shape[1]
    if M_w != M:
        raise ValueError(f"residual has {M} mel channels, weights {M_w}")
    n_layers, n_dense = len(weights["lstm"]), len(weights["dense"])
    if not (1 <= n_layers <= MAX_LAYERS and n_dense <= MAX_DENSE):
        raise ValueError(f"the kernel takes 1 to {MAX_LAYERS} decoder "
                         f"LSTM layers and at most {MAX_DENSE} dense "
                         f"layers, not {n_layers} and {n_dense}")
    bf = _is_bf16(weights)
    wdt = torch.bfloat16 if bf else torch.float32   # matrices, kp, vals
    if bf:
        residual = residual.float()     # bf16 latents, exactly
    Hp = _padk(H, bf)
    _build.check_tensor("residual", residual, (N, B, M), dev)
    _build.check_tensor("k_proj", k_proj, (B, Tk, D), dev, dtype=wdt)
    _build.check_tensor("vals", vals, (B, Tk, D), dev, dtype=wdt)
    _build.check_tensor("key_mask", key_mask, (B, Tk), dev)
    expect = {
        "att_wi": (4 * H, _padk(M, bf)), "att_wh": (4 * H, Hp),
        "q_w": (D, Hp), "head_w": (2 * M, Hp),
    }
    vectors = {"att_b": (4 * H,), "q_b": (D,), "v_w": (D,),
               "head_b": (2 * M,)}
    has_gate = "gate_w" in weights
    if has_gate:
        vectors.update(gate_w=(H + D,), gate_b=(1,))
    for k, shape in expect.items():
        _build.check_tensor(k, weights[k], shape, dev, dtype=wdt)
    for k, shape in vectors.items():
        _build.check_tensor(k, weights[k], shape, dev)
    for k, (wi, wh, lb) in enumerate(weights["lstm"]):
        kx = H + D if k == 0 else H
        _build.check_tensor(f"lstm[{k}].wi", wi, (4 * H, _padk(kx, bf)), dev,
                            dtype=wdt)
        _build.check_tensor(f"lstm[{k}].wh", wh, (4 * H, Hp), dev, dtype=wdt)
        _build.check_tensor(f"lstm[{k}].b", lb, (4 * H,), dev)
    for k, (dw, db) in enumerate(weights["dense"]):
        _build.check_tensor(f"dense[{k}].w", dw, (H, Hp), dev, dtype=wdt)
        _build.check_tensor(f"dense[{k}].b", db, (H,), dev)
    if n_valid_in is None:
        nvin = torch.full((B,), N, dtype=torch.int32, device=dev)
    else:
        nvin = n_valid_in.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(nvin.shape) != (B,):
            raise ValueError(f"n_valid_in has shape {tuple(nvin.shape)}")

    lib = _lib()
    n_blocks = k1_blocks(dev)
    parts = k1_attn_parts(B, Tk, n_blocks)
    most = lib.decoder_coresident_blocks(int(bf))
    if most < n_blocks:
        raise RuntimeError(
            f"K1 needs {n_blocks} co-resident blocks (one a SM) for its "
            f"cooperative launch; this card holds {most}: the shared "
            "memory or registers a block takes exceed an SM's")
    if lib.decoder_prefetch_bytes(B, M, H, D, Tk, n_layers, parts,
                                  int(bf)) < 0:
        raise ValueError(f"widths too large for K1 (H={H}, D={D}, "
                         f"Tk={Tk}): its staged inputs pass the shared "
                         "memory a block may have")
    bounds = _bounds_tensor(
        k1_plan(B, M, H, D, n_layers, n_dense, n_blocks), dev)
    mel = torch.empty(N, B, M, device=dev)
    attn = torch.empty(N, B, Tk, device=dev)
    gates = torch.empty(N, B, device=dev)
    work = torch.empty(lib.decoder_workspace_floats(B, H, D, Tk, n_layers,
                                                    parts), device=dev)
    iwork = torch.empty(lib.decoder_workspace_ints(B), dtype=torch.int32,
                        device=dev)

    def ptrs(ts):
        return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])

    gate_w = weights["gate_w"].data_ptr() if has_gate else None
    gate_b = weights["gate_b"].data_ptr() if has_gate else None
    _check(lib, lib.fused_flow_infer_launch(
        int(bf), residual.data_ptr(), k_proj.data_ptr(), vals.data_ptr(),
        key_mask.data_ptr(), nvin.data_ptr(),
        weights["att_wi"].data_ptr(), weights["att_wh"].data_ptr(),
        weights["att_b"].data_ptr(),
        weights["q_w"].data_ptr(), weights["q_b"].data_ptr(),
        weights["v_w"].data_ptr(),
        ptrs([wi for wi, _, _ in weights["lstm"]]),
        ptrs([wh for _, wh, _ in weights["lstm"]]),
        ptrs([lb for _, _, lb in weights["lstm"]]), n_layers,
        ptrs([dw for dw, _ in weights["dense"]]),
        ptrs([db for _, db in weights["dense"]]), n_dense,
        weights["head_w"].data_ptr(), weights["head_b"].data_ptr(),
        gate_w, gate_b, mel.data_ptr(), attn.data_ptr(), gates.data_ptr(),
        work.data_ptr(), iwork.data_ptr(), bounds.data_ptr(), n_blocks,
        parts, k1_attn_slices(B, Tk, D, n_blocks),
        None if clock is None else clock.data_ptr(), N, B, M, H, D, Tk,
        float(temperature), float(gate_threshold), int(bool(early_exit)),
        torch.cuda.current_stream(dev).cuda_stream),
        "fused_flow_infer_launch")
    return mel, attn, gates


# launches of either body, and of the bf16 body alone
fused_flow_infer.launches = 0
fused_flow_infer.launches_bf16 = 0
