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
takes the matrices as a K1 pack (``k1_pack`` laid out by
``k1_resident_plan`` at the launch's B: what fits stays in shared memory
for the whole launch, the rest streams through a ring; a bf16 pack made
on the card holds its matrices only so), k_proj and vals bf16, its dots
on the tensor cores; state, softmax, gate and the affine inversion fp32,
the activations rounded to bf16 where the Pallas body casts them (each
dot's input, q + k and its tanh, the context); mel, attn and gates come
out fp32, as the Pallas kernel's ``out_shape``.

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
    elements (csrc/decoder.cu:padk for fp32; the bf16 body reads the K1
    pack, whose rows ``_k1_row_bytes`` pads further)."""
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
    starts 16-byte aligned; the result is new storage, never a view. A
    bf16 pack of a flow on the card holds its matrices only as the K1
    packs that the bf16 body reads (``k1``: one a layout, at first the
    one for B=1; ``k1_pack_for``), the matrices' entries None: the plain
    version unpacks them (``k1_unpack``).
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
    target = k1_target(head_w.device) if bf else None
    return out if target is None else _to_k1(out, target)


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


# The bf16 body's shared memory (csrc/decoder.cu): bytes kept for the
# static arrays, and floats kept for an attention slot's scores (a longer
# slot's scores go to global memory).
K1_BF16_STATIC = 8192
K1_SLOT_FLOATS = 512
_TAB = 16       # ints of k1_resident_layout's table a (stage, block)

K1ResidentPlan = namedtuple(
    "K1ResidentPlan", "kplan row_bytes fixed_bytes budget nres ring "
    "res_bytes ring_bytes stream_bytes")
K1ResidentPlan.__doc__ = """Where the bf16 body's weight rows lie
(``k1_resident_plan``). ``row_bytes[s][j]``: bytes between two rows of
job j of stage s, in shared memory and in the K1 pack; ``nres[s][j][b]``:
the first quads of block b's range of that job that stay in its shared
memory for the whole launch (the rest are streamed); ``ring[b]``: the
bytes of block b's streaming ring; ``res_bytes[b]``: its resident bytes;
``ring_bytes[s][b]``: the bytes of its streamed rows of stage s that are
copied into the ring (whole rows; the rest are read from the pack in the
dot); ``stream_bytes[s][b]``: all its streamed bytes of stage s."""

K1Pack = namedtuple("K1Pack", "plan pack table")
K1Pack.__doc__ = """A bf16 flow's matrices as the bf16 body reads them
(``k1_pack``): its K1ResidentPlan, the K1 pack (one bf16 tensor) and the
table of where each (stage, block)'s rows lie (int32, flattened)."""


def _row_stride(n):
    """Bytes between two rows of n bytes (a multiple of 64) in shared
    memory: an odd multiple of 64, so that a quarter-warp's 16-byte loads
    of two neighbouring rows fill the 32 banks once."""
    return n if n % 128 else n + 64


def _k1_row_bytes(k):
    """A bf16 row of k weights in the K1 pack and in shared memory: padded
    to 64 bytes (one stretch of two m16n8k16 tiles), then to an odd
    multiple of 64 (csrc/decoder.cu:wstride)."""
    return _row_stride(-(-k // 32) * 64)


def _job_k(name, M, H, D):
    """The length of job ``name``'s rows (k1_plan's names)."""
    return M if name == "att_ih" else H + D if name == "ih_0" else H


def k1_fixed_bytes(B, M, H, D, n_layers):
    """The bf16 body's dynamic shared memory before its resident rows,
    the same at every Tk: the widest stage's staged inputs as bf16 rows
    (min(B, 8) of each job's row bytes), the attention slot's query row
    and K1_SLOT_FLOATS scores, the combine's weights, sums and maxima, v
    and the gate row, as fp32; rounded up to 128 bytes
    (csrc/decoder.cu:k1_fixed_floats)."""
    stages = [[M] + [H] * (n_layers - 1), [H, H], [H + D]]
    xs = max(min(B, MAX_ROWS) * sum(_k1_row_bytes(k) for k in st)
             for st in stages)
    floats = (xs // 4 + 2 * _pad4(D) + K1_SLOT_FLOATS
              + 2 * MAX_ROWS * MAX_PARTS + 2 * MAX_ROWS + _pad4(H + D))
    return -(-4 * floats // 128) * 128


def _fill(stage_quads, budget):
    """Water-filling of one block's shared memory. ``stage_quads``: per
    stage the bytes of the block's quads in order. Every stage streams at
    most a level x of bytes, its first quads staying resident; the ring
    holds the largest stage's streamed bytes. Returns (resident quads a
    stage, ring bytes) at the least x for which the resident rows and the
    ring fit in ``budget``, or with nothing resident and the ring at the
    budget when even x = the largest stage does not fit."""
    suf = []
    for qs in stage_quads:
        s = [0] * (len(qs) + 1)
        for i in range(len(qs) - 1, -1, -1):
            s[i] = s[i + 1] + qs[i]
        suf.append(s)
    for x in sorted({v for s in suf for v in s}):
        # the least n with bytes from quad n on at most x
        n = [next(i for i, v in enumerate(s) if v <= x) for s in suf]
        res = sum(s[0] - s[i] for s, i in zip(suf, n))
        ring = max((s[i] for s, i in zip(suf, n)), default=0)
        if res + ring <= budget:
            return tuple(n), ring
    return (0,) * len(suf), max(0, budget)


@functools.lru_cache(maxsize=64)
def k1_resident_plan(B, M, H, D, n_layers, n_dense, n_blocks, smem_bytes):
    """Which of each block's row quads of K1's bf16 body stay in its
    shared memory for the whole launch (K1ResidentPlan), for a flow of
    these widths at B batch rows on a card with ``n_blocks`` SMs.

    ``smem_bytes`` is the card's opt-in shared memory a block (232,448 on
    an H100). A block's budget is that, less ``K1_BF16_STATIC``, less the
    staged inputs at this B (``k1_fixed_bytes``); it holds the resident
    rows and a ring that the streamed rows of each stage are copied into
    while the block waits at the barrier before it. Order of choice: the
    stages that would stream the most bytes give up rows first, until
    every stage streams at most the same level of bytes (``_fill``): a
    stage waits on its ring copy, so the frame's longest wait is the
    largest stage's streamed bytes, and the ring must be that large. Past
    8 batch rows the groups of 8 reuse the same resident rows, so B counts
    up to 8. (One plan at 8 rows for every B keeps 5.5 MB less resident
    at B=1 and ran B=1 7% slower on the H100, PERF.md section 6.)"""
    kplan = k1_plan(B, M, H, D, n_layers, n_dense, n_blocks)
    row_bytes = tuple(tuple(_k1_row_bytes(_job_k(name, M, H, D))
                            for name, _, _ in st.jobs)
                      for st in kplan.stages)
    fixed = k1_fixed_bytes(B, M, H, D, n_layers)
    budget = smem_bytes - K1_BF16_STATIC - fixed
    if budget < 0:
        raise ValueError(f"widths too large for K1 (H={H}, D={D}): its "
                         "staged inputs pass the shared memory a block "
                         "may have")
    nres = [[[0] * n_blocks for _ in st.jobs] for st in kplan.stages]
    ring, res_bytes = [0] * n_blocks, [0] * n_blocks
    ring_bytes = [[0] * n_blocks for _ in kplan.stages]
    stream_bytes = [[0] * n_blocks for _ in kplan.stages]
    for b in range(n_blocks):
        quads = [[(j, 4 * row_bytes[s][j]) for j, bnd in enumerate(st.bounds)
                  for _ in range(bnd[b + 1] - bnd[b])]
                 for s, st in enumerate(kplan.stages)]
        n, ring[b] = _fill(tuple(tuple(q for _, q in qs) for qs in quads),
                           budget)
        for s, qs in enumerate(quads):
            for j, _ in qs[:n[s]]:
                nres[s][j][b] += 1
            res_bytes[b] += sum(q for _, q in qs[:n[s]])
            # the streamed rows, whole rows into the ring while they fit
            for j, q in qs[n[s]:]:
                for _ in range(4):
                    r = row_bytes[s][j]
                    if ring_bytes[s][b] == stream_bytes[s][b] \
                            and ring_bytes[s][b] + r <= ring[b]:
                        ring_bytes[s][b] += r
                    stream_bytes[s][b] += r
    return K1ResidentPlan(
        kplan, row_bytes, fixed, budget,
        tuple(tuple(tuple(x) for x in st) for st in nres), tuple(ring),
        tuple(res_bytes), tuple(map(tuple, ring_bytes)),
        tuple(map(tuple, stream_bytes)))


def k1_resident_layout(rplan):
    """The K1 pack's layout for a plan: every block's resident rows (in
    stage, job, quad order), then every block's streamed rows, stage by
    stage, so that a flow's streamed rows are one contiguous range.
    Returns (table, chunks, stream_offset): ``table`` the ints that
    csrc/decoder.cu reads, (stages, blocks, 16): per job (up to 4) the
    resident quads, their byte offset in the block's resident rows and the
    byte offset of its streamed rows in the stage's streamed range, then
    the streamed range's byte offset in the pack, the bytes of it copied
    into the ring, and (the same on every stage) the block's resident
    rows' offset in the pack and their bytes; ``chunks`` (stage, job,
    first quad, quads) in pack order; ``stream_offset`` the byte at which
    the streamed rows begin."""
    kp = rplan.kplan
    n_st, nb = len(kp.stages), kp.n_blocks
    tab = [[[0] * _TAB for _ in range(nb)] for _ in range(n_st)]
    chunks, off = [], 0
    for b in range(nb):
        base = off
        for s, st in enumerate(kp.stages):
            for j, bnd in enumerate(st.bounds):
                n = rplan.nres[s][j][b]
                tab[s][b][4 + j] = off - base
                if n:
                    chunks.append((s, j, bnd[b], n))
                    off += 4 * n * rplan.row_bytes[s][j]
        for s in range(n_st):
            tab[s][b][14], tab[s][b][15] = base, off - base
    stream_offset = off
    for b in range(nb):
        for s, st in enumerate(kp.stages):
            tab[s][b][12], tab[s][b][13] = off, rplan.ring_bytes[s][b]
            for j, bnd in enumerate(st.bounds):
                n = rplan.nres[s][j][b]
                tab[s][b][j] = n
                tab[s][b][8 + j] = off - tab[s][b][12]
                rest = bnd[b + 1] - bnd[b] - n
                if rest:
                    chunks.append((s, j, bnd[b] + n, rest))
                    off += 4 * rest * rplan.row_bytes[s][j]
    if off >= 2 ** 31:
        raise ValueError("K1's pack passes 2 GB")
    return tab, chunks, stream_offset


def _job_matrices(weights):
    """The packed matrices by k1_plan's job names."""
    w = weights
    out = {"att_ih": w["att_wi"], "rec_att": w["att_wh"], "q": w["q_w"],
           "head": w["head_w"]}
    for l, (wi, wh, _) in enumerate(w["lstm"]):
        out[f"ih_{l}"], out[f"rec_{l}"] = wi, wh
    for i, (dw, _) in enumerate(w["dense"]):
        out[f"dense_{i}"] = dw
    return out


def k1_pack(mats, rplan):
    """The K1 pack of a flow's bf16 matrices (by k1_plan's job names, as
    ``_job_matrices`` of a bf16 ``pack_flow_weights`` result gives them):
    every job's rows padded with zeros to ``row_bytes`` (and its last quad
    to four rows), laid out as ``k1_resident_layout`` says, one bf16
    tensor. Returns a K1Pack on the matrices' device."""
    tab, chunks, _ = k1_resident_layout(rplan)
    padded = {}
    for s, st in enumerate(rplan.kplan.stages):
        for j, (name, rows, _) in enumerate(st.jobs):
            w = mats[name]
            padded[s, j] = F.pad(w, (0, rplan.row_bytes[s][j] // 2
                                     - w.shape[1], 0, (-rows) % 4))
    pack = torch.cat([padded[s, j][4 * q0:4 * (q0 + n)].reshape(-1)
                      for s, j, q0, n in chunks])
    table = torch.tensor(tab, dtype=torch.int32, device=pack.device)
    return K1Pack(rplan, pack, table.reshape(-1))


def k1_unpack(k1):
    """The matrices of a K1Pack by k1_plan's job names, as a bf16
    ``pack_flow_weights`` lays them out (rows padded to 8 elements): the
    inverse of ``k1_pack``, for the plain version."""
    rplan = k1.plan
    _, chunks, _ = k1_resident_layout(rplan)
    full, off = {}, 0
    for s, j, q0, n in chunks:
        ws = rplan.row_bytes[s][j] // 2
        name, rows, _ = rplan.kplan.stages[s].jobs[j]
        m = full.setdefault(name, k1.pack.new_empty(-(-rows // 4) * 4, ws))
        m[4 * q0:4 * (q0 + n)] = k1.pack[off:off + 4 * n * ws].view(-1, ws)
        off += 4 * n * ws
    M, H, D = _k1_dims(rplan)
    return {name: full[name][:rows, :_padk(_job_k(name, M, H, D), True)]
            .contiguous()
            for st in rplan.kplan.stages for name, rows, _ in st.jobs}


def _k1_dims(rplan):
    """(M, H, D) of the flow a plan was made for."""
    jobs = {name: rows for st in rplan.kplan.stages
            for name, rows, _ in st.jobs}
    return jobs["head"] // 2, jobs["att_ih"] // 4, jobs["q"]


def k1_target(dev):
    """(blocks, opt-in shared memory a block) that K1's bf16 body plans
    its rows for on ``dev``, or None off the card (where the plain
    version reads the matrices)."""
    if dev.type != "cuda":
        return None
    return k1_blocks(dev), _lib().decoder_smem_optin()


def _plan_at(weights, B, target):
    M, H, D = _dims(weights)
    return k1_resident_plan(min(B, MAX_ROWS), M, H, D, len(weights["lstm"]),
                            len(weights["dense"]), *target)


def _layout(rplan):
    """What a K1 pack's bytes depend on beside the flow: plans at two B
    with the same resident quads and rings share one pack."""
    return rplan.nres, rplan.ring


def _to_k1(out, target):
    """A bf16 pack for the card: its matrices replaced by their K1 packs
    (``out["k1"]``: by layout, at first only B=1's; ``k1_pack_for`` adds
    the others), ``out["k1_target"]`` the card's (blocks, shared memory a
    block), the matrices' entries None."""
    k1 = k1_pack(_job_matrices(out), _plan_at(out, 1, target))
    return dict(out, k1={_layout(k1.plan): k1}, k1_target=target,
                att_wi=None, att_wh=None, q_w=None, head_w=None,
                lstm=[(None, None, b) for _, _, b in out["lstm"]],
                dense=[(None, b) for _, b in out["dense"]])


def k1_pack_for(weights, B):
    """The K1Pack that the bf16 body reads at B batch rows, for a bf16
    pack made on the card: laid out by the plan for min(B, 8) rows. Plans
    that share a layout share its pack. A layout's pack is built from the
    flow's first at the first launch that needs it and kept in the flow's
    pack (so on its module, ``ARStep.packed_weights``): at flagship widths
    on an H100, B = 1-2, 3-4, 5, 6-7 and 8 give five layouts of 55.3 MB
    each (build time and bytes: ``chip_smoke.py --k1-bf16``)."""
    packs = weights["k1"]
    rplan = _plan_at(weights, B, weights["k1_target"])
    key = _layout(rplan)
    if key not in packs:
        packs[key] = k1_pack(k1_unpack(next(iter(packs.values()))), rplan)
    return packs[key]._replace(plan=rplan)


def _with_matrices(w):
    """A pack with its matrices (from a K1 pack when it holds them so)."""
    if w.get("k1") is None:
        return w
    mats = k1_unpack(next(iter(w["k1"].values())))
    w = {k: v for k, v in w.items() if k not in ("k1", "k1_target")}
    return dict(w, att_wi=mats["att_ih"], att_wh=mats["rec_att"],
                q_w=mats["q"], head_w=mats["head"],
                lstm=[(mats[f"ih_{l}"], mats[f"rec_{l}"], b)
                      for l, (_, _, b) in enumerate(w["lstm"])],
                dense=[(mats[f"dense_{i}"], b)
                       for i, (_, b) in enumerate(w["dense"])])


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
    return w.get("k1") is not None or w["att_wi"].dtype == torch.bfloat16


def _dims(w):
    H = w["att_b"].shape[0] // 4
    M = w["head_b"].shape[0] // 2
    D = w["q_b"].shape[0]
    return M, H, D


def fused_flow_infer_reference(weights, residual, k_proj, vals, key_mask,
                               temperature, early_exit=False,
                               gate_threshold=1e6, n_valid_in=None):
    """Plain PyTorch version of ``fused_flow_infer`` (same arguments, same
    packed weights, same outputs). With a bf16 pack it rounds to bf16 at
    the kernel's points (the Pallas body's casts): each dot's input, q
    (and q + k, and its tanh), the context, and the latents."""
    w = _with_matrices(weights)
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
            + [i, i, i, p] + [i] * 6 + [f, f, i, p, p, p])
        lib.fused_flow_infer_launch.restype = i
        lib.decoder_workspace_floats.argtypes = [i] * 8
        lib.decoder_workspace_floats.restype = ctypes.c_longlong
        lib.decoder_workspace_ints.argtypes = [i]
        lib.decoder_workspace_ints.restype = i
        lib.decoder_coresident_blocks.argtypes = [i]
        lib.decoder_coresident_blocks.restype = i
        lib.decoder_prefetch_bytes.argtypes = [i] * 8
        lib.decoder_prefetch_bytes.restype = ctypes.c_longlong
        lib.decoder_fixed_bytes.argtypes = [i] * 5
        lib.decoder_fixed_bytes.restype = ctypes.c_longlong
        lib.decoder_smem_optin.argtypes = []
        lib.decoder_smem_optin.restype = i
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


def k1_bytes(weights, B):
    """A pack's matrix bytes at B batch rows by where K1 reads them:
    resident in shared memory across the frames, streamed a frame (bf16:
    ``ring_bytes`` of them copied into a ring behind the barrier before
    their stage, the rest read from the pack in the dot;
    ``ring_per_block_max`` the largest block's ring), and the bytes of the
    packed matrices as they lie on the device. The fp32 body keeps
    nothing resident: every frame streams its matrices; so does a pack
    off the card. The bf16 body keeps what ``k1_resident_plan`` chose for
    B (``k1_pack_for``)."""
    if weights.get("k1") is None:
        packed = sum(t.numel() * t.element_size()
                     for t in _job_matrices(weights).values())
        return dict(resident_bytes=0, streamed_bytes_per_frame=packed,
                    packed_bytes=packed)
    k1 = k1_pack_for(weights, B)
    rp = k1.plan
    return dict(resident_bytes=sum(rp.res_bytes),
                streamed_bytes_per_frame=sum(map(sum, rp.stream_bytes)),
                ring_bytes_per_frame=sum(map(sum, rp.ring_bytes)),
                ring_per_block_max=max(rp.ring),
                packed_bytes=k1.pack.numel() * k1.pack.element_size())


def k1_launch_info(weights, B, Tk, dev):
    """How ``fused_flow_infer`` launches on ``dev`` for these weights, B
    and Tk: its blocks, attention partials and channel slices, the bytes
    of shared memory a block has beside its staged inputs (fp32: the
    buffer that a stage's rows are prefetched into; bf16: its resident
    rows and the ring), and where its matrices are read from
    (``k1_bytes``)."""
    M, H, D = _dims(weights)
    n_blocks = k1_blocks(dev)
    parts = k1_attn_parts(B, Tk, n_blocks)
    return dict(blocks=n_blocks, attn_parts=parts,
                attn_slices=k1_attn_slices(B, Tk, D, n_blocks),
                prefetch_bytes_per_block=_lib().decoder_prefetch_bytes(
                    B, M, H, D, Tk, len(weights["lstm"]), parts,
                    int(_is_bf16(weights))),
                **k1_bytes(weights, B))


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
    _build.check_tensor("residual", residual, (N, B, M), dev)
    _build.check_tensor("k_proj", k_proj, (B, Tk, D), dev, dtype=wdt)
    _build.check_tensor("vals", vals, (B, Tk, D), dev, dtype=wdt)
    _build.check_tensor("key_mask", key_mask, (B, Tk), dev)
    vectors = {"att_b": (4 * H,), "q_b": (D,), "v_w": (D,),
               "head_b": (2 * M,)}
    has_gate = "gate_w" in weights
    if has_gate:
        vectors.update(gate_w=(H + D,), gate_b=(1,))
    for k, shape in vectors.items():
        _build.check_tensor(k, weights[k], shape, dev)
    for k, (_, _, lb) in enumerate(weights["lstm"]):
        _build.check_tensor(f"lstm[{k}].b", lb, (4 * H,), dev)
    for k, (_, db) in enumerate(weights["dense"]):
        _build.check_tensor(f"dense[{k}].b", db, (H,), dev)
    n_blocks = k1_blocks(dev)
    k1 = None
    if bf:
        if weights.get("k1") is None:
            raise ValueError("a bf16 pack reaches K1 as its K1 pack: pack "
                             "the flow on the card (pack_flow_weights)")
        if weights["k1_target"][0] != n_blocks:
            raise ValueError("the K1 pack was laid out for a card of "
                             f"{weights['k1_target'][0]} SMs, not "
                             f"{n_blocks}: pack the flow on this card")
        k1 = k1_pack_for(weights, B)
        rp = k1.plan
        _build.check_tensor("k1.pack", k1.pack, (k1.pack.numel(),), dev,
                            dtype=torch.bfloat16)
        _build.check_tensor("k1.table", k1.table,
                            (len(rp.kplan.stages) * n_blocks * _TAB,), dev,
                            dtype=torch.int32)
    else:
        Hp = _pad4(H)
        expect = {"att_wi": (4 * H, _pad4(M)), "att_wh": (4 * H, Hp),
                  "q_w": (D, Hp), "head_w": (2 * M, Hp)}
        for k, shape in expect.items():
            _build.check_tensor(k, weights[k], shape, dev, dtype=wdt)
        for k, (wi, wh, _) in enumerate(weights["lstm"]):
            kx = H + D if k == 0 else H
            _build.check_tensor(f"lstm[{k}].wi", wi, (4 * H, _pad4(kx)), dev,
                                dtype=wdt)
            _build.check_tensor(f"lstm[{k}].wh", wh, (4 * H, Hp), dev,
                                dtype=wdt)
        for k, (dw, _) in enumerate(weights["dense"]):
            _build.check_tensor(f"dense[{k}].w", dw, (H, Hp), dev, dtype=wdt)
    if n_valid_in is None:
        nvin = torch.full((B,), N, dtype=torch.int32, device=dev)
    else:
        nvin = n_valid_in.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(nvin.shape) != (B,):
            raise ValueError(f"n_valid_in has shape {tuple(nvin.shape)}")

    lib = _lib()
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
    fixed = lib.decoder_fixed_bytes(B, M, H, D, n_layers) if bf else 0
    if bf and fixed != k1.plan.fixed_bytes:
        raise RuntimeError(f"K1's bf16 body keeps {fixed} bytes before its "
                           f"resident rows, its plan {k1.plan.fixed_bytes}")
    bounds = _bounds_tensor(
        k1_plan(B, M, H, D, n_layers, n_dense, n_blocks), dev)
    mel = torch.empty(N, B, M, device=dev)
    attn = torch.empty(N, B, Tk, device=dev)
    gates = torch.empty(N, B, device=dev)
    work = torch.empty(lib.decoder_workspace_floats(
        B, H, D, Tk, n_layers, parts, int(bf), n_blocks), device=dev)
    iwork = torch.empty(lib.decoder_workspace_ints(B), dtype=torch.int32,
                        device=dev)

    def ptr(t):     # the bf16 body reads its matrices from the K1 pack
        return None if t is None else t.data_ptr()

    def ptrs(ts):
        return (ctypes.c_void_p * max(1, len(ts)))(*map(ptr, ts))

    _check(lib, lib.fused_flow_infer_launch(
        int(bf), residual.data_ptr(), k_proj.data_ptr(), vals.data_ptr(),
        key_mask.data_ptr(), nvin.data_ptr(),
        ptr(weights["att_wi"]), ptr(weights["att_wh"]),
        weights["att_b"].data_ptr(),
        ptr(weights["q_w"]), weights["q_b"].data_ptr(),
        weights["v_w"].data_ptr(),
        ptrs([wi for wi, _, _ in weights["lstm"]]),
        ptrs([wh for _, wh, _ in weights["lstm"]]),
        ptrs([lb for _, _, lb in weights["lstm"]]), n_layers,
        ptrs([dw for dw, _ in weights["dense"]]),
        ptrs([db for _, db in weights["dense"]]), n_dense,
        ptr(weights["head_w"]), weights["head_b"].data_ptr(),
        ptr(weights.get("gate_w")), ptr(weights.get("gate_b")),
        mel.data_ptr(), attn.data_ptr(), gates.data_ptr(),
        work.data_ptr(), iwork.data_ptr(), bounds.data_ptr(), n_blocks,
        parts, k1_attn_slices(B, Tk, D, n_blocks),
        None if clock is None else clock.data_ptr(), N, B, M, H, D, Tk,
        float(temperature), float(gate_threshold), int(bool(early_exit)),
        ptr(k1 and k1.pack), ptr(k1 and k1.table),
        torch.cuda.current_stream(dev).cuda_stream),
        "fused_flow_infer_launch")
    return mel, attn, gates


# launches of either body, and of the bf16 body alone
fused_flow_infer.launches = 0
fused_flow_infer.launches_bf16 = 0
