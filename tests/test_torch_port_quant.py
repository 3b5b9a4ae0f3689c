"""Quantized inference in the port against the JAX package: kernel K4's
plain version (ops/qmm.py) against the Pallas kernel in interpret mode,
the quantizers and ``resolve_weight`` bit for bit, the carrier of JAX's
quantized pytrees, ``qdot``'s routing, and whole quantized models
(``flowtron_infer`` in w8, w8a8 and w4) with the quality bars of
tests/test_quantize.py. Toy widths where every quantized output dim is a
multiple of 128, because the Pallas kernel raises otherwise.

The JAX side runs compiled (``jax.jit``), as its serving engine runs it:
compiled, the int8 dequantization keeps its product in fp32 where the JAX
code writes a bf16 one (XLA's excess precision), and the port follows the
compiled numbers (utils/weights.py:resolve_weight)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import flowtron_tpu.ops.qmm_pallas as jax_qmm  # noqa: E402
import flowtron_tpu.utils.weights as jax_weights  # noqa: E402
from flowtron_tpu.infer.quantize import (  # noqa: E402
    _quantize_matrix as jax_quantize_matrix,
    _quantize_matrix_int4 as jax_quantize_matrix_int4,
    quantize_flows_for_inference as jax_quantize_flows,
    weight_shape as jax_weight_shape,
)
from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402

from flowtron_tpu_torch.infer.quantize import (  # noqa: E402
    _quantize_matrix, _quantize_matrix_int4, quantize_flows_for_inference,
    weight_shape,
)
from flowtron_tpu_torch.models import ar_step as port_ar_step  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_init, flowtron_infer,
)
from flowtron_tpu_torch.ops.qmm import (  # noqa: E402
    INV_127, MAX_WARPS, SMEM_LIMIT, STRETCH, TILE_M, TILE_N, qmm_padded_k,
    qmm_plan, quantized_matmul, quantized_matmul_reference,
)
from flowtron_tpu_torch.utils import weights as port_weights  # noqa: E402
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax, quantized_model_from_jax,
)
from flowtron_tpu_torch.utils.weights import (  # noqa: E402
    QuantizedWeight, qdot, resolve_weight,
)

# the flagship decoder's (K, N) list and one unaligned shape
PATH_KN = [(80, 4096), (1024, 4096), (1664, 4096), (1024, 640), (640, 640),
           (1024, 1024)]
DIMS = dict(n_speakers=2, n_speaker_dim=8, n_text=185, n_text_dim=32,
            n_mel_channels=12, n_hidden=128, n_attn_channels=128,
            n_lstm_layers=2, mel_encoder_n_hidden=16)
MIN_ELEMS = 1024
# K4's plan and card cases: the frame's (K, N), the key/value precompute,
# one unaligned shape; rows from a single stream to the precompute's B * Tk
PLAN_KN = sorted(set(PATH_KN)) + [(100, 200)]
PLAN_M = [1, 3, 8, 9, 64, 512]


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    return x, jax_quantize_matrix(w)


@pytest.mark.parametrize("a8", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("M,K,N", [(8, k, n) for k, n in PATH_KN]
                         + [(3, 100, 256)])
def test_k4_plain_matches_pallas_interpret(M, K, N, a8):
    """Weight-only within 1e-5 of the output scale; W8A8 within 1e-6 (its
    int32 sums are exact, so the two agree to the bit here)."""
    x, qd = _case(M, K, N)
    ref = np.asarray(jax_qmm.quantized_matmul(
        jnp.asarray(x), qd["q"], qd["s"], interpret=True, a8=a8))
    ours = quantized_matmul(_t(x), _t(np.asarray(qd["q"]).T.copy()),
                            _t(qd["s"]), a8=a8).numpy()
    scale = float(np.abs(ref).max())
    err = float(np.abs(ours - ref).max())
    assert ours.shape == (M, N) and ours.dtype == np.float32
    assert err <= (1e-6 if a8 else 1e-5) * scale, (err, scale)
    if a8:
        np.testing.assert_array_equal(ours, ref)


def test_k4_w8a8_sum_past_2_pow_24_rounds_once():
    """|acc| above 2**24 (127 * 127 * 1664 ~ 2.7e7 at most): the plain
    version forms it exactly and rounds to fp32 once, like the int32 ->
    fp32 cast; a float32 matmul would round along the way."""
    K, N = 1664, 4
    x = torch.full((1, K), 3.0)
    q = torch.full((N, K), 127, dtype=torch.int8)
    q[1] = -127
    s = torch.ones(N)
    out = quantized_matmul_reference(x, q, s, a8=True)
    exact = 127 * 127 * K
    assert exact > 2 ** 24
    sx = torch.tensor(3.0) / 127.0
    want = torch.tensor(float(exact), dtype=torch.float32) * sx
    assert out[0, 0] == want and out[0, 1] == -want


def test_k4_zero_row_scale_is_one():
    x = torch.zeros(2, 16)
    x[1, 3] = 2.0
    q = torch.ones(4, 16, dtype=torch.int8)
    out = quantized_matmul_reference(x, q, torch.ones(4), a8=True)
    assert torch.equal(out[0], torch.zeros(4))
    torch.testing.assert_close(out[1], torch.full((4,), 2.0))


def _plan_warps(plan, K):
    """Each warp's (column tile, row block, first stretch, end stretch) as
    csrc/qmm.cu:qmm_kernel derives them from the plan."""
    S = qmm_padded_k(K) // STRETCH
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            for w in range(plan.ct * plan.ks):
                p = w // plan.ct
                yield (bx * plan.ct + w % plan.ct, by, p * S // plan.ks,
                       (p + 1) * S // plan.ks)


@pytest.mark.parametrize("a8", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("M", PLAN_M)
@pytest.mark.parametrize("K,N", PLAN_KN)
def test_k4_plan_covers_each_column_row_and_k_once(M, K, N, a8):
    plan = qmm_plan(M, K, N, 132, a8)
    assert plan.threads == 32 * plan.ct * plan.ks
    assert plan.ct * plan.ks <= (MAX_WARPS // 2 if plan.mt >= 4
                                 else MAX_WARPS)
    assert plan.mt in (1, 2, 4, 8) and plan.smem <= SMEM_LIMIT
    rows = plan.mt * TILE_M
    col_count, row_count = np.zeros(N, int), np.zeros(M, int)
    k_count = {}
    for tile, by, s0, s1 in _plan_warps(plan, K):
        assert s0 < s1                      # no warp without work
        cols = slice(tile * TILE_N, min((tile + 1) * TILE_N, N))
        kc = k_count.setdefault((tile, by), np.zeros(K, int))
        kc[s0 * STRETCH:min(s1 * STRETCH, K)] += 1
        if s0 == 0:                         # once per (tile, row block)
            if by == 0:
                col_count[cols] += 1
            if tile == 0:
                row_count[by * rows:min((by + 1) * rows, M)] += 1
    assert (col_count == 1).all() and (row_count == 1).all()
    assert all((kc == 1).all() for (tile, _), kc in k_count.items()
               if tile * TILE_N < N)


def test_k4_plan_fills_the_card_on_the_frame():
    """At M = 8 the 4096-wide dots give 128 blocks (one an SM of 132), the
    narrow ones split K down to two stretches a warp."""
    for K in (1024, 1664):
        plan = qmm_plan(8, K, 4096, 132)
        assert plan.grid == (128, 1) and plan.ct == 2
        assert -(-(qmm_padded_k(K) // STRETCH) // plan.ks) <= 4
    for N in (640, 1024):
        plan = qmm_plan(8, 1024, N, 132, True)
        assert plan.grid == (N // 16, 1) and plan.ks == 8
    with pytest.raises(ValueError, match="positive"):
        qmm_plan(0, 16, 16)


def _tf32_rna(a):
    """fp32 -> tf32 as cvt.rna.tf32.f32: 10 mantissa bits, to nearest,
    ties away from zero (sign-magnitude bits, so adding half an ulp to the
    magnitude rounds half away)."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulate_k4_w8(x, q, s, plan):
    """The weight-only kernel's arithmetic: q exact in tf32, x split into
    tf32 hi and lo, each k8 mma's 8 exact products added to an fp32
    accumulator with one rounding (hi first, then lo), in the kernel's k
    order (stretch, word j of a lane's 16 bytes, its bytes 0-1 then 2-3;
    the mma's k = lane % 4 at byte 16 t + 4 j of the stretch); word j
    into accumulator set j % sets (4 sets with one row tile a warp, 2
    with two), the sets added in order, then the K parts' sums in part
    order, then times s."""
    M, K = x.shape
    Kp = qmm_padded_k(K)
    S = Kp // STRETCH
    n_sets = {1: 4, 2: 2}.get(plan.mt, 1)
    xp = np.zeros((M, Kp), np.float32)
    xp[:, :K] = x
    qp = np.zeros((q.shape[0], Kp), np.float64)
    qp[:, :K] = q
    hi = _tf32_rna(xp)
    lo = _tf32_rna(xp - hi)
    total = None
    for p in range(plan.ks):
        sets = [np.zeros((M, q.shape[0]), np.float32) for _ in range(n_sets)]
        for st in range(p * S // plan.ks, (p + 1) * S // plan.ks):
            for j in range(4):
                for half in (0, 1):
                    idx = [st * STRETCH + 16 * t + 4 * j + 2 * half + e
                           for e in (0, 1) for t in range(4)]
                    for part in (hi, lo):
                        sets[j % n_sets] = (
                            sets[j % n_sets] + part[:, idx].astype(np.float64)
                            @ qp[:, idx].T).astype(np.float32)
        acc = sets[0]
        for other in sets[1:]:
            acc = acc + other
        total = acc if total is None else total + acc
    return total * s


@pytest.mark.parametrize("M,K,N", [(8, 1664, 4096), (512, 640, 640)])
def test_k4_w8_tensor_core_numerics_within_tolerance(M, K, N):
    """The two-pass tf32 design lands within K4's 1e-5 of the output scale
    of the plain fp32 version, before any card runs it."""
    x, qd = _case(M, K, N)
    q = np.asarray(qd["q"]).T.copy()
    s = np.asarray(qd["s"])
    ref = quantized_matmul_reference(_t(x), _t(q), _t(s)).numpy()
    ours = _emulate_k4_w8(x, q, s, qmm_plan(M, K, N, 132))
    scale = float(np.abs(ref).max())
    assert float(np.abs(ours - ref).max()) <= 1e-5 * scale
    # x alone splits into hi + lo with ~2^-22 relative error
    hi = _tf32_rna(x)
    assert np.all(np.abs(x - hi - _tf32_rna(x - hi))
                  <= 2.0 ** -21 * np.abs(x))


# the bf16 plan's cases: the frame's (K, N) at M = 1, 8 and 64, and one
# unaligned shape
BF16_PLAN_CASES = [(M, K, N) for K, N in sorted(set(PATH_KN) - {(640, 640)})
                   for M in (1, 8, 64)] + [(3, 100, 200)]


def _part_stretches(plan, K):
    """The stretches of K part p of a column tile multiplies, in order
    (csrc/qmm.cu:qmm_kernel: p S // ks up to (p + 1) S // ks)."""
    S = qmm_padded_k(K) // STRETCH
    return [range(p * S // plan.ks, (p + 1) * S // plan.ks)
            for p in range(plan.ks)]


@pytest.mark.parametrize("a8", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("M,K,N", BF16_PLAN_CASES)
def test_k4_bf16_plan_covers_each_column_row_and_k_once(M, K, N, a8):
    """The bf16 bodies' launch: every column tile and row block once, every
    stretch of K once a column tile across the block's K parts, and the
    block's staged rows (bf16, or W8A8's int8) and partial sums within
    shared memory."""
    plan = qmm_plan(M, K, N, 132, a8, True)
    assert plan.threads == 32 * plan.ct * plan.ks
    assert plan.ct * plan.ks <= (MAX_WARPS // 2 if plan.mt >= 4
                                 else MAX_WARPS)
    assert plan.mt in (1, 2, 4, 8) and plan.smem <= SMEM_LIMIT
    Kp, rows = qmm_padded_k(K), plan.mt * TILE_M
    staged = rows * ((Kp if Kp % 128 == 64 else Kp + 64) if a8
                     else 2 * Kp + 16)
    assert plan.smem >= staged
    col_count, row_count = np.zeros(N, int), np.zeros(M, int)
    k_count = {}
    for tile, by, s0, s1 in _plan_warps(plan, K):
        assert s0 < s1                      # no warp without work
        cols = slice(tile * TILE_N, min((tile + 1) * TILE_N, N))
        kc = k_count.setdefault((tile, by), np.zeros(K, int))
        kc[s0 * STRETCH:min(s1 * STRETCH, K)] += 1
        if s0 == 0:
            if by == 0:
                col_count[cols] += 1
            if tile == 0:
                row_count[by * rows:min((by + 1) * rows, M)] += 1
    assert (col_count == 1).all() and (row_count == 1).all()
    assert all((kc == 1).all() for (tile, _), kc in k_count.items()
               if tile * TILE_N < N)


def _bf16(a):
    """fp32 numbers rounded to bf16 (to nearest even), back as fp32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulate_k4_bf16_w8a8(x, q, s, plan):
    """The bf16 W8A8 body's arithmetic, step by step: the quantize launch
    reads each bf16 row as fp32, sx = max|x| * fp32(1/127) (1 where 0),
    clip(rint(x / sx)) with a true fp32 division; the product's K parts'
    int32 sums over their stretches, added in part order; out =
    (fp32(acc) * sx) * s, rounded to bf16 once."""
    M, K = x.shape
    S = qmm_padded_k(K) // STRETCH
    xp = np.zeros((M, S * STRETCH), np.float32)
    xp[:, :K] = x
    qp = np.zeros((q.shape[0], S * STRETCH), np.float64)
    qp[:, :K] = q
    sx = np.abs(xp).max(axis=1) * np.float32(INV_127)
    sx = np.where(sx == 0, np.float32(1), sx).astype(np.float32)
    xq = np.clip(np.rint(xp / sx[:, None]), -127, 127)
    acc = np.zeros((M, q.shape[0]), np.float64)
    for sts in _part_stretches(plan, K):
        for st in sts:
            k = slice(st * STRETCH, (st + 1) * STRETCH)
            acc += xq[:, k] @ qp[:, k].T        # exact: |acc| < 2**53
    y = (acc.astype(np.float32) * sx[:, None]) * s[None, :]
    return _bf16(y)


@pytest.mark.parametrize("M,K,N", [(8, 1664, 4096), (3, 100, 200),
                                   (64, 1024, 640)])
def test_k4_bf16_w8a8_quantize_and_product_are_bitwise(M, K, N):
    """The quantize launch and the K parts' int32 sums give
    quantized_matmul_reference's bits on bf16 x, with a zero row, rows of
    .5 ties (sx exactly 1 and 2) and a row whose int32 sum passes 2**24."""
    rng = np.random.default_rng(20)
    x = _bf16(rng.standard_normal((M, K)))
    q = rng.integers(-127, 128, (N, K)).astype(np.int8)
    s = (rng.random(N) * 0.01 + 1e-3).astype(np.float32)
    x[0] = 0.0                                    # sx = 1
    x[1] = 0.0
    x[1, ::7] = 2.5                               # x / sx: halves
    x[1, 3::7] = -3.5
    x[1, 5::11] = 0.5
    x[1, K // 2] = 127.0                          # sx = 127 fp32(1/127) = 1
    x[2] = 126.5
    x[2, 1] = 254.0                               # sx = 2: 126.5 / 2 a tie
    q[N - 1] = 127
    if M > 3:
        x[3] = 3.0                                # xq = 127 everywhere
    plan = qmm_plan(M, K, N, 132, True, True)
    assert np.float32(127.0) * np.float32(INV_127) == 1.0
    xt = torch.from_numpy(x).to(torch.bfloat16)
    ref = quantized_matmul_reference(xt, torch.from_numpy(q),
                                     torch.from_numpy(s), a8=True)
    ours = _emulate_k4_bf16_w8a8(x, q, s, plan)
    np.testing.assert_array_equal(ours, ref.float().numpy())
    if K == 1664:                                # row 3 against q[N - 1]
        assert 127 * 127 * K > 2 ** 24 and ref[3, N - 1] > 0


def _bf16_bits(v):
    """bf16 bit patterns (uint16) of the values v, each exact in bf16."""
    b = np.ascontiguousarray(v, np.float32).view(np.uint32)
    assert not (b & 0xFFFF).any()
    return (b >> 16).astype(np.uint32)


def _bits_bf16(b):
    return (np.asarray(b, np.uint32) << 16).view(np.float32)


def _int8_as_bf16_pairs(u):
    """csrc/qmm.cu:even_bytes_bf16x2 and odd_bytes_bf16x2 on the words u:
    the bf16 pairs (bytes 0, 2) and (bytes 1, 3) as fp32, from 0x4300 | L
    minus 0x4300 | (b & 0x80), the subtraction exact in bf16."""
    def sub(a, b):
        d = np.stack([_bits_bf16(a & 0xFFFF) - _bits_bf16(b & 0xFFFF),
                      _bits_bf16(a >> 16) - _bits_bf16(b >> 16)], -1)
        _bf16_bits(d)                              # exact in bf16
        return d
    u = np.asarray(u, np.uint32)
    even = sub((u & 0x007F007F) | 0x43004300, (u & 0x00800080) | 0x43004300)
    r = ((u >> 8) & 0xFF) | 0x4300 | (((u >> 24) & 0xFF) << 16) | 0x43000000
    odd = sub(r & 0xFF7FFF7F, r & 0xFF80FF80)
    return even, odd


def _emulate_k4_bf16_w8(x, q, s, plan):
    """The bf16 weight-only kernel's arithmetic: q's bytes through the
    kernel's bf16 conversion, each k16 mma's 16 exact products added to an
    fp32 accumulator with one rounding, in the kernel's k order (a warp's
    stretches; word j of a lane's 16 bytes: bytes 0, 2 then 1, 3 of each
    of the 4 lanes t at byte 16 t + 4 j), word j into accumulator set
    j % sets, the sets added in order, then the K parts' sums in part
    order, then times s, rounded to bf16 once."""
    M, K = x.shape
    N = q.shape[0]
    S = qmm_padded_k(K) // STRETCH
    xp = np.zeros((M, S * STRETCH), np.float64)
    xp[:, :K] = x
    qb = np.zeros((N, S * STRETCH), np.int8)
    qb[:, :K] = q
    words = qb.view(np.uint32)                    # (N, S * 16)
    even, odd = _int8_as_bf16_pairs(words)        # (N, S * 16, 2) each
    qf = np.zeros((N, S * STRETCH), np.float64)
    qf[:, 0::4], qf[:, 2::4] = even[..., 0], even[..., 1]
    qf[:, 1::4], qf[:, 3::4] = odd[..., 0], odd[..., 1]
    assert np.array_equal(qf[:, :K], q.astype(np.float64))
    n_sets = {1: 4, 2: 2}.get(plan.mt, 1)
    total = None
    for sts in _part_stretches(plan, K):
        sets = [np.zeros((M, N), np.float32) for _ in range(n_sets)]
        for st in sts:
            for j in range(4):
                idx = [st * STRETCH + 16 * t + 4 * j + e
                       for t in range(4) for e in (0, 2, 1, 3)]
                h = j % n_sets
                sets[h] = (sets[h] + xp[:, idx] @ qf[:, idx].T).astype(
                    np.float32)
        acc = sets[0]
        for other in sets[1:]:
            acc = acc + other
        total = acc if total is None else total + acc
    return _bf16(total * s)


@pytest.mark.parametrize("M,K,N", [(8, 1664, 4096), (64, 1024, 640)])
def test_k4_bf16_w8_sum_order_within_one_ulp(M, K, N):
    """The bf16 weight-only design's int8 -> bf16 conversion is exact for
    every byte, and its sum order lands within the card's bar of the plain
    version: one bf16 ulp of each output, plus 2^-16 of the scale where a
    sum cancels."""
    every = np.arange(256, dtype=np.uint32)
    even, odd = _int8_as_bf16_pairs(every | (every << 8) | (every << 16)
                                    | (every << 24))
    signed = every.astype(np.uint8).view(np.int8).astype(np.float32)
    for pair in (even, odd):
        assert np.array_equal(pair[:, 0], signed)
        assert np.array_equal(pair[:, 1], signed)
    x, qd = _case(M, K, N)
    x = _bf16(x)
    q = np.asarray(qd["q"]).T.copy()
    s = np.asarray(qd["s"]).copy()
    plan = qmm_plan(M, K, N, 132, False, True)
    ref = quantized_matmul_reference(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q),
        torch.from_numpy(s)).float().numpy()
    ours = _emulate_k4_bf16_w8(x, q, s, plan)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                  - 7)
    assert (np.abs(ours - ref) <= ulp + 2.0 ** -16 * np.abs(ref).max()).all()


_jax_resolve = jax.jit(lambda w: jax_weights.resolve_weight(w, jnp.float32))


class TestQuantizers:
    @pytest.fixture(params=[(256, 512), (80, 512), (1664, 256)],
                    ids=lambda s: f"in{s[0]}_out{s[1]}")
    def weight(self, request):
        n_in, n_out = request.param
        rng = np.random.default_rng(n_in)
        w = rng.standard_normal((n_out, n_in)).astype(np.float32) * 0.05
        w[3] = 0.0                       # a zero output channel: scale 1
        return w

    @pytest.mark.parametrize("a8", [False, True])
    def test_int8_bitwise(self, weight, a8):
        ref = jax_quantize_matrix(weight.T, a8=a8)
        ours = _quantize_matrix(torch.from_numpy(weight), a8=a8)
        np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref["q"]).T)
        np.testing.assert_array_equal(ours.s.numpy(), np.asarray(ref["s"]))
        assert ours.a8 == ("a8" in ref)
        assert weight_shape(ours) == tuple(jax_weight_shape(ref))[::-1]
        np.testing.assert_array_equal(
            resolve_weight(ours, torch.float32).numpy(),
            np.asarray(_jax_resolve(ref)).T)

    def test_int4_bitwise(self, weight):
        ref = jax_quantize_matrix_int4(weight.T)
        ours = _quantize_matrix_int4(torch.from_numpy(weight))
        np.testing.assert_array_equal(ours.q4.numpy(),
                                      np.asarray(ref["q4"]).T)
        np.testing.assert_array_equal(ours.s.numpy(), np.asarray(ref["s"]).T)
        assert weight_shape(ours) == tuple(jax_weight_shape(ref))[::-1]
        np.testing.assert_array_equal(
            resolve_weight(ours, torch.float32).numpy(),
            np.asarray(_jax_resolve(ref)).T)
        # the default dtype is bf16, as in the JAX package
        np.testing.assert_array_equal(
            resolve_weight(ours).float().numpy(),
            np.asarray(jax_weights.resolve_weight(ref)).astype(np.float32).T)


def _models():
    params, cfg = jax_flowtron_init(jax.random.PRNGKey(0), n_flows=2,
                                    use_gate_layer=True, **DIMS)
    rng = np.random.default_rng(1)
    for f in params["flows"]:
        f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            f["conv"]["w"].shape).astype(np.float32))
    model, tcfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS)
    model.load_state_dict(flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return params, cfg, model, tcfg


@pytest.fixture(scope="module")
def models():
    return _models()


def _leaves(model):
    return {n: m for n, m in model.named_modules()
            if isinstance(m, QuantizedWeight)}


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_carried_jax_pytree_equals_port_quantization(models, mode):
    params, _, model, _ = models
    jq = jax.tree.map(np.asarray, jax_quantize_flows(
        params, min_elems=MIN_ELEMS, mode=mode))
    carried = quantized_model_from_jax(model, jq)
    ours = quantize_flows_for_inference(model, min_elems=MIN_ELEMS,
                                        mode=mode)
    a, b = _leaves(carried), _leaves(ours)
    # each flow: 2 + 4 LSTM matrices, query, key, value, 2 dense layers
    assert sorted(a) == sorted(b) and len(a) == 2 * 11
    for name in a:
        assert a[name].a8 == b[name].a8 == (mode == "w8a8"), name
        for buf in ("q4", "s") if mode == "w4" else ("q", "s"):
            assert torch.equal(getattr(a[name], buf), getattr(b[name], buf))
    # every float parameter of the carried copy is the model's
    floats = dict(model.named_parameters())
    for name, p in carried.named_parameters():
        assert torch.equal(p, floats[name]), name


def test_quantize_returns_a_copy(models):
    _, _, model, _ = models
    before = {k: v.clone() for k, v in model.state_dict().items()}
    q = quantize_flows_for_inference(model, min_elems=MIN_ELEMS, mode="w4")
    assert not _leaves(model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    # the encoder, the gate and the coupling head stay float
    assert not any(n.startswith(("encoder", "embedding")) for n in _leaves(q))
    assert isinstance(q.flows[1].ar_step.gate_layer.linear_layer.weight,
                      torch.nn.Parameter)
    with pytest.raises(ValueError, match="mode"):
        quantize_flows_for_inference(model, mode="w2")


def _forced_jax_k4(monkeypatch):
    """Send the JAX package's a8 dots to its K4 in interpret mode on the
    CPU: _qmm_eligible asks for a TPU, so the test drops that condition."""
    def eligible(x, w, max_rows=512):
        return isinstance(w, dict) and "q" in w and "a8" in w and \
            int(np.prod(x.shape[:-1])) <= max_rows
    monkeypatch.setattr(jax_weights, "_qmm_eligible", eligible)
    monkeypatch.setattr(jax_qmm, "quantized_matmul", functools.partial(
        jax_qmm.quantized_matmul, interpret=True))


def _inputs():
    rng = np.random.default_rng(3)
    B, N = 2, 16
    residual = (rng.standard_normal((B, 12, N)) * 0.5).astype(np.float32)
    return (residual, np.asarray([0, 1]), rng.integers(1, 185, (B, 9)),
            np.asarray([9, 6]))


def _infer_both(models, mode, thresh, monkeypatch):
    params, cfg, model, tcfg = models
    residual, sids, text, in_lens = _inputs()
    if mode == "w8a8":
        _forced_jax_k4(monkeypatch)
    jparams = params if mode == "fp32" else jax_quantize_flows(
        params, min_elems=MIN_ELEMS, mode=mode)
    tmodel = model if mode == "fp32" else quantize_flows_for_inference(
        model, min_elems=MIN_ELEMS, mode=mode)
    mel_j, _, nv_j = jax.jit(lambda p, r, s, t, n: jax_flowtron_infer(
        p, cfg, r, s, t, gate_threshold=thresh, in_lens=n))(
        jparams, jnp.asarray(residual), jnp.asarray(sids),
        jnp.asarray(text), jnp.asarray(in_lens))
    mel, _, nv = flowtron_infer(
        tmodel, tcfg, _t(residual), _t(sids), _t(text),
        gate_threshold=thresh, in_lens=_t(in_lens))
    return mel.numpy(), nv.numpy(), np.asarray(mel_j), np.asarray(nv_j)


@pytest.mark.parametrize("thresh", [1e6, 0.5])
@pytest.mark.parametrize("mode,tol", [("w8", 1e-4), ("w4", 1e-4),
                                      ("w8a8", 1e-3)])
def test_quantized_model_matches_jax(models, mode, tol, thresh,
                                     monkeypatch):
    """w8 and w4 within 1e-4; w8a8, JAX's K4 forced, within 1e-3 (a
    per-row activation rounding can flip one int8 step); n_valid equal."""
    mel, nv, mel_j, nv_j = _infer_both(models, mode, thresh, monkeypatch)
    np.testing.assert_array_equal(nv, nv_j)
    for b in range(len(nv_j)):
        n = int(nv_j[b])
        np.testing.assert_allclose(mel[b, :, :n], mel_j[b, :, :n], atol=tol)


@pytest.mark.parametrize("mode,bar", [("w8", 0.005), ("w4", 0.03),
                                      ("w8a8", 0.03)])
def test_quantized_quality_against_fp32(models, mode, bar):
    """JAX's own bars (tests/test_quantize.py:56,102): mel MAE over the
    fp32 mel's mean magnitude, on the same latents."""
    _, _, model, tcfg = models
    residual, sids, text, in_lens = _inputs()
    q = quantize_flows_for_inference(model, min_elems=MIN_ELEMS, mode=mode)
    args = (_t(residual), _t(sids), _t(text))
    mel_fp = flowtron_infer(model, tcfg, *args, gate_threshold=1e6,
                            in_lens=_t(in_lens))[0]
    mel_q = flowtron_infer(q, tcfg, *args, gate_threshold=1e6,
                           in_lens=_t(in_lens))[0]
    mae = float((mel_q - mel_fp).abs().mean())
    scale = float(mel_fp.abs().mean())
    assert mae / scale < bar, (mae, scale)


class TestRouting:
    @pytest.fixture
    def spy(self, monkeypatch):
        """Count K1 calls in ar_step_infer and K4 calls in qdot."""
        calls = {"k1": 0, "k4": 0}
        k1, k4 = port_ar_step.fused_flow_infer, port_weights.quantized_matmul

        def k1_spy(*a, **k):
            calls["k1"] += 1
            return k1(*a, **k)

        def k4_spy(*a, **k):
            calls["k4"] += 1
            return k4(*a, **k)
        monkeypatch.setattr(port_ar_step, "fused_flow_infer", k1_spy)
        monkeypatch.setattr(port_weights, "quantized_matmul", k4_spy)
        return calls

    @pytest.mark.parametrize("case", ["plain", "prior", "temperature",
                                      "w8", "w8a8", "w4"])
    def test_flow_routing_on_cpu(self, models, spy, case):
        """fused="early" asks for K1; only a flow in its subset gets it,
        any other runs the per-frame loop (with K4 for w8a8 leaves)."""
        _, _, model, _ = models
        flow = model.flows[0]
        if case in ("w8", "w8a8", "w4"):
            flow = quantize_flows_for_inference(
                model, min_elems=MIN_ELEMS, mode=case).flows[0]
        rng = np.random.default_rng(5)
        N, B, Tk = 4, 2, 5
        residual = _t(rng.standard_normal((N, B, 12)).astype(np.float32))
        text = _t(rng.standard_normal((Tk, B, 40)).astype(np.float32))
        prior = _t(np.full((B, N, Tk), 0.2, np.float32)) \
            if case == "prior" else None
        temp = _t(np.asarray([[0.8], [1.2]], np.float32)) \
            if case == "temperature" else 1.0
        assert port_ar_step.in_k1_subset(flow, prior, temp) == \
            (case == "plain")
        with torch.no_grad():
            mel, _, _ = port_ar_step.ar_step_infer(
                flow, residual, text, attn_prior=prior, temperature=temp,
                gate_threshold=1e6, fused="early")
        assert mel.shape == (N, B, 12) and bool(torch.isfinite(mel).all())
        assert spy["k1"] == (1 if case == "plain" else 0)
        # w8a8: per frame the 9 decoder dots, plus key and value once
        assert spy["k4"] == (9 * N + 2 if case == "w8a8" else 0)

    @pytest.mark.parametrize("rows,to_k4", [(512, True), (513, False),
                                            (2 * 300, False)])
    def test_a8_leaf_over_512_rows_resolves(self, spy, rows, to_k4):
        rng = np.random.default_rng(6)
        w = torch.from_numpy(rng.standard_normal((128, 64))
                             .astype(np.float32))
        leaf = _quantize_matrix(w, a8=True)
        x = torch.from_numpy(rng.standard_normal((rows, 64))
                             .astype(np.float32))
        if rows == 600:
            x = x.reshape(2, 300, 64)   # all leading dims count
        out = qdot(x, leaf)
        assert spy["k4"] == int(to_k4)
        assert out.shape == x.shape[:-1] + (128,)
        if not to_k4:
            want = x @ resolve_weight(leaf, torch.float32).t()
            torch.testing.assert_close(out, want, atol=1e-5, rtol=0)

    def test_w8_leaf_never_goes_to_k4(self, spy):
        leaf = _quantize_matrix(torch.ones(128, 64))
        qdot(torch.ones(3, 64), leaf)
        assert spy["k4"] == 0

    def test_float_weight_dot_unchanged(self):
        """A float weight keeps the plain matmul's numbers bit for bit."""
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((32, 64))
                             .astype(np.float32))
        assert torch.equal(qdot(x, w), x @ w.t())


def test_wrapper_has_no_silent_fallback():
    """Only CPU tensors take the plain version; another device raises."""
    x = torch.ones(2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        quantized_matmul(x, torch.ones(4, 16, dtype=torch.int8,
                                       device="meta"),
                         torch.ones(4, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("a8", [False, True], ids=["w8", "w8a8"])
def test_k4_kernel_matches_plain_on_card(cuda_device, a8, dtype):
    """Every plan shape: W8A8 bitwise, weight-only within 1e-5 of the
    output scale (bf16 x and out: within one bf16 ulp of each output, plus
    2^-16 of the scale for near-zero sums), two calls bitwise equal, one
    launch counted a call."""
    bf16 = dtype == torch.bfloat16
    for K, N in PLAN_KN:
        x, qd = _case(max(PLAN_M), K, N)
        q = _t(np.asarray(qd["q"]).T.copy()).to(cuda_device)
        s = _t(qd["s"]).to(cuda_device)
        for M in PLAN_M:
            xm = _t(x[:M]).to(cuda_device, dtype)
            ref = quantized_matmul_reference(xm, q, s, a8=a8)
            outs = []
            for _ in range(2):
                counts = quantized_matmul.launches
                outs.append(quantized_matmul(xm, q, s, a8=a8))
                assert quantized_matmul.launches == counts + 1
            torch.cuda.synchronize()
            assert outs[0].dtype == dtype
            assert torch.equal(outs[0], outs[1]), (M, K, N)
            if a8:
                assert torch.equal(outs[0], ref), (M, K, N)
            elif bf16:
                o, r = outs[0].float(), ref.float()
                ulp = torch.exp2(torch.floor(torch.log2(
                    r.abs().clamp(min=2.0 ** -126))) - 7)
                assert bool(((o - r).abs() <= ulp + 2.0 ** -16 * float(
                    r.abs().max())).all()), (M, K, N)
            else:
                err = float((outs[0] - ref).abs().max())
                scale = float(ref.abs().max())
                assert err <= 1e-5 * scale, (M, K, N, err, scale)
