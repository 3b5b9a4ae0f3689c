"""P3, P4 and P5, the scan probes, in the port against the unchanged JAX
scripts at toy size: P3 (scripts/exp_resident_weight.py) IN=128, OUT=256,
B=8, 4 steps; P4 (scripts/exp_fused_int8.py) SHAPES (256,512) +
3 x (128,512), B=2, 3 steps; P5 (scripts/exp_fused_cost.py) N=8, B=2,
M=16, H=32, D=24, Tk=8, CHUNK=4. The scripts' Pallas kernels run in TPU
interpret mode on the CPU; the port runs its plain versions
(ops/resident.py, ops/fused_cost.py) on the same numpy arrays.

Bars: bf16 states within one bf16 step of JAX's; fp32 states and mels
within 1e-4 of their largest magnitude (sigmoid, tanh and exp differ in
the last bits between the two libraries); W8A8's int8 activations, and
the quotient h / sx they are rounded from, bit for bit.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from flowtron_tpu_torch.ops._layout import interleave_gates  # noqa: E402
from flowtron_tpu_torch.ops.fused_cost import (  # noqa: E402
    VARIANTS, fused_cost, fused_cost_reference, pack_weights, weight_shapes)
from flowtron_tpu_torch.ops.resident import (  # noqa: E402
    p3_check, pack_resident_weights, quantize_rows, resident_scan,
    resident_scan_reference)
from flowtron_tpu_torch.scripts import (  # noqa: E402
    _probe, exp_fused_cost as port_p5, exp_fused_int8 as port_p4,
    exp_resident_weight as port_p3)
from tests.probe_scripts import (  # noqa: E402
    JitRecorder, assert_within_bf16_ulp, f32, load_script)

P3 = dict(IN=128, OUT=256, B=8, STEPS=4)
P4_SHAPES = [(256, 512), (128, 512), (128, 512), (128, 512)]
P4_B, P4_STEPS = 2, 3
P5 = dict(N=8, B=2, M=16, H=32, D=24, Tk=8)
FP32_TOL = 1e-4


def _close(out, ref, tol=FP32_TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    err = float(np.abs(out - ref).max())
    assert err <= tol * float(np.abs(ref).max()), err


@pytest.fixture(scope="module")
def p3():
    """The script's ``main``: the XLA scan's and the Pallas scan's final
    states, in that order."""
    mod = load_script("exp_resident_weight")
    for k, v in P3.items():
        setattr(mod, k, v)
    rec = JitRecorder()
    mod.jax = rec
    with pltpu.force_tpu_interpret_mode():
        mod.main()
    return [f32(o) for o in rec.outputs]


def _p3_inputs():
    w, x = port_p3.make_inputs(P3["B"], P3["IN"], P3["OUT"])
    return (_probe.tensor(w, "cpu", torch.bfloat16),
            _probe.tensor(x, "cpu", torch.bfloat16))


def test_p3_xla_scan_matches_jax(p3):
    w, x = _p3_inputs()
    carry = _probe.scan(port_p3.xla_step(w), x, P3["STEPS"])()
    assert carry.dtype == torch.bfloat16
    assert_within_bf16_ulp(carry.float().numpy(), p3[0])


def test_p3_resident_scan_matches_jax(p3):
    w, x = _p3_inputs()
    state, y = resident_scan("p3", x, [w], steps=P3["STEPS"])
    assert state.dtype == torch.bfloat16 and y.shape == (P3["B"], P3["OUT"])
    assert_within_bf16_ulp(state.float().numpy(), p3[1])


def test_p3_main_prints_the_scripts_lines(p3, monkeypatch, capsys):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    res = port_p3.main([str(P3["B"]), str(P3["STEPS"])], IN=P3["IN"],
                       OUT=P3["OUT"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "XLA scan (streamed)      ", "Pallas scan (resident W) "]
    assert_within_bf16_ulp(res["xla"][1].float().numpy(), p3[0])
    assert_within_bf16_ulp(res["pallas"][1][0].float().numpy(), p3[1])


class _Jnp:
    """``jnp`` for exp_fused_int8.py's globals that records, at run time,
    the rows W8A8 quantizes (the argument of ``jnp.abs``), the quotient
    it rounds (``jnp.round``) and the int8 operand of the integer dot."""

    def __init__(self):
        self.h, self.quotient, self.q = [], [], []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def _keep(self, store, v):
        jax.debug.callback(lambda a: store.append(np.array(a)), v)

    def abs(self, x):
        self._keep(self.h, x)
        return jnp.abs(x)

    def round(self, x):
        self._keep(self.quotient, x)
        return jnp.round(x)

    def dot(self, a, b, preferred_element_type=None):
        if a.dtype == jnp.int8:
            self._keep(self.q, a)
        return jnp.dot(a, b, preferred_element_type=preferred_element_type)


@pytest.fixture(scope="module")
def p4():
    """The script's two kernels: {body: (final state, inputs)}, and the
    W8A8 quantizer's values recorded in a second W8A8 run at B=32, 2 steps
    (256 rows, so that rows where the readings of sx differ occur)."""
    mod = load_script("exp_fused_int8")
    mod.SHAPES, mod.B, mod.STEPS = P4_SHAPES, P4_B, P4_STEPS
    out = {}
    rec = _Jnp()
    with pltpu.force_tpu_interpret_mode():
        for body, make in (("bf16", mod.make_bf16), ("w8a8", mod.make_w8a8)):
            f, args = make()
            out[body] = (f32(f(*args)), [np.asarray(a) for a in args])
        mod.B, mod.STEPS, mod.jnp = 32, 2, rec
        f, args = mod.make_w8a8()
        f(*args).block_until_ready()
    return out, rec


@pytest.mark.parametrize("body", ["bf16", "w8a8"])
def test_p4_inputs_are_the_scripts(p4, body):
    x0, ws, scales = port_p4.make_inputs(body, P4_B, P4_SHAPES)
    ref = p4[0][body][1]
    ours = [x0] + ws + (scales or [])
    assert len(ours) == len(ref)
    for a, r in zip(ours, ref):
        a = a if body == "w8a8" else \
            _probe.tensor(a, "cpu", torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(a, f32(r) if r.dtype != np.int8 else r)


@pytest.mark.parametrize("body", ["bf16", "w8a8"])
def test_p4_chain_matches_jax(p4, body):
    x0, ws, scales = port_p4.to_device(
        body, port_p4.make_inputs(body, P4_B, P4_SHAPES), "cpu")
    state, g = resident_scan(body, x0, ws, scales, steps=P4_STEPS)
    assert state.dtype == torch.float32 and g.shape == (P4_B, 128)
    _close(state.numpy(), p4[0][body][0])


def test_p4_w8a8_activations_are_jaxs_bit_for_bit(p4):
    """Every row the JAX kernel quantized, through the port's quantizer:
    the quotient h / sx and the int8 values equal JAX's bit for bit. sx is
    fma(max|h|, fp32(1/127), 1e-12): neither max|h| / 127 nor max|h| *
    fp32(1/127) followed by the add gives these bits on every row."""
    rec = p4[1]
    assert len(rec.h) == len(rec.quotient) == len(rec.q) == 2 * len(P4_SHAPES)
    rows_where_division_differs = 0
    for h, quotient, q in zip(rec.h, rec.quotient, rec.q):
        h = torch.from_numpy(h)
        hq, sx = quantize_rows(h)
        np.testing.assert_array_equal((h / sx).numpy(), quotient)
        np.testing.assert_array_equal(hq.to(torch.int8).numpy(), q)
        divided = h.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
        rows_where_division_differs += int((divided != sx).sum())
    assert rows_where_division_differs > 0


def test_w8a8_scale_is_one_fused_multiply_add():
    """Row maxima where ``max|h| / 127 + 1e-12`` (the first two) or
    ``max|h| * fp32(1/127) + 1e-12`` (the last two), each rounded twice,
    miss the fused value by one fp32 step; the port gives the fused one
    (JAX's, as test_p4_w8a8_activations_are_jaxs_bit_for_bit shows)."""
    amax = torch.tensor([0.11996085941791534, 1.3256295919418335,
                         0.03324013575911522, 1.396195411682129])
    fused = np.array([0.00094457367, 0.010438028, 0.00026173337,
                      0.010993665], np.float32)
    _, sx = quantize_rows(torch.stack([amax, -0.5 * amax], 1))
    np.testing.assert_array_equal(sx.reshape(-1).numpy(), fused)
    inv = torch.tensor(1 / 127.0)
    assert not torch.equal((amax / 127.0 + 1e-12)[:2],
                           torch.from_numpy(fused[:2]))
    assert not torch.equal((amax * inv + 1e-12)[2:],
                           torch.from_numpy(fused[2:]))


@pytest.mark.parametrize("body", ["bf16", "w8a8"])
def test_p4_main_prints_the_scripts_lines(p4, body, monkeypatch, capsys):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    res = port_p4.main([str(P4_B), str(P4_STEPS)], shapes=P4_SHAPES)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"B={P4_B} STEPS={P4_STEPS} backend=cpu"
    assert [ln.split(":")[0] for ln in lines[1:]] == [
        "bf16 resident dots ", "w8a8 resident dots "]
    _close(res[body][1][0].numpy(), p4[0][body][0])


def test_p4_library_step_is_the_chain():
    """The streamed yardstick computes the bf16 chain's step."""
    x0, ws, _ = port_p4.to_device(
        "bf16", port_p4.make_inputs("bf16", P4_B, P4_SHAPES), "cpu")
    lib = port_p4.library_step(ws)(x0.float())
    ref, _ = resident_scan_reference("bf16", x0, ws, steps=1)
    _close(lib.numpy(), ref.numpy())


@pytest.fixture(scope="module")
def p5():
    """The script's ``run`` for each variant at toy size (imported once,
    which runs its three full-size variants into their CPU FAIL line):
    {variant: mel}."""
    mod = load_script("exp_fused_cost")
    for k, v in P5.items():
        setattr(mod, k, v)
    mod.CHUNK = 4
    rec = JitRecorder()
    mod.jax = rec
    bodies = {"dots": mod.v_dots, "lstm": mod.v_lstm, "attn": mod.v_attn}
    with pltpu.force_tpu_interpret_mode():
        for variant in VARIANTS:
            mod.run(variant, bodies[variant],
                    weight_shapes(variant, P5["M"], P5["H"], P5["D"]))
    return dict(zip(VARIANTS, (f32(o) for o in rec.outputs)))


def _p5_inputs(variant, device="cpu"):
    dims = {k: P5[k] for k in ("B", "N", "M", "H", "D", "Tk")}
    return port_p5.to_device(port_p5.make_inputs(variant, **dims), device)


@pytest.mark.parametrize("variant", VARIANTS)
def test_p5_variant_matches_jax(p5, variant):
    ws, z, kv = _p5_inputs(variant)
    mel = fused_cost(variant, z, kv, ws)
    assert mel.dtype == torch.float32
    _close(mel.numpy(), p5[variant])


def test_p5_main_prints_the_scripts_lines(p5, monkeypatch, capsys):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    dims = {k: P5[k] for k in ("M", "H", "D", "Tk")}
    res = port_p5.main([str(P5["B"]), str(P5["N"])], **dims)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].rstrip() for ln in lines] == \
        [name for name, _ in port_p5.RUNS]
    for variant in VARIANTS:
        _close(res[variant][1].numpy(), p5[variant])


def test_resident_packing_puts_a_units_gates_in_one_quad():
    """Packed row 4u + c of a chain weight is column c * N/4 + u; a P3
    weight is only transposed; scales follow their columns; each of a
    chain's dots is its own contiguous (N, K_i) rows."""
    w = torch.arange(3 * 8, dtype=torch.float32).reshape(3, 8)
    s = torch.arange(8, dtype=torch.float32)
    (pw,), (ps,) = pack_resident_weights("w8a8", [w], [s])
    for u in range(2):
        for c in range(4):
            assert torch.equal(pw[4 * u + c], w[:, 2 * c + u])
            assert ps[4 * u + c] == s[2 * c + u]
    (p3w,), _ = pack_resident_weights("p3", [w])
    assert torch.equal(p3w, w.t())
    pws, _ = pack_resident_weights("bf16", [w, 2 * w[:2], 3 * w])
    assert [tuple(t.shape) for t in pws] == [(8, 3), (8, 2), (8, 3)]
    for t, ref in zip(pws, [w, 2 * w[:2], 3 * w]):
        assert t.is_contiguous()
        assert torch.equal(t, interleave_gates(ref.t()))


def _mma_fragments(W, X, s, i8):
    """What csrc/resident.cu:chain_products hands one mma pair for stretch
    s (64 bytes of k): lane (g, t) loads 16 bytes at 16 t of weight rows g
    and g + 8 and of staged row g; returns, per mma, the logical A (16 x
    kk) and B (kk x 8) tiles the PTX fragment layout gives those
    registers (m16n8k16 bf16: kk = 16, two values a word; m16n8k32 s8:
    kk = 32, four a word)."""
    per = 4 if i8 else 2                        # values a 32-bit word
    kk = 8 * per
    tiles = []
    for m in range(2):                          # words 2m, 2m + 1 of a load
        A = np.zeros((16, kk), W.dtype)
        Bt = np.zeros((kk, 8), X.dtype)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            k0 = s * 64 // (1 if i8 else 2) + t * 4 * per
            word = lambda row, w: row[k0 + w * per:k0 + (w + 1) * per]
            # a0 / a1: rows g / g + 8 at logical k per*t ..; a2 / a3 the
            # same rows at kk/2 + per*t; b0 / b1 column g at those k
            for reg, (r, half) in enumerate([(g, 0), (g + 8, 0), (g, 1),
                                             (g + 8, 1)]):
                A[r, half * kk // 2 + per * t:][:per] = \
                    word(W[r], 2 * m + half)
            for half in range(2):
                Bt[half * kk // 2 + per * t:][:per, g] = \
                    word(X[g], 2 * m + half)
        tiles.append((A, Bt))
    return tiles


@pytest.mark.parametrize("i8", [False, True], ids=["bf16", "s8"])
def test_chain_mma_fragments_pair_each_weight_with_its_input(i8):
    """The chain kernel loads 16 contiguous bytes of a weight row and of a
    staged row a lane and gives them to the mma as they are: the mma's k
    order is then a permutation of the stretch's, the same for A and B.
    Unpacked by the PTX fragment layout, each mma's A tile holds the
    packed weights' own values (every one exactly once over a stretch) and
    the products over all stretches give back W @ x."""
    rng = np.random.default_rng(0)
    K = 256 if i8 else 128
    if i8:
        W = rng.integers(-127, 128, (16, K)).astype(np.int64)
        X = rng.integers(-127, 128, (8, K)).astype(np.int64)
    else:
        W = rng.integers(-8, 8, (16, K)).astype(np.float64)
        X = rng.integers(-8, 8, (8, K)).astype(np.float64)
    acc = np.zeros((16, 8), W.dtype)
    for s in range(K // (64 if i8 else 32)):
        seen = []
        for A, Bt in _mma_fragments(W, X, s, i8):
            acc += A @ Bt
            seen.append(A)
        width = 64 if i8 else 32
        stretch = W[:, s * width:(s + 1) * width]
        got = np.concatenate(seen, 1)
        for r in range(16):
            assert sorted(got[r]) == sorted(stretch[r])
    np.testing.assert_array_equal(acc, W @ X.T)


def test_fused_cost_packing_layout():
    """One packed matrix a script weight, its rows padded to 8 columns:
    cell weights interleave like the resident chains (row 4u + c is
    column c * N/4 + u), head and query weights keep column order."""
    M, H, D = 6, 4, 12
    ws = [torch.randn(s) for s in weight_shapes("lstm", M, H, D)]
    packed = pack_weights("lstm", ws)
    assert [tuple(w.shape) for w in packed] == [(4 * H, 8)] + \
        [(4 * H, 8)] * 3 + [(128, 8)]
    u, c = 3, 2
    col = c * H + u
    for i in range(4):
        assert torch.equal(packed[i][4 * u + c, :ws[i].shape[0]],
                           ws[i][:, col].bfloat16())
    assert not packed[0][:, M:].any() and not packed[1][:, H:].any()
    assert torch.equal(packed[4][5, :H], ws[4][:, 5].bfloat16())
    dots = pack_weights("dots", [torch.randn(s)
                                 for s in weight_shapes("dots", M, H, D)])
    assert len(dots) == 4 and dots[3].shape == (4 * H, 8)
    (qa,) = pack_weights("attn", [torch.randn(M, D)])
    assert qa.shape == (D, 8)


@pytest.mark.parametrize("shape", [(8,), (8, 3), (16, 5)])
def test_interleave_gates_puts_a_units_gates_in_one_quad(shape):
    """The one gate layout of K1's and the probes' packers: row 4u + c is
    the gate-major row c * n + u, for weights and for 1-D biases and
    scales alike."""
    t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    out = interleave_gates(t)
    n = shape[0] // 4
    assert out.shape == t.shape
    for u in range(n):
        for c in range(4):
            assert torch.equal(out[4 * u + c], t[c * n + u])


def test_bound_adds_mixed_types_at_their_own_peaks():
    """chip_smoke.py's bound for work of two types (P5's attention: bf16
    products, fp32 tanh and softmax): each part over its own peak."""
    import chip_smoke
    peaks = chip_smoke.PEAK_OPS_S
    ms, by = chip_smoke.bound(0, {"bf16": peaks["bf16"] * 1e-3,
                                  "fp32": peaks["fp32"] * 1e-3})
    assert by == "operations" and ms == pytest.approx(2.0)
    assert chip_smoke.bound(0, peaks["bf16"] * 1e-3, "bf16")[0] == \
        pytest.approx(1.0)


@pytest.mark.parametrize("module", [
    "exp_w4_kernel_bisect", "exp_int4_variants", "exp_resident_weight",
    "exp_fused_int8", "exp_fused_cost"])
def test_probe_main_refuses_without_cuda(module, monkeypatch):
    """Without CUDA and without FLOWTRON_PLATFORM=cpu the probes raise and
    name the variable; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    import importlib
    mod = importlib.import_module(f"flowtron_tpu_torch.scripts.{module}")
    monkeypatch.delenv("FLOWTRON_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="FLOWTRON_PLATFORM"):
        mod.main(["1", "1"])


def test_scan_wrappers_have_no_silent_fallback():
    x = torch.ones(2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        resident_scan("bf16", x, [torch.ones(16, 16, device="meta")])
    with pytest.raises(ValueError, match="no kernel"):
        fused_cost("attn", torch.ones(2, 1, 8, device="meta"),
                   torch.ones(1, 4, 8, device="meta"),
                   [torch.ones(8, 8, device="meta")])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


_P3_EDGES = [("p3", b, 1664 if b == 64 else 256, 4096 if b == 64 else 1024,
               steps) for b in (1, 40, 64, 96) for steps in (1, 2, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("body,B,IN,OUT,steps", [
    ("p3", 64, 1664, 4096, 16), ("p3", 40, 256, 1024, 16),
    ("bf16", 8, 0, 0, 16), ("w8a8", 8, 0, 0, 16),
    ("bf16", 1, 0, 0, 16), ("w8a8", 1, 0, 0, 16),
    ("bf16", 12, 0, 0, 3), ("w8a8", 12, 0, 0, 3)] + _P3_EDGES,
    ids=["p3", "p3_ragged", "bf16", "w8a8", "bf16_B1", "w8a8_B1",
         "bf16_B12", "w8a8_B12"]
    + [f"p3_B{b}_{i}x{o}_steps{s}" for _, b, i, o, s in _P3_EDGES])
def test_resident_kernel_matches_plain_on_card(cuda_device, body, B, IN, OUT,
                                               steps):
    """csrc/resident.cu against its plain version on the card at the
    scripts' shapes (the chains also at B=1 and at B=12, two passes of
    batch rows), and P3 at batches that leave its 64-row pass ragged
    (1, 40) or need a second one (96), over 1, 2 and 16 steps (the final
    state in either buffer), chip_smoke.py's bars: the bf16 state and the
    last product within 1e-2 of their scale (fp32 sums in another order
    can move a bf16 rounding, which the later steps carry), the fp32
    states within 1e-3; and two scans equal bit for bit."""
    before = resident_scan.launches
    if body == "p3":
        w, x = port_p3.make_inputs(B, IN, OUT)
        args = (_probe.tensor(x, cuda_device, torch.bfloat16),
                [_probe.tensor(w, cuda_device, torch.bfloat16)], None)
    else:
        args = port_p4.to_device(body, port_p4.make_inputs(body, B),
                                 cuda_device)
    state, last = resident_scan(body, *args, steps=steps)
    state2, last2 = resident_scan(body, *args, steps=steps)
    ref, ref_last = resident_scan_reference(body, *args, steps=steps)
    torch.cuda.synchronize()
    _close(state.float().cpu().numpy(), ref.float().cpu().numpy(),
           1e-2 if body == "p3" else 1e-3)
    _close(last.cpu().numpy(), ref_last.cpu().numpy(), 1e-2)
    assert torch.equal(state, state2) and torch.equal(last, last2)
    assert resident_scan.launches == before + 2


@pytest.mark.parametrize("B,S,N", [(64, 1664, 4096), (8, 128, 256),
                                   (40, 256, 1024), (1, 256, 1024),
                                   (96, 256, 1024)])
def test_p3_check_takes_the_scripts_and_tests_shapes(B, S, N):
    p3_check(B, S, N, S, sms=132)
    p3_check(B, S, N, S)


@pytest.mark.parametrize("args,match", [
    ((0, 256, 1024, 256), r"B \(0\)"),
    ((8, 256, 1024, 128), r"rows \(128\) must equal the state width"),
    ((8, 192, 1024, 192), r"state width \(192\) must be a positive multiple"),
    ((8, 256, 1022, 256), r"N \(1022\)"),
    ((8, 512, 256, 512), r"N \(256\)"),
    ((8, 2432, 4096, 2432), "shared memory"),
], ids=["batch", "rows", "chunk", "quads", "narrow", "smem"])
def test_p3_check_names_each_constraint(args, match):
    with pytest.raises(ValueError, match=match):
        p3_check(*args)


def test_p3_check_limits_the_columns_a_block_owns():
    """At most 32 output columns a block: N = 4096 fits 132 SMs (32 a
    block), 8192 does not (64 a block), nor 4096 on a 64-SM card."""
    p3_check(64, 1664, 4096, 1664, sms=132)
    p3_check(64, 1664, 4096, 1664, sms=128)
    with pytest.raises(ValueError, match="64 output columns a block"):
        p3_check(64, 1664, 8192, 1664, sms=132)
    with pytest.raises(ValueError, match="exceed 32"):
        p3_check(64, 1664, 4096, 1664, sms=64)


def test_p3_scan_checks_shapes_on_the_cpu_too():
    x = torch.ones(2, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        resident_scan("p3", x, [torch.ones(192, 256, dtype=torch.bfloat16)])


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_cost_kernel_matches_plain_on_card(cuda_device, variant, B):
    """csrc/fused_cost.cu against its plain version on the card, 16 steps
    at the script's dims, B=1 and B=8: the fp32 mel within 1e-3 of its
    scale; two calls equal bit for bit; one launch a call."""
    ws, z, kv = port_p5.to_device(port_p5.make_inputs(variant, B, 16),
                                  cuda_device)
    before = fused_cost.launches
    mel = fused_cost(variant, z, kv, ws)
    mel2 = fused_cost(variant, z, kv, ws)
    ref = fused_cost_reference(variant, z, kv, ws)
    torch.cuda.synchronize()
    _close(mel.cpu().numpy(), ref.cpu().numpy(), 1e-3)
    assert torch.equal(mel, mel2)
    assert fused_cost.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 8])
def test_chain_options_match_the_default_on_card(cuda_device, B):
    """The one launch option, the dot clock, gives the default launch's
    state and gates bit for bit, and the clock rises barrier by
    barrier."""
    args = port_p4.to_device("bf16", port_p4.make_inputs("bf16", B),
                             cuda_device)
    state, last = resident_scan("bf16", *args, steps=4)
    clock = torch.zeros(16, dtype=torch.int64, device=cuda_device)
    state2, last2 = resident_scan("bf16", *args, steps=4, clock=clock)
    torch.cuda.synchronize()
    assert torch.equal(state, state2) and torch.equal(last, last2)
    assert bool((clock.diff() > 0).all())


P4_FULL = (1664, 1024, 1024, 1024)


@pytest.mark.parametrize("B", [1, 8])
def test_chain_plan_keeps_the_dots_that_fit_in_order(B):
    """At the script's shape on 132 SMs: 32 rows (two 16-row tiles) a
    block; bf16 keeps dots 0 and 1 in shared memory (22.0 MB over the
    grid) and reads dots 2 and 3 from L2; int8 keeps all four (19.4 MB).
    Offsets are 128-byte aligned, rows an odd multiple of 64 bytes apart,
    the resident slices back to back, and everything fits a block."""
    from flowtron_tpu_torch.ops.resident import (
        CHAIN_STATIC, SMEM_OPTIN, chain_plan, row_stride)
    bf = chain_plan("bf16", B, P4_FULL, 4096, 1664, 132)
    assert (bf.grid, bf.quads, bf.m_tiles, bf.rows) == (132, 8, 2, B)
    assert bf.resident == (1, 1, 0, 0) and bf.res_off[2:] == (-1, -1)
    assert bf.resident_bytes == 4096 * (1664 + 1024) * 2
    assert bf.smem == bf.res_off[1] + 32 * row_stride(2 * 1024)
    i8 = chain_plan("w8a8", B, P4_FULL, 4096, 1664, 132)
    assert i8.resident == (1, 1, 1, 1)
    assert i8.resident_bytes == 4096 * sum(P4_FULL)
    assert i8.smem == i8.res_off[3] + 32 * row_stride(1024)
    for plan in (bf, i8):
        assert plan.smem <= SMEM_OPTIN - CHAIN_STATIC
        offs = [plan.xf_off, plan.red_off, plan.scale_off] + \
            [o for o in plan.res_off if o >= 0]
        assert all(o % 128 == 0 for o in offs)
    assert all(row_stride(n) % 128 == 64 for n in (64, 128, 2048, 3328))


def test_chain_plan_without_prefetch_and_at_toy_size():
    """The dots that do not stay get no shared memory of their own (the
    plan ends at the last resident slice); the tests' toy chain (N = 512)
    has one quad a block, one 16-row tile, and keeps everything."""
    from flowtron_tpu_torch.ops.resident import chain_plan, row_stride
    plan = chain_plan("bf16", 1, P4_FULL, 4096, 1664, 132)
    assert plan.smem == plan.res_off[1] + 32 * row_stride(2 * 1024)
    assert plan.resident == (1, 1, 0, 0)
    toy = chain_plan("bf16", P4_B, tuple(k for k, _ in P4_SHAPES), 512, 256,
                     132)
    assert (toy.grid, toy.quads, toy.m_tiles) == (128, 1, 1)
    assert toy.resident == (1, 1, 1, 1)


@pytest.mark.parametrize("args,match", [
    (("p3", 1, (256,), 512, 256, 132), "not a chain"),
    (("bf16", 0, (256,), 512, 256, 132), r"B \(0\)"),
    (("bf16", 1, (256,) * 5, 512, 256, 132), "5 dots"),
    (("bf16", 1, (48,), 512, 256, 132), r"K \(48\) must be a positive "
                                         "multiple of 32"),
    (("w8a8", 1, (96,), 512, 256, 132), r"multiple of 64"),
    (("bf16", 1, (512,), 512, 256, 132), r"exceeds the state width"),
    (("bf16", 1, (256,), 520, 256, 132), r"N \(520\) must be a multiple "
                                         "of 16"),
    (("bf16", 1, (256,), 8192, 256, 32), "64 row quads a block"),
    (("bf16", 8, (16384,), 4096, 16384, 132), "staged rows"),
], ids=["body", "batch", "dots", "bf16_k", "int8_k", "k_gt_s", "n16",
        "quads", "smem"])
def test_chain_plan_names_each_constraint(args, match):
    from flowtron_tpu_torch.ops.resident import chain_plan
    with pytest.raises(ValueError, match=match):
        chain_plan(*args)


def test_chain_scan_checks_its_plan_on_the_cpu_too():
    x = torch.ones(1, 256)
    with pytest.raises(ValueError, match="multiple of 32"):
        resident_scan("bf16", x, [torch.ones(48, 512, dtype=torch.bfloat16)])


def test_barrier_counter_refuses_to_overflow():
    """Each grid barrier adds one a block to one 32-bit counter: the
    scripts' scans stay far below it, a scan of 2^32 / 132 barriers
    does not, and the wrappers refuse it on either device."""
    from flowtron_tpu_torch.ops import _build
    _build.check_barriers(2000 * 4, 132)
    _build.check_barriers(400 * 3, 132)
    with pytest.raises(ValueError, match="overflow the barrier's 32-bit"):
        _build.check_barriers(2 ** 32 // 132 + 1, 132)
    x = torch.ones(1, 256)
    with pytest.raises(ValueError, match="overflow"):
        resident_scan("bf16", x, [torch.ones(256, 512, dtype=torch.bfloat16)],
                      steps=2 ** 32 // 128)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("n_blocks", [1, 7, 132])
def test_p5_plan_owns_every_quad_once_in_order(variant, n_blocks):
    """Each job's row quads split over the grid: contiguous ranges in
    block order, every quad owned exactly once, at most one quad apart
    between blocks; the stages are p5_plan's, in csrc/fused_cost.cu's
    order."""
    from flowtron_tpu_torch.ops.fused_cost import p5_bounds_array, p5_plan
    M, H, D, Tk = 80, 1024, 640, 128
    Nc = {"dots": 4 * H, "lstm": 128, "attn": D}[variant]
    plan = p5_plan(variant, 1, M, H, D, Tk, Nc, n_blocks)
    names = {"dots": [("cell", ["w0"]), ("cell2", ["w2", "w1"]),
                      ("head", ["w3"])],
             "lstm": [("cell", ["w0"]), ("cell2", ["w2", "w1"]),
                      ("head", ["w4", "w3"])],
             "attn": [("query", ["w0"]), ("attention", [])]}[variant]
    assert [(st.name, [j[0] for j in st.jobs]) for st in plan.stages] == \
        names
    for st in plan.stages:
        for (_, rows, _), bounds in zip(st.jobs, st.bounds):
            assert len(bounds) == n_blocks + 1
            assert bounds[0] == 0 and bounds[-1] == -(-rows // 4)
            sizes = [b - a for a, b in zip(bounds, bounds[1:])]
            assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
            owner = [i for i, n in enumerate(sizes) for _ in range(n)]
            assert owner == sorted(owner) and len(owner) == rows // 4
    flat = p5_bounds_array(plan)
    assert len(flat) == len(plan.stages) * 2 * (n_blocks + 1)


@pytest.mark.parametrize("args,match", [
    (("conv", 1, 80, 1024, 640, 128, 4096, 132), "variant 'conv'"),
    (("dots", 0, 80, 1024, 640, 128, 4096, 132), "every size must be "
                                                 "positive"),
    (("lstm", 1, 80, 2, 640, 128, 128, 132), "H at least 4"),
    (("dots", 1, 80, 1022, 640, 128, 4088, 132), r"H \(1022\), Nc"),
    (("dots", 1, 78, 1024, 640, 128, 4096, 132), r"M \(78\) must be"),
    (("lstm", 1, 80, 1024, 640, 128, 64, 132), r"Nc \(64\).*Nc at least M"),
    (("attn", 1, 80, 0, 72, 128, 72, 132), r"M \(80\) <= D \(72\)"),
    (("attn", 1, 20, 0, 640, 128, 640, 132), "multiples of 8"),
    (("attn", 1, 264, 0, 640, 128, 640, 132), r"M \(264\) exceeds 256"),
    (("attn", 64, 80, 0, 640, 1024, 640, 132), "staged inputs exceed"),
], ids=["variant", "size", "h4", "quarters", "mel4", "nc", "d_lt_m",
        "chunks", "wide_m", "smem"])
def test_p5_plan_names_each_constraint(args, match):
    from flowtron_tpu_torch.ops.fused_cost import p5_plan
    with pytest.raises(ValueError, match=match):
        p5_plan(*args)


def test_p5_split_divides_k1s_frame_as_pr4_did():
    """chip_smoke.py's p5_split: streaming is K1's weight bytes at the rate
    P5's dots variant streams its own, LSTM the lstm variant's extra time,
    attention the attn variant's time, and the four shares add to one."""
    import chip_smoke
    frame = dict(stage_us_per_frame={"att": 30.0, "query": 30.0,
                                     "head": 40.0},
                 weight_bytes=4e8)
    p5_us = {"dots": (20.0, 1e8, {"cell": 5.0, "cell2": 9.0, "head": 6.0}),
             "lstm": (23.0, 1e8, {}), "attn": (10.0, 1e5, {})}
    out = chip_smoke.p5_split(frame, p5_us)
    assert out["frame_us"] == 100.0
    assert out["us"] == pytest.approx({"streaming": 80.0, "lstm": 3.0,
                                       "attention": 10.0,
                                       "unattributed": 7.0})
    assert sum(out["share"].values()) == pytest.approx(1.0)
    assert out["dots_tb_per_s"] == pytest.approx(5.0)
    assert out["p5_fixed_us_per_stage"] == 5.0
    assert out["k1_stages_at_p5_fixed_cost_share"] == pytest.approx(0.15)
