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
    weight is only transposed; scales follow their columns."""
    w = torch.arange(3 * 8, dtype=torch.float32).reshape(3, 8)
    s = torch.arange(8, dtype=torch.float32)
    (pw,), (ps,) = pack_resident_weights("w8a8", [w], [s])
    for u in range(2):
        for c in range(4):
            assert torch.equal(pw[4 * u + c], w[:, 2 * c + u])
            assert ps[4 * u + c] == s[2 * c + u]
    (p3w,), _ = pack_resident_weights("p3", [w])
    assert torch.equal(p3w, w.t())


def test_fused_cost_packing_layout():
    """Cell weights interleave like the resident chains and concatenate
    their inputs, each padded to 8 columns; head and query weights keep
    column order."""
    M, H, D = 6, 4, 12
    ws = [torch.randn(s) for s in weight_shapes("lstm", M, H, D)]
    wa, wb, wc = pack_weights("lstm", ws)
    assert wa.shape == (4 * H, 8 + 8) and wb.shape == (4 * H, 16)
    assert wc.shape == (128, 8)
    u, c = 3, 2
    col = c * H + u
    assert torch.equal(wa[4 * u + c, :M], ws[0][:, col].bfloat16())
    assert torch.equal(wa[4 * u + c, 8:8 + H], ws[1][:, col].bfloat16())
    assert not wa[:, M:8].any() and not wa[:, 8 + H:].any()
    assert torch.equal(wc[5, :H], ws[4][:, 5].bfloat16())
    (qa, _, _) = pack_weights("attn", [torch.randn(M, D)])
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
    ("bf16", 8, 0, 0, 16), ("w8a8", 8, 0, 0, 16)] + _P3_EDGES,
    ids=["p3", "p3_ragged", "bf16", "w8a8"]
    + [f"p3_B{b}_{i}x{o}_steps{s}" for _, b, i, o, s in _P3_EDGES])
def test_resident_kernel_matches_plain_on_card(cuda_device, body, B, IN, OUT,
                                               steps):
    """csrc/resident.cu against its plain version on the card at the
    scripts' shapes, and P3 at batches that leave its 64-row pass ragged
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
@pytest.mark.parametrize("variant", VARIANTS)
def test_fused_cost_kernel_matches_plain_on_card(cuda_device, variant):
    """csrc/fused_cost.cu against its plain version on the card, 16 steps
    at the script's dims, B=8: the fp32 mel within 1e-3 of its scale."""
    ws, z, kv = port_p5.to_device(port_p5.make_inputs(variant, 8, 16),
                                  cuda_device)
    before = fused_cost.launches
    mel = fused_cost(variant, z, kv, ws)
    ref = fused_cost_reference(variant, z, kv, ws)
    torch.cuda.synchronize()
    _close(mel.cpu().numpy(), ref.cpu().numpy(), 1e-3)
    assert fused_cost.launches == before + 1
