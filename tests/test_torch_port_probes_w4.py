"""P1 and P2, the int4 dequant-matmul probes, in the port against the
unchanged JAX scripts (scripts/exp_w4_kernel_bisect.py,
scripts/exp_int4_variants.py) at toy size: IN=256, OUT=1024, B=8, TN=512,
3 scan steps. The scripts' Pallas bodies run in TPU interpret mode on the
CPU, their XLA baselines compiled; the port runs its plain versions
(ops/w4.py, flowtron_tpu_torch/scripts/) on the same numpy arrays.

Bars: bf16 outputs within one bf16 step of JAX's (the fp32 sums run in
another order); the inputs bit for bit.
"""

import numpy as np
import pytest
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from flowtron_tpu_torch.ops.w4 import (  # noqa: E402
    BODIES, w4_matmul, w4_matmul_reference, w4_plan)
from flowtron_tpu_torch.scripts import (  # noqa: E402
    _probe, exp_int4_variants as port_p2, exp_w4_kernel_bisect as port_p1)
from tests.probe_scripts import (  # noqa: E402
    JitRecorder, assert_within_bf16_ulp, f32, load_script)

IN, OUT, B, TN, STEPS = 256, 1024, 8, 512, 3
NG = IN // 128
P1_BODIES = ["k1", "k2", "k3", "k4", "k5"]
P2_KEYS = [key for _, key, _, _ in port_p2.VARIANTS]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def p1():
    """The script's five bodies run once through its own ``build``, and
    its ``time_in_scan`` for k3 and k5, in interpret mode: {body: out},
    {body: final carry}, the inputs."""
    mod = load_script("exp_w4_kernel_bisect")
    mod.IN, mod.OUT, mod.B, mod.TN, mod.G, mod.NG = IN, OUT, B, TN, 128, NG
    rec = JitRecorder()
    mod.jax = rec
    outs, scans = {}, {}
    with pltpu.force_tpu_interpret_mode():
        for body in P1_BODIES:
            f, args = mod.build(getattr(mod, body))
            outs[body] = f32(rec.jit(f)(*args))
        for body in ("k3", "k5"):
            mod.time_in_scan(body, getattr(mod, body), steps=STEPS)
            scans[body] = f32(rec.outputs[-1])
    return outs, scans, [np.asarray(a) for a in args]


@pytest.fixture(scope="module")
def p2():
    """Every variant of the script's ``main``: its dot function and
    arguments (through a wrapped ``scan_of``) and the scan's final carry
    (through a replaced ``timeit``), Pallas bodies in interpret mode."""
    mod = load_script("exp_int4_variants")
    mod.IN, mod.OUT, mod.STEPS, mod.B = IN, OUT, STEPS, B
    scan_of, runs = mod.scan_of, []

    def wrapped_scan_of(dot_fn):
        run = scan_of(dot_fn)
        run.dot_fn = dot_fn
        return run

    def timeit(name, fn, *args):
        import jax
        runs.append((name, fn.dot_fn, args, f32(jax.jit(fn)(*args))))

    mod.scan_of, mod.timeit = wrapped_scan_of, timeit
    with pltpu.force_tpu_interpret_mode():
        mod.main()
        out = {}
        for (name, dot_fn, args, carry), key in zip(runs, P2_KEYS):
            import jax
            out[key] = (name, [np.asarray(a) for a in args],
                        f32(jax.jit(dot_fn)(*args)), carry)
    return out


def test_p1_inputs_are_the_scripts(p1):
    x, q4, s = port_p1.make_inputs(B, IN, OUT, NG)
    jx, jq, js = p1[2]
    np.testing.assert_array_equal(_t(x, torch.bfloat16).float().numpy(),
                                  f32(jx))
    np.testing.assert_array_equal(q4, jq)
    np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("body", P1_BODIES)
def test_p1_body_matches_jax(p1, body):
    x, q, s = port_p1.to_device(port_p1.make_inputs(B, IN, OUT, NG), "cpu")
    out = w4_matmul(x, q, s, body)
    assert out.dtype == torch.bfloat16 and out.shape == (B, OUT)
    assert_within_bf16_ulp(out.float().numpy(), p1[0][body])


def test_p1_k4_scales_other_rows_than_k3(p1):
    """The TPU bisect's "+repeat-scale" body is not k3 done another way:
    ``pltpu.repeat`` tiles the whole scale block, so row r meets s[r %
    NG]. JAX's own outputs differ, and the port's k4 follows them."""
    k3, k4 = p1[0]["k3"], p1[0]["k4"]
    assert np.abs(k3 - k4).max() > 0.1 * np.abs(k3).max()
    x, q, s = port_p1.to_device(port_p1.make_inputs(B, IN, OUT, NG), "cpu")
    r = torch.arange(IN)
    lo, hi = (q.to(torch.int32) << 28) >> 28, q.to(torch.int32) >> 4
    w = torch.cat([lo, hi]).float()
    bf = lambda t: t.to(torch.bfloat16).float()   # noqa: E731
    by_group = (x.float() @ bf(w * bf(s)[r // 128])).to(torch.bfloat16)
    assert_within_bf16_ulp(by_group.float().numpy(), k3)
    assert not np.allclose(by_group.float().numpy(), k4, atol=1e-2)


@pytest.mark.parametrize("body", ["k3", "k5"])
def test_p1_scan_matches_jax(p1, body):
    x, q, s = port_p1.to_device(port_p1.make_inputs(B, IN, OUT, NG), "cpu")
    carry = _probe.scan(port_p1.scan_step(body, q, s), x, STEPS)()
    assert carry.dtype == torch.bfloat16
    assert_within_bf16_ulp(carry.float().numpy(), p1[1][body])


def test_p1_main_prints_the_scripts_lines(p1, monkeypatch, capsys):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    res = port_p1.main([str(B), str(STEPS)], IN=IN, OUT=OUT, NG=NG)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == (
        [name for name, _ in port_p1.TRY]
        + [f"{name} scan" for name, _ in port_p1.SCANS])
    for body in P1_BODIES:
        total, out = res[body]
        assert f"OK {total:.3f}" in lines[P1_BODIES.index(body)]
        assert_within_bf16_ulp(out.float().numpy(), p1[0][body])
    assert all(ln.endswith("us/step") for ln in lines[-2:])
    assert_within_bf16_ulp(res["k5 scan"][1].float().numpy(), p1[1]["k5"])


def test_p2_inputs_are_the_scripts(p2):
    ours = port_p2.make_inputs(B, IN, OUT)
    for key in P2_KEYS:
        x, q, s = ours[key]
        jx, jq, js = p2[key][1]
        np.testing.assert_array_equal(_t(x, torch.bfloat16).float().numpy(),
                                      f32(jx))
        np.testing.assert_array_equal(q, jq)
        np.testing.assert_array_equal(s, js)


@pytest.mark.parametrize("key", P2_KEYS)
def test_p2_dot_matches_jax(p2, key):
    """One dot of each variant: the four XLA baselines (plain PyTorch in
    the port) and the two Pallas bodies (ops/w4.py)."""
    name, args, ref, _ = p2[key]
    dot = dict((k, d) for _, k, d, _ in port_p2.VARIANTS)[key]
    x, q, s = port_p2.make_inputs(B, IN, OUT)[key]
    out = dot(_t(x, torch.bfloat16), _t(q), _t(s))
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape, name
    assert_within_bf16_ulp(out.float().numpy(), ref)


@pytest.mark.parametrize("key", P2_KEYS)
def test_p2_scan_matches_jax(p2, key):
    name, _, _, ref = p2[key]
    dot = dict((k, d) for _, k, d, _ in port_p2.VARIANTS)[key]
    x, q, s = port_p2.make_inputs(B, IN, OUT)[key]
    carry = _probe.scan(port_p2.scan_step(dot, _t(q), _t(s)),
                        _t(x, torch.bfloat16), STEPS)()
    assert carry.dtype == torch.bfloat16
    assert_within_bf16_ulp(carry.float().numpy(), ref)


def test_p2_main_prints_the_scripts_lines(p2, monkeypatch, capsys):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    res = port_p2.main([str(B), str(STEPS)], IN=IN, OUT=OUT)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0].rstrip() for ln in lines] == \
        [p2[key][0] for key in P2_KEYS]
    assert all(ln.endswith("us/step") for ln in lines)
    for key in P2_KEYS:
        assert_within_bf16_ulp(res[key][1].float().numpy(), p2[key][3])


def test_bf16_scan_constants_are_jaxs():
    """JAX rounds the scan's Python constants to bf16 before multiplying a
    bf16 carry; the port uses the rounded values."""
    c = jnp.ones((), jnp.bfloat16)
    assert float(0.999 * c) == _probe.BF16_0999 == 1.0
    assert float(0.001 * c) == _probe.BF16_0001


def test_w4_wrapper_has_no_silent_fallback():
    x = torch.ones(4, 256, dtype=torch.bfloat16, device="meta")
    q = torch.ones(128, 64, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        w4_matmul(x, q, torch.ones(2, 64, device="meta"), "k3")


def _ng(body, IN, G=128):
    return IN // (64 if body == "2dot" else G)


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("shape", [(64, 1664, 4096), (B, IN, OUT),
                                   (1, 1664, 4096), (80, 256, 1024)],
                         ids=["scripts", "toy", "b1", "b80"])
def test_w4_plan_takes_the_scripts_and_tests_shapes(body, shape):
    """The scripts' shape, the CPU tests' toy shape and the card tests'
    edge batches pass the plan; on the H100's 132 SMs the rows split as
    far as one wave of blocks allows."""
    b, i, o = shape
    assert w4_plan(b, i, o, _ng(body, i), body, sms=132) == min(
        8, i // 128, 132 // (o // 64))
    assert w4_plan(b, i, o, _ng(body, i), body) is None


@pytest.mark.parametrize("args,match", [
    ((0, 256, 1024, 2, "k3"), r"B \(0\)"),
    ((8, 192, 1024, 2, "k2"), r"IN \(192\)"),
    ((8, 256, 1000, 2, "k2"), r"OUT \(1000\)"),
    ((8, 256, 32, 2, "k2"), r"OUT \(32\)"),
    ((8, 256, 1024, 0, "k4"), r"NG \(0\)"),
    ((8, 8192, 1024, 65, "k4"), r"NG \(65\)"),
    ((8, 256, 1024, 3, "k3"), r"group IN / NG \(256 / 3\)"),
    ((8, 384, 1024, 4, "k5"), r"group IN / NG \(384 / 4\)"),
    ((8, 256, 1024, 2, "k9"), "body 'k9'"),
], ids=["batch", "in", "out", "out_small", "ng_zero", "ng_large",
        "group_uneven", "group_short", "body"])
def test_w4_plan_names_each_constraint(args, match):
    with pytest.raises(ValueError, match=match):
        w4_plan(*args)


def test_w4_plan_split_fills_one_wave_within_its_limits():
    assert w4_plan(64, 1664, 4096, 13, "k3", sms=132) == 2
    # a card that runs 66 clusters of 2 of these blocks at once fits the
    # 64 column tiles of the scripts' shape in one wave; on one that runs
    # 63 they would take two, so the rows are not split
    held = {2: 66, 3: 39, 4: 30, 5: 24, 6: 21, 7: 18, 8: 15}
    assert w4_plan(64, 1664, 4096, 13, "k3", sms=132,
                   clusters=held.get) == 2
    assert w4_plan(64, 1664, 4096, 13, "k3", sms=132,
                   clusters=lambda k: 63) == 1
    assert w4_plan(8, 256, 1024, 2, "k3", sms=132,
                   clusters=held.get) == 2
    assert w4_plan(8, 256, 1024, 2, "k3", sms=132) == 2
    assert w4_plan(8, 8192, 1024, 64, "k3", sms=132) == 8
    assert w4_plan(8, 1664, 32768, 13, "k3", sms=132) == 1
    assert w4_plan(8, 1664, 4096, 13, "k1", sms=16) == 1


def test_w4_matmul_checks_shapes_on_the_cpu_too():
    """A shape the kernel does not take raises ValueError naming the
    constraint on the CPU as on the card, before any plain version runs."""
    x = torch.ones(4, 256, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"OUT \(96\)"):
        w4_matmul(x, torch.ones(128, 96, dtype=torch.int8),
                  torch.ones(2, 96), "k3")
    with pytest.raises(ValueError, match="group IN / NG"):
        w4_matmul(x, torch.ones(128, 128, dtype=torch.int8),
                  torch.ones(3, 128), "k5")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8, 17, 64, 80])
@pytest.mark.parametrize("body", sorted(BODIES))
def test_w4_kernel_matches_plain_on_card(cuda_device, body, batch):
    """csrc/w4.cu against its plain version at the probes' shape and at
    the toy shape, at batches that fill one 64-row pass, leave it ragged
    (1, 8, 17) or need a second one (80): within 1e-2 of the output
    scale, chip_smoke.py's bar (the fp32 sums run in another order, split
    over a cluster of blocks, and where they cancel a bf16 rounding can
    move by more than one step of the small result), and two calls equal
    bit for bit (the split sums meet in a fixed order)."""
    before = w4_matmul.launches
    for i, o in ((1664, 4096), (IN, OUT)):
        x, q, s = port_p1.to_device(
            port_p1.make_inputs(batch, i, o, _ng(body, i)), cuda_device)
        out = w4_matmul(x, q, s, body)
        again = w4_matmul(x, q, s, body)
        ref = w4_matmul_reference(x, q, s, body).float()
        torch.cuda.synchronize()
        assert float((out.float() - ref).abs().max()) <= 1e-2 * float(
            ref.abs().max())
        assert torch.equal(out, again)
    assert w4_matmul.launches == before + 4


@pytest.mark.cuda
def test_p2_main_counts_every_kernel_launch_on_card(cuda_device, capsys):
    """The kernels' scans run eagerly in the entry point, so each body's
    counter gains one a step of every run: the warm-up and the three
    timed runs of ``time_per_step``."""
    steps = 3
    before = {b: getattr(w4_matmul, f"launches_{b}")
              for b in ("concat", "2dot")}
    port_p2.main([str(B), str(steps)], device=cuda_device, IN=IN, OUT=OUT)
    torch.cuda.synchronize()
    for b, n in before.items():
        assert getattr(w4_matmul, f"launches_{b}") == n + 4 * steps
