"""Kernel K2 (flowtron_tpu_torch/ops/wavenet.py) and the port's WaveGlow
against the JAX package: the WN layer's plain version against the Pallas
kernel in interpret mode, an emulation of the CUDA kernel's split-bf16
arithmetic against the same at flagship width, the kernel's plan and
weight packs, and the whole inverse pass with the same numpy latents. The
zero-init end convs are perturbed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.ops.wavenet_pallas import wn_layer_fused  # noqa: E402
from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402
from flowtron_tpu.vocoder.waveglow import (  # noqa: E402
    _shift_t, _upsample_mel as jax_upsample,
    waveglow_infer_z as jax_waveglow_infer_z,
)

from flowtron_tpu_torch.ops.wavenet import (  # noqa: E402
    SMEM_LIMIT, WN_BUILDS, wn_layer, wn_layer_reference, wn_pack_weights,
    wn_plan, wn_smem_bytes, wn_split_weights,
)
from flowtron_tpu_torch.utils.convert import waveglow_from_jax  # noqa: E402
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    _upsample_mel, load_waveglow, waveglow_init, waveglow_infer_z,
    waveglow_n_remaining,
)

TINY = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
            n_early_size=2, n_layers=2, n_channels=16, kernel_size=3)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def wg():
    params, cfg = jax_waveglow_init(jax.random.PRNGKey(0), **TINY)
    rng = np.random.default_rng(1)
    for f in range(cfg["n_flows"]):
        params["wn"][f]["end"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            params["wn"][f]["end"]["w"].shape).astype(np.float32))
    model, tcfg = waveglow_init(**TINY)
    model.load_state_dict(waveglow_from_jax(jax.tree.map(np.asarray, params),
                                            cfg), strict=True)
    return params, cfg, model, tcfg


class TestWNLayer:
    # T = 300 is not a multiple of the 128-row tile: rows 300..383 pad
    @pytest.mark.parametrize("last", [False, True])
    @pytest.mark.parametrize("d", [1, 4])
    def test_matches_pallas_interpret(self, last, d):
        rng = np.random.default_rng(2)
        B, C, T, tile = 2, 16, 300, 128
        Tp = -(-T // tile) * tile
        x = rng.standard_normal((B, Tp, C)).astype(np.float32)
        x[:, T:] = 0
        cond = rng.standard_normal((B, Tp, 2 * C)).astype(np.float32)
        w_cat = (0.2 * rng.standard_normal((3 * C, 2 * C))).astype(np.float32)
        b = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
        n_rs = C if last else 2 * C
        w_rs = (0.2 * rng.standard_normal((C, n_rs))).astype(np.float32)
        b_rs = (0.1 * rng.standard_normal(n_rs)).astype(np.float32)
        xj, M = jnp.asarray(x), B * Tp
        x_new_j, skip_j = wn_layer_fused(
            _shift_t(xj, d).reshape(M, C), xj.reshape(M, C),
            _shift_t(xj, -d).reshape(M, C), jnp.asarray(cond).reshape(M, -1),
            jnp.asarray(w_cat), jnp.asarray(b), jnp.asarray(w_rs),
            jnp.asarray(b_rs), T=T, Tp=Tp, last=last, tile=tile,
            interpret=True)
        x_new, skip = wn_layer(_t(x), d, _t(cond), _t(w_cat), _t(b),
                               _t(w_rs), _t(b_rs), T)
        np.testing.assert_allclose(skip.numpy(),
                                   np.asarray(skip_j).reshape(B, Tp, -1),
                                   atol=1e-5)
        if last:
            assert x_new is None
        else:
            np.testing.assert_allclose(x_new.numpy(),
                                       np.asarray(x_new_j).reshape(B, Tp, C),
                                       atol=1e-5)
            assert float(x_new[:, T:].abs().max()) == 0.0

    def test_shift_reads_zero_outside_valid_rows(self):
        """Rows t >= T are padding even if they hold garbage: the shifted
        taps read zeros there, so valid rows do not see them."""
        rng = np.random.default_rng(3)
        B, C, T, Tp = 1, 16, 10, 16
        args = [rng.standard_normal(s).astype(np.float32) for s in
                ((B, Tp, 2 * C), (3 * C, 2 * C), (2 * C,), (C, 2 * C),
                 (2 * C,))]
        x = rng.standard_normal((B, Tp, C)).astype(np.float32)
        clean = x.copy()
        clean[:, T:] = 0
        a = wn_layer_reference(_t(x), 2, *map(_t, args), T)
        b = wn_layer_reference(_t(clean), 2, *map(_t, args), T)
        torch.testing.assert_close(a[0], b[0])
        torch.testing.assert_close(a[1][:, :T], b[1][:, :T])


def _layer_inputs(rng, B, C, T, Tp, last):
    """A WN layer's numpy inputs at init-like scales: x zero on pad rows."""
    x = rng.standard_normal((B, Tp, C)).astype(np.float32)
    x[:, T:] = 0
    cond = rng.standard_normal((B, Tp, 2 * C)).astype(np.float32)
    w_cat = (rng.standard_normal((3 * C, 2 * C))
             / np.sqrt(3 * C)).astype(np.float32)
    b = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
    n_rs = C if last else 2 * C
    w_rs = (rng.standard_normal((C, n_rs)) / np.sqrt(C)).astype(np.float32)
    b_rs = (0.1 * rng.standard_normal(n_rs)).astype(np.float32)
    return x, cond, w_cat, b, w_rs, b_rs


def _split(a):
    """fp32 -> (hi, lo) = (bf16(a), bf16(a - hi)), round to nearest even
    as cvt.rn.bf16x2.f32, both returned as fp32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    hi = t.bfloat16().float()
    return hi.numpy(), (t - hi).bfloat16().float().numpy()


def _three_pass(a, w_hi, w_lo):
    """a @ w as csrc/wavenet.cu sums it: a split into hi/lo, hi*hi +
    hi*lo + lo*hi, each bf16 product exact in fp32, fp32 sums."""
    a_hi, a_lo = _split(a)
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


def _bf16_round(a):
    """fp32 -> bf16 (round to nearest even) -> fp32, as cvt.rn.bf16x2."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)) \
        .bfloat16().float().numpy()


def _emulate_wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T, nh, bf16=False):
    """The kernel's arithmetic on the host, through the packs it reads
    (``wn_split_weights``): acts in nh passes of paired columns, the gate
    in fp32, z split again before the res/skip product. ``bf16``: the bf16
    body (its inputs bf16 values): the plain packs of ``wn_pack_weights``,
    one pass of exact bf16 products summed in fp32, z rounded to bf16, the
    outputs rounded to bf16."""
    B, Tp, C = x.shape
    M = B * Tp
    if bf16:
        w1, w2 = (w.float().numpy() for w in wn_pack_weights(
            torch.from_numpy(w_cat), torch.from_numpy(w_rs), nh))

        def product(a, w):
            return a @ w
    else:
        w1, w2 = (w.float().numpy() for w in wn_split_weights(
            torch.from_numpy(w_cat), torch.from_numpy(w_rs), nh))

        def product(a, w):
            return _three_pass(a, w[:, 0], w[:, 1])
    t = np.arange(Tp)
    taps = []
    for shift in (-d, 0, d):
        src = t + shift
        ok = (src >= 0) & (src < T)
        tap = np.zeros_like(x)
        tap[:, ok] = x[:, src[ok]]
        taps.append(tap)
    a = np.concatenate(taps, axis=-1).reshape(M, 3 * C)
    packed = np.concatenate([product(a, w1[h]) for h in range(nh)], axis=1)
    # packed column 16 q + 8 s + e is acts column s * C + 8 q + e
    acts = packed.reshape(M, C // 8, 2, 8).transpose(0, 2, 1, 3) \
        .reshape(M, 2 * C) + b + cond.reshape(M, 2 * C)
    z = np.tanh(acts[:, :C]) / (1 + np.exp(-acts[:, C:]))
    out = _bf16_round if bf16 else (lambda v: v)
    if bf16:
        z = _bf16_round(z)
    rs = np.concatenate([product(z, w2[h]) for h in range(w2.shape[0])],
                        axis=1) + b_rs
    rs = rs.reshape(B, Tp, -1)
    if w_rs.shape[1] == C:
        return None, out(rs)
    valid = (t < T)[None, :, None]
    return out(np.where(valid, x + rs[..., :C], 0)), out(rs[..., C:])


class TestKernelArithmetic:
    """csrc/wavenet.cu's split-bf16 products, emulated on the CPU: the
    kernel cannot run here, but the arithmetic it does can."""

    @pytest.mark.parametrize("last", [False, True])
    @pytest.mark.parametrize("d", [1, 128])
    def test_emulation_matches_pallas_interpret(self, d, last):
        """At flagship width (C = 256) three bf16 passes stay within K2's
        1e-4 of the output scale of JAX's kernel, for both column-pass
        layouts the kernel is built with."""
        rng = np.random.default_rng(7 + d)
        B, C, T, Tp, tile = 2, 256, 300, 384, 128
        x, cond, w_cat, b, w_rs, b_rs = _layer_inputs(rng, B, C, T, Tp, last)
        xj, M = jnp.asarray(x), B * Tp
        ref = wn_layer_fused(
            _shift_t(xj, d).reshape(M, C), xj.reshape(M, C),
            _shift_t(xj, -d).reshape(M, C), jnp.asarray(cond).reshape(M, -1),
            jnp.asarray(w_cat), jnp.asarray(b), jnp.asarray(w_rs),
            jnp.asarray(b_rs), T=T, Tp=Tp, last=last, tile=tile,
            interpret=True)
        for nh in sorted(set(WN_BUILDS[C].values())):
            ours = _emulate_wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T, nh)
            for o, r in zip(ours, ref):
                if o is None:
                    continue
                r = np.asarray(r).reshape(o.shape)
                assert np.abs(o - r).max() <= 1e-4 * max(1.0, np.abs(r).max())
            if last:
                assert ours[0] is None
            else:
                assert np.all(ours[0][:, T:] == 0)

    @pytest.mark.parametrize("last", [False, True])
    def test_bf16_emulation_matches_pallas_interpret(self, last):
        """The bf16 body's arithmetic at flagship width (C = 256), for both
        column-pass layouts built, against the Pallas kernel in interpret
        mode on bf16 inputs: within 1e-2 of the output scale (each output
        is one bf16 rounding on both sides, which the fp32 sums' order and
        z's rounding move by a step)."""
        rng = np.random.default_rng(11)
        B, C, T, Tp, tile, d = 1, 256, 300, 384, 128, 8
        args = [_bf16_round(a) for a in _layer_inputs(rng, B, C, T, Tp,
                                                       last)]
        x, cond, w_cat, b, w_rs, b_rs = args
        xj, M = jnp.asarray(x, jnp.bfloat16), B * Tp
        ref = wn_layer_fused(
            _shift_t(xj, d).reshape(M, C), xj.reshape(M, C),
            _shift_t(xj, -d).reshape(M, C),
            jnp.asarray(cond, jnp.bfloat16).reshape(M, -1),
            *(jnp.asarray(a, jnp.bfloat16) for a in (w_cat, b, w_rs, b_rs)),
            T=T, Tp=Tp, last=last, tile=tile, interpret=True)
        for nh in sorted(set(WN_BUILDS[C].values())):
            ours = _emulate_wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T, nh,
                                     bf16=True)
            for o, r in zip(ours, ref):
                if o is None:
                    continue
                r = np.asarray(jnp.asarray(r, jnp.float32)).reshape(o.shape)
                err, scale = np.abs(o - r).max(), np.abs(r).max()
                print(f"K2 bf16 emulation nh={nh} last={last}: max |err| "
                      f"{err:.3g}, scale {scale:.3g}")
                assert err <= 1e-2 * scale

    @pytest.mark.parametrize("C", [512, 1024])
    def test_emulation_at_the_wide_builds(self, C):
        """The column passes of the 512- and 1024-wide builds (4 and 2
        passes at 512, 8 at 1024) keep K2's 1e-4 of the output scale of
        the plain layer, its last layer too."""
        rng = np.random.default_rng(C)
        B, T, Tp, d = 1, 100, 128, 4
        for last in (False, True):
            args = _layer_inputs(rng, B, C, T, Tp, last)
            ref = wn_layer_reference(*map(_t, args[:1]), d,
                                     *map(_t, args[1:]), T)
            for nh in sorted(set(WN_BUILDS[C].values())):
                ours = _emulate_wn_layer(args[0], d, *args[1:], T, nh)
                for o, r in zip(ours, ref):
                    if r is None:
                        assert o is None
                        continue
                    r = r.numpy()
                    assert np.abs(o - r).max() <= 1e-4 * max(
                        1.0, np.abs(r).max()), (nh, last)

    def test_split_reconstructs_to_2e_16(self):
        """hi + lo gives each operand back to 2^-16 of its magnitude (hi
        carries 8 bits, lo the next 8), so the dropped lo*lo term is below
        2^-16 of a product."""
        a = np.random.default_rng(3).standard_normal(100_000).astype(
            np.float32) * np.float32(10.0) ** np.random.default_rng(4) \
            .integers(-6, 6, 100_000).astype(np.float32)
        hi, lo = _split(a)
        assert np.all(np.abs(a.astype(np.float64) - hi - lo)
                      <= 2.0 ** -16 * np.abs(a))
        assert np.all(np.abs(lo) <= 2.0 ** -8 * np.abs(a))

    @pytest.mark.parametrize("nh", [1, 2])
    @pytest.mark.parametrize("last", [False, True])
    def test_packs_read_back_at_the_kernel_index(self, nh, last):
        """The packs hold w's hi/lo where csrc/wavenet.cu reads them: w1's
        pass h, row k, packed column p (channel block q = p // 16, half
        s = p // 8 % 2) is w_cat[k, s * C + 8 q + p % 8]; w2's pass h,
        column c is w_rs[k, h * W2 + c]."""
        C = 64
        rng = np.random.default_rng(5)
        w_cat = torch.from_numpy(rng.standard_normal((3 * C, 2 * C))
                                 .astype(np.float32))
        n_rs = C if last else 2 * C
        w_rs = torch.from_numpy(rng.standard_normal((C, n_rs))
                                .astype(np.float32))
        w1, w2 = wn_split_weights(w_cat, w_rs, nh)
        np2 = max(1, nh // 2) if last else nh
        W1, W2 = 2 * C // nh, n_rs // np2
        assert w1.shape == (nh, 3 * C, 2, W1) and w1.dtype == torch.bfloat16
        assert w2.shape == (np2, C, 2, W2) and w2.is_contiguous()
        p = torch.arange(2 * C)
        cols = (p // 8 % 2) * C + 8 * (p // 16) + p % 8
        for w, pack, width, col_of in ((w_cat, w1, W1, cols),
                                       (w_rs, w2, W2, torch.arange(n_rs))):
            for h in range(pack.shape[0]):
                sel = w[:, col_of[h * width:(h + 1) * width]]
                hi, lo = pack[h, :, 0].float(), pack[h, :, 1].float()
                assert torch.equal(hi, sel.bfloat16().float())
                assert torch.equal(lo, (sel - hi).bfloat16().float())

    def test_plan(self):
        """Every build fits a block's shared memory, the grid covers every
        row once, the default is the 112-row build at B=1 (one wave) and
        the 64-row one at B=8 and for short inputs, and a width or block
        size without a build is refused by name."""
        for C, builds in WN_BUILDS.items():
            for bm, nh in builds.items():
                for B, Tp in ((1, 12800), (8, 12800), (2, 384), (1, 1)):
                    plan = wn_plan(B, Tp, C, bm=bm)
                    assert plan.smem <= SMEM_LIMIT and plan.stages >= 3
                    assert plan.nh == nh
                    assert plan.grid * bm >= B * Tp > (plan.grid - 1) * bm
        assert wn_plan(1, 12800, 256).bm == 112
        assert wn_plan(1, 12800, 256).grid == 115
        assert wn_plan(8, 12800, 256).bm == 64
        assert wn_plan(1, 3840, 256).bm == 64
        with pytest.raises(ValueError, match="C in"):
            wn_plan(1, 128, 96)
        with pytest.raises(ValueError, match="not built"):
            wn_plan(1, 128, 64, bm=112)
        with pytest.raises(ValueError, match="positive"):
            wn_plan(0, 128, 256)


    @pytest.mark.parametrize("C", [512, 1024])
    def test_plan_at_the_wide_builds(self, C):
        """C = 512 and 1024 fit a block's shared memory at every build;
        the default build at B=1 and B=8 of a 400-frame pass follows the
        measured row costs."""
        for bm, nh in WN_BUILDS[C].items():
            assert wn_smem_bytes(C, bm, nh, 4) <= SMEM_LIMIT
            assert wn_plan(1, 12800, C, bm=bm).stages == 4
        expect = {512: 32, 1024: 32}[C]
        for B in (1, 8):
            plan = wn_plan(B, 12800, C)
            assert plan.bm == expect and plan.nh == WN_BUILDS[C][expect]
            assert plan.grid == -(-B * 12800 // expect)


class TestWaveGlow:
    def test_upsample_matches_jax(self, wg):
        params, _, model, _ = wg
        spect = np.random.default_rng(4).standard_normal((2, 8, 5)) \
            .astype(np.float32)
        with torch.no_grad():
            ours = _upsample_mel(model, _t(spect), 8, 5 * 256)
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(jax_upsample(params, jnp.asarray(spect),
                                                  8, 5 * 256)), atol=2e-6)

    def test_infer_z_matches_jax(self, wg):
        params, cfg, model, tcfg = wg
        rng = np.random.default_rng(5)
        B, T_mel = 2, 5
        Tg = T_mel * 256 // 8
        spect = rng.standard_normal((B, 8, T_mel)).astype(np.float32)
        z_main = rng.standard_normal(
            (B, waveglow_n_remaining(tcfg), Tg)).astype(np.float32)
        z_early = [rng.standard_normal((B, 2, Tg)).astype(np.float32)
                   if f % 2 == 0 and f > 0 else None for f in range(4)]
        ref = jax_waveglow_infer_z(
            params, cfg, jnp.asarray(spect), jnp.asarray(z_main),
            [None if z is None else jnp.asarray(z) for z in z_early],
            impl="pallas_interpret")
        ours = waveglow_infer_z(model, tcfg, _t(spect), _t(z_main),
                                [None if z is None else _t(z)
                                 for z in z_early])
        assert ours.shape == (B, T_mel * 256)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)

    def test_load_folds_weight_norm(self, tmp_path):
        """load_waveglow reads a published-layout state_dict with
        weight_norm pairs and loads it strictly."""
        model, _ = waveglow_init(seed=3)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        name = "WN.0.in_layers.1.weight"
        v = sd.pop(name) * 3.0
        sd[name[:-len("weight")] + "weight_v"] = v
        sd[name[:-len("weight")] + "weight_g"] = \
            v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt() / 3.0
        torch.save({"model": sd}, tmp_path / "wg.pt")
        loaded, cfg = load_waveglow(str(tmp_path / "wg.pt"))
        assert cfg["n_channels"] == 256
        for k, ref in model.state_dict().items():
            torch.testing.assert_close(loaded.state_dict()[k], ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,B,d,last", [(64, 2, 4, False), (64, 2, 4, True),
                                        (256, 8, 8, False),
                                        (256, 2, 128, True),
                                        (512, 2, 8, False),
                                        (512, 1, 128, True),
                                        (1024, 2, 4, False),
                                        (1024, 1, 64, True)])
def test_kernel_matches_plain_on_card(cuda_device, C, B, d, last, dtype):
    """K2 against its plain version, with pad rows and a strided cond
    slice: C = 64 (the smallest width built), the flagship C = 256 at the
    server's largest batch, and its last layer (d = 128), and the wide
    builds C = 512 and 1024 (several column passes); pad rows zero, two
    calls bitwise equal. fp32 within 1e-4 of the output scale
    (``chip_smoke.py``'s bar: at C = 1024 the outputs reach ~5, and K2's
    three bf16 passes lie ~1.5e-4 from the plain layer there); the bf16
    body (every tensor bf16) within 1e-2 of the output scale."""
    g = torch.Generator().manual_seed(0)
    T, Tp = 300, 384
    x = torch.randn(B, Tp, C, generator=g)
    x[:, T:] = 0
    cond_all = torch.randn(B, Tp, 6 * C, generator=g)
    n_rs = C if last else 2 * C
    weights = [0.1 * torch.randn(3 * C, 2 * C, generator=g),
               torch.randn(2 * C, generator=g),
               0.1 * torch.randn(C, n_rs, generator=g),
               torch.randn(n_rs, generator=g)]
    x, cond_all = x.to(dtype), cond_all.to(dtype)
    weights = [w.to(dtype) for w in weights]
    ref = wn_layer_reference(x, d, cond_all[..., 2 * C:4 * C], *weights, T)
    cond_dev = cond_all.to(cuda_device)[..., 2 * C:4 * C]   # row stride 6C
    dev_args = [x.to(cuda_device), d, cond_dev,
                *[w.to(cuda_device) for w in weights], T]
    ours = wn_layer(*dev_args)
    again = wn_layer(*dev_args)
    for a, r, a2 in zip(ours, ref, again):
        if r is None:
            assert a is None and a2 is None
        else:
            assert a.dtype == dtype
            err = float((a.cpu().float() - r.float()).abs().max())
            scale = float(r.float().abs().max())
            print(f"K2 C={C} B={B} d={d} last={last} {dtype}: max abs err "
                  f"{err:.3g}, output scale {scale:.3g}")
            assert err <= (1e-4 if dtype == torch.float32 else 1e-2) * scale
            assert torch.equal(a, a2)
    if not last:
        assert bool((ours[0][:, T:] == 0).all())
    with pytest.raises(TypeError, match="float32"):
        wn_layer(*[a.double() if torch.is_tensor(a) else a
                   for a in dev_args])
