"""Kernel K2 (flowtron_tpu_torch/ops/wavenet.py) and the port's WaveGlow
against the JAX package: the WN layer's plain version against the Pallas
kernel in interpret mode, an emulation of the CUDA kernel's split-bf16
arithmetic (and of the bf16 body's, tanh.approx's error included) against
the same at flagship width, the kernels' plans and weight packs (the bf16
body's read through its TMA boxes and wgmma descriptors), and the whole
inverse pass with the same numpy latents. The zero-init end convs are
perturbed."""

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
    SMEM_LIMIT, WN_BF16_BUILDS, WN_BF16_KS, WN_BUILDS, wn_bf16_plan,
    wn_bf16_smem_bytes, wn_cond_stride, wn_layer, wn_layer_reference,
    wn_pack_weights, wn_plan, wn_smem_bytes, wn_split_weights,
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


# tanh.approx.f32's largest relative error (PTX ISA: about 2^-11)
TANH_APPROX_REL = 2.0 ** -10.987


def _emulate_wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T, nh, bf16=False,
                      tanh_err=None):
    """The kernel's arithmetic on the host, through the packs it reads
    (``wn_split_weights``): acts in nh passes of paired columns, the gate
    in fp32, z split again before the res/skip product. ``bf16``: the bf16
    body (its inputs bf16 values): the transposed packs of
    ``wn_pack_weights`` cut into nh passes of 2C / nh packed rows, exact
    bf16 products summed in fp32, the gate as tanh(a) (0.5 tanh(b / 2) +
    0.5), z rounded to bf16, the outputs rounded to bf16. ``tanh_err``: a
    (rng) whose draws put each tanh off by +-TANH_APPROX_REL relative, as
    tanh.approx may."""
    B, Tp, C = x.shape
    M = B * Tp
    if bf16:
        w1t, w2t = (w.float().numpy() for w in wn_pack_weights(
            torch.from_numpy(w_cat), torch.from_numpy(w_rs)))
        n1 = 2 * C // nh
        w1 = w1t.reshape(nh, n1, 3 * C).transpose(0, 2, 1)
        n_rs = w_rs.shape[1]
        w2 = np.stack([w2t[p * n1:(p + 1) * n1].T
                       for p in range(-(-n_rs // n1))])

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
    if bf16:
        def tanh(a):
            t = np.tanh(a)
            if tanh_err is None:
                return t
            return t * (1 + TANH_APPROX_REL
                        * tanh_err.choice([-1.0, 1.0], size=a.shape))
        z = tanh(acts[:, :C]) * (0.5 * tanh(0.5 * acts[:, C:]) + 0.5)
    else:
        z = np.tanh(acts[:, :C]) / (1 + np.exp(-acts[:, C:]))
    out = _bf16_round if bf16 else (lambda v: v)
    if bf16:
        z = _bf16_round(z)
    rs = np.concatenate([product(z, w2[h]) for h in range(w2.shape[0])],
                        axis=1)[:, :w_rs.shape[1]] + b_rs
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
        """The bf16 body's arithmetic at flagship width (C = 256), for the
        column passes of each build of csrc/wavenet_bf16.cuh, against the
        Pallas kernel in interpret mode on bf16 inputs: within 1e-2 of the
        output scale (each output is one bf16 rounding on both sides,
        which the fp32 sums' order and z's rounding move by a step), with
        exact tanh and with every tanh of the gate off by tanh.approx's
        largest relative error, 2^-10.987, in a random direction."""
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
        passes = sorted({2 * C // n1 for n1, _ in WN_BF16_BUILDS[C].values()})
        for nh in passes:
            for tanh_err in (None, np.random.default_rng(12)):
                ours = _emulate_wn_layer(x, d, cond, w_cat, b, w_rs, b_rs, T,
                                         nh, bf16=True, tanh_err=tanh_err)
                for o, r in zip(ours, ref):
                    if o is None:
                        continue
                    r = np.asarray(jnp.asarray(r, jnp.float32)) \
                        .reshape(o.shape)
                    err, scale = np.abs(o - r).max(), np.abs(r).max()
                    print(f"K2 bf16 emulation nh={nh} last={last} "
                          f"tanh_err={tanh_err is not None}: max |err| "
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


def _tile_rows(plan, B, Tp, grid):
    """csrc/wavenet_bf16.cuh's tiles as ``grid`` blocks walk them: block i
    takes tiles i, i + grid, ...; tile n is rows t0 .. t0 + bm - 1 (those
    below Tp) of stream n // per_stream, t0 = (n % per_stream) bm.
    Returns {(stream, row): times covered}."""
    per_stream = -(-Tp // plan.bm)
    seen = {}
    for blk in range(grid):
        for n in range(blk, plan.tiles, grid):
            bi, t0 = divmod(n, per_stream)
            t0 *= plan.bm
            for t in range(t0, min(t0 + plan.bm, Tp)):
                seen[bi, t] = seen.get((bi, t), 0) + 1
    return seen


def _box(src, r0, c0, rows):
    """A TMA box of ``rows`` x 64 elements of the 2-D array ``src`` at (r0,
    c0), zeros outside it, laid out as the 128-byte swizzle lays it in
    shared memory: 16-byte chunk j (8 bf16) of box row r lands at chunk
    j ^ (r % 8) of that 128-byte row."""
    pad = np.zeros((rows, 64), src.dtype)
    lo = max(r0, 0)
    r_hi, c_hi = min(r0 + rows, src.shape[0]), min(c0 + 64, src.shape[1])
    if r_hi > lo and c_hi > c0:
        pad[lo - r0:r_hi - r0, :c_hi - c0] = src[lo:r_hi, c0:c_hi]
    img = np.zeros_like(pad)
    r = np.arange(rows)[:, None]
    for j in range(8):
        img[r, 8 * (j ^ (r % 8)) + np.arange(8)] = pad[:, 8 * j:8 * j + 8]
    return img


def _descriptor_read(img, ks):
    """What wgmma reads through a K-major, 128-byte-swizzled descriptor
    started 32 ks bytes into the box (k-step ks of four): element (row,
    k) for k in 0..15 from logical chunk 2 ks + k // 8 of the row."""
    r = np.arange(img.shape[0])[:, None]
    k = np.arange(16)[None, :]
    return img[r, 8 * ((2 * ks + k // 8) ^ (r % 8)) + k % 8]


class TestBf16Body:
    """csrc/wavenet_bf16.cuh's plan, packs and tensor-map coordinates,
    emulated on the CPU."""

    def test_plan(self):
        """Every build fits a block's shared memory (232,448 bytes), its
        tiles cover every stream's Tp rows once without crossing streams
        however many blocks walk them, and at the vocoder's shapes (B=1
        and 8 at 400 frames, 12800 rows; the stream window, 2560, and a
        mux group of 7) the default build is the one whose busiest SM
        finishes first and the grid one block a tile up to the card's 132
        SMs."""
        for C, builds in WN_BF16_BUILDS.items():
            for bm, (n1, stages) in builds.items():
                plan = wn_bf16_plan(1, 12800, C, bm=bm)
                assert plan.smem == wn_bf16_smem_bytes(C, bm, n1, stages)
                assert plan.smem <= SMEM_LIMIT and plan.stages >= 3
                assert plan.nh * plan.n1 == 2 * C and bm % 64 == 0
                for B, Tp in ((2, 384), (3, 200), (1, 1), (2, 130)):
                    p = wn_bf16_plan(B, Tp, C, bm=bm)
                    # the plan's grid, and fewer blocks than tiles
                    for grid in (p.grid, max(1, p.tiles // 3)):
                        seen = _tile_rows(p, B, Tp, grid)
                        assert set(seen.values()) == {1}
                        assert set(seen) == {(bi, t) for bi in range(B)
                                             for t in range(Tp)}
        # the default build: the busiest SM's tiles at their measured cost
        want = {(1, 12800): (128, 100, 100), (8, 12800): (128, 800, 132),
                (1, 2560): (64, 40, 40), (7, 2560): (64, 280, 132)}
        for (B, Tp), (bm, tiles, grid) in want.items():
            plan = wn_bf16_plan(B, Tp, 256)
            assert (plan.bm, plan.tiles, plan.grid) == (bm, tiles, grid)
        with pytest.raises(ValueError, match="C in"):
            wn_bf16_plan(1, 128, 96)
        with pytest.raises(ValueError, match="not built"):
            wn_bf16_plan(1, 128, 256, bm=112)
        with pytest.raises(ValueError, match="positive"):
            wn_bf16_plan(1, 0, 256)

    @pytest.mark.parametrize("C", [64, 256])
    @pytest.mark.parametrize("last", [False, True])
    def test_packs_read_at_the_kernel_tile(self, C, last):
        """Every W_cat and W_rs element is where the kernel reads it: pass
        h's k stage kc loads the (N1, 64) box of ``wn_pack_weights``' w1
        at (row h N1, column 64 kc), and k-step ks's descriptor reads
        packed column n, k row 64 kc + 16 ks + k as w_cat[that row,
        s C + 8 q + e] (n = 16 q + 8 s + e: tanh then sigmoid of 8
        channels); rs pass p's stage kc reads w_rs[64 kc + 16 ks + k, p N1
        + n], zeros past its columns."""
        rng = np.random.default_rng(C)
        n_rs = C if last else 2 * C
        w_cat = rng.standard_normal((3 * C, 2 * C)).astype(np.float32)
        w_rs = rng.standard_normal((C, n_rs)).astype(np.float32)
        w1, w2 = (w.float().numpy() for w in wn_pack_weights(
            torch.from_numpy(w_cat), torch.from_numpy(w_rs)))
        assert w1.shape == (2 * C, 3 * C) and w2.shape == (n_rs, C)
        ref_cat, ref_rs = _bf16_round(w_cat), _bf16_round(w_rs)
        n1, = {n1 for n1, _ in WN_BF16_BUILDS[C].values()}
        n = np.arange(n1)
        for h in range(2 * C // n1):
            p = h * n1 + n                  # packed columns of the pass
            col = (p // 8 % 2) * C + 8 * (p // 16) + p % 8
            for kc in range(3 * C // WN_BF16_KS):
                img = _box(w1, h * n1, WN_BF16_KS * kc, n1)
                for ks in range(4):
                    k = WN_BF16_KS * kc + 16 * ks + np.arange(16)
                    got = _descriptor_read(img, ks)
                    assert np.array_equal(got, ref_cat[k][:, col].T)
        for pz in range(-(-n_rs // n1)):
            cols = pz * n1 + n
            for kc in range(C // WN_BF16_KS):
                img = _box(w2, pz * n1, WN_BF16_KS * kc, n1)
                for ks in range(4):
                    k = WN_BF16_KS * kc + 16 * ks + np.arange(16)
                    want = np.where(cols[:, None] < n_rs,
                                    ref_rs[k][:, np.minimum(cols, n_rs - 1)].T,
                                    0)
                    assert np.array_equal(_descriptor_read(img, ks), want)

    @pytest.mark.parametrize("d", [1, 128])
    def test_taps_read_at_the_kernel_tile(self, d):
        """x by TMA with the shift in the tensor map: the k stage kc of a
        tile at time t0 is the box of x (time extent T, not Tp) at
        (t0 + (tap - 1) d, channel 64 kc - tap C), tap = 64 kc // C, and
        warpgroup g's descriptor reads row r, k row 16 ks + k of it as the
        layer's tap: x[t0 + r + (tap - 1) d, channel] inside [0, T), zero
        outside (d = 128 at T = 300: whole taps fall outside)."""
        rng = np.random.default_rng(d)
        C, T, Tp = 256, 300, 384
        x = rng.standard_normal((Tp, C)).astype(np.float32)
        valid = x[:T]                       # the map's time extent is T
        for bm in WN_BF16_BUILDS[C]:
            for t0 in range(0, Tp, bm):
                for kc in range(3 * C // WN_BF16_KS):
                    k0 = WN_BF16_KS * kc
                    tap, ch0 = divmod(k0, C)
                    img = _box(valid, t0 + (tap - 1) * d, ch0, bm)
                    for ks in range(4):
                        got = _descriptor_read(img, ks)
                        t = t0 + np.arange(bm)[:, None] + (tap - 1) * d
                        ch = ch0 + 16 * ks + np.arange(16)[None, :]
                        ok = (t >= 0) & (t < T)
                        want = np.where(ok, x[np.clip(t, 0, Tp - 1), ch], 0)
                        assert np.array_equal(got, want)

    def test_cond_stride(self):
        """The bf16 body reads cond by TMA, whose strides are multiples of
        16 bytes: a slice with a row stride of 4 (mod 8) bf16 elements is
        refused by name, the fp32 body takes it, and the vocoder's 2CL
        and the card test's 6C strides pass."""
        B, Tp, C = 2, 16, 64
        for ldc, ok16 in ((6 * C, True), (2 * C * 8, True),
                          (2 * C + 4, False)):
            cond = torch.zeros(B, Tp, ldc)[..., :2 * C]
            assert wn_cond_stride(cond, bf16=False) == ldc
            if ok16:
                assert wn_cond_stride(cond, bf16=True) == ldc
            else:
                with pytest.raises(ValueError, match="bf16 body"):
                    wn_cond_stride(cond, bf16=True)
        with pytest.raises(ValueError, match="multiple of 4"):
            wn_cond_stride(torch.zeros(B, Tp, 2 * C + 2)[..., :2 * C],
                           bf16=False)


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


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Tp,d,last", [(1, 2560, 2560, 8, False),
                                           (7, 2560, 2560, 8, False),
                                           (2, 300, 384, 128, False),
                                           (2, 300, 384, 128, True)])
def test_bf16_kernel_at_the_vocoder_shapes_on_card(cuda_device, B, T, Tp, d,
                                                   last):
    """The bf16 body at C = 256 against its plain version at the stream
    window (B=1, 80 frames: 2560 rows), a mux group of 7 windows, and d =
    128 at T = 300, where whole taps of a tile fall outside [0, T):
    within 1e-2 of the output scale, pad rows zero, two calls bitwise
    equal, every build bitwise alike."""
    g = torch.Generator().manual_seed(B + d)
    C = 256
    n_rs = C if last else 2 * C
    x = torch.randn(B, Tp, C, generator=g)
    x[:, T:] = 0
    cond_all = torch.randn(B, Tp, 16 * C, generator=g)
    weights = [torch.randn(3 * C, 2 * C, generator=g) / (3 * C) ** 0.5,
               0.1 * torch.randn(2 * C, generator=g),
               torch.randn(C, n_rs, generator=g) / C ** 0.5,
               0.1 * torch.randn(n_rs, generator=g)]
    x, cond_all = x.bfloat16(), cond_all.bfloat16()
    weights = [w.bfloat16() for w in weights]
    ref = wn_layer_reference(x, d, cond_all[..., 6 * C:8 * C], *weights, T)
    dev_args = [x.to(cuda_device), d,
                cond_all.to(cuda_device)[..., 6 * C:8 * C],
                *[w.to(cuda_device) for w in weights], T]
    ours = wn_layer(*dev_args)
    again = wn_layer(*dev_args)
    for a, r, a2 in zip(ours, ref, again):
        if r is None:
            assert a is None and a2 is None
            continue
        err = float((a.cpu().float() - r.float()).abs().max())
        scale = float(r.float().abs().max())
        print(f"K2 bf16 B={B} T={T} Tp={Tp} d={d} last={last}: max abs err "
              f"{err:.3g}, output scale {scale:.3g}")
        assert err <= 1e-2 * scale
        assert torch.equal(a, a2)
    if not last and Tp > T:
        assert bool((ours[0][:, T:] == 0).all())
    for bm in WN_BF16_BUILDS[C]:
        other = wn_layer(*dev_args, bm=bm)
        assert all(a is None or torch.equal(a, o)
                   for a, o in zip(ours, other))
