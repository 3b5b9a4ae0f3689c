"""Kernel K3 (flowtron_tpu_torch/ops/attention.py): its plain forward and
backward against the JAX package's Pallas kernel (interpret mode), its
XLA path and its custom-VJP backward, the autograd.Function around them,
and the wrapper's routing; the CUDA kernels' arithmetic (the E-product
form, the factored backward sums, the |x| <= 20 guard), emulated here in
plain PyTorch at their tiling, against the same JAX functions. Card-only
cases (``-m cuda``) hold the CUDA kernels against the plain versions."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.ops.attention_pallas import (  # noqa: E402
    _scores_bwd, attention_scores_pallas, attention_scores_xla,
)

from flowtron_tpu_torch.ops import attention as k3  # noqa: E402

TOL = 1e-5      # fp32, plain vs JAX: same math, another summation order


def _data(B, Tq, Tk, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Tq, D)).astype(np.float32)
    k = rng.standard_normal((B, Tk, D)).astype(np.float32)
    v = (0.1 * rng.standard_normal(D)).astype(np.float32)
    ds = rng.standard_normal((B, Tq, Tk)).astype(np.float32)
    return q, k, v, ds


def _t(a):
    return torch.from_numpy(np.array(a))


def _guarded_data(B, Tq, Tk, D, seed=0):
    """``_data`` with a share of Q and K values far outside |x| <= 20: a
    few query rows at +50 and key rows at -60 (so E_q * E_k would be
    inf * 0 in the fast form), and scattered values of magnitude 25."""
    q, k, v, ds = _data(B, Tq, Tk, D, seed)
    rng = np.random.default_rng(seed + 100)
    q[:, ::5, : D // 3] = 50.0
    k[:, ::3, : D // 2] = -60.0
    for a in (q, k):
        hit = rng.random(a.shape) < 0.02
        a[hit] = 25.0 * np.sign(rng.standard_normal(int(hit.sum())))
    return q, k, v, ds


SHAPES = [(2, 19, 7, 24), (1, 32, 128, 128), (3, 16, 5, 640)]


@pytest.mark.parametrize("shape", SHAPES, ids=["unaligned", "aligned",
                                               "flagship_D"])
@pytest.mark.parametrize("temperature", [1.0, 1.7])
def test_plain_forward_matches_pallas_interpret(shape, temperature):
    q, k, v, _ = _data(*shape)
    ref = attention_scores_pallas(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), temperature,
                                  interpret=True)
    ours = k3.attention_scores_reference(_t(q), _t(k), _t(v), temperature)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["unaligned", "aligned"])
def test_plain_forward_matches_xla(shape):
    q, k, v, _ = _data(*shape, seed=1)
    ref = attention_scores_xla(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 2.0)
    ours = k3.attention_scores_fwd(_t(q), _t(k), _t(v), 2.0)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=TOL)


def _rel_close(ours, ref, rtol=TOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    err = np.abs(ours - ref).max() / max(1e-30, np.abs(ref).max())
    assert err <= rtol, err


@pytest.mark.parametrize("shape", SHAPES, ids=["unaligned", "aligned",
                                               "flagship_D"])
def test_plain_backward_matches_jax_vjp_and_scores_bwd(shape):
    q, k, v, ds = _data(*shape, seed=2)
    temp = 1.3
    _, vjp = jax.vjp(lambda a, b, c: attention_scores_xla(a, b, c, temp),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_vjp = vjp(jnp.asarray(ds))
    ref_bwd = _scores_bwd(temp, (jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v)), jnp.asarray(ds))
    ours = k3.attention_scores_backward_reference(_t(q), _t(k), _t(v),
                                                  _t(ds), temp)
    for o, r1, r2 in zip(ours, ref_vjp, ref_bwd):
        _rel_close(o.numpy(), r1)
        _rel_close(o.numpy(), r2)


def test_plain_backward_chunks_over_tq():
    """A Tq longer than one chunk (the JAX chunk rule gives cq=2 here)
    gives the same gradients as the unchunked autograd of the forward."""
    q, k, v, ds = _data(2, 9, 512, 32768 // 512, seed=3)
    tq, tk, tv = (_t(a).double().requires_grad_() for a in (q, k, v))
    s = k3.attention_scores_reference(tq, tk, tv, 1.0)
    ref = torch.autograd.grad(s, (tq, tk, tv), _t(ds).double())
    ours = k3.attention_scores_backward_reference(tq.detach(), tk.detach(),
                                                  tv.detach(),
                                                  _t(ds).double())
    for o, r in zip(ours, ref):
        torch.testing.assert_close(o, r, rtol=1e-10, atol=1e-10)


def test_function_passes_gradcheck_float64():
    rng = np.random.default_rng(4)
    args = tuple(torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                              requires_grad=True)
                 for s in ((2, 5, 6), (2, 3, 6), (6,)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: k3.attention_scores(a, b, c, 1.7), args)


def test_function_routes_through_both_wrappers():
    """Forward and backward of the Function are attention_scores_fwd and
    attention_scores_bwd (on the CPU their plain versions), on
    non-contiguous inputs as the model hands them over."""
    q, k, v, ds = _data(2, 7, 5, 8, seed=5)
    tq = _t(q).transpose(0, 1).contiguous().transpose(0, 1)
    tq.requires_grad_()
    tk, tv = _t(k).requires_grad_(), _t(v).requires_grad_()
    assert not tq.is_contiguous()
    s = k3.attention_scores(tq, tk, tv, 1.2)
    s.backward(_t(ds))
    torch.testing.assert_close(
        s.detach(), k3.attention_scores_reference(_t(q), _t(k), _t(v), 1.2))
    ref = k3.attention_scores_backward_reference(_t(q), _t(k), _t(v),
                                                 _t(ds), 1.2)
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref):
        torch.testing.assert_close(got, r)


def test_bf16_plain_versions_keep_dtype_and_accumulate_in_fp32():
    q, k, v, ds = (_t(a).to(torch.bfloat16) for a in _data(2, 6, 4, 16, 6))
    s = k3.attention_scores_fwd(q, k, v)
    assert s.dtype == torch.bfloat16
    grads = k3.attention_scores_bwd(q, k, v, ds)
    ref = k3.attention_scores_backward_reference(
        q.float(), k.float(), v.float(), ds.float())
    for g, r in zip(grads, ref):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r.to(torch.bfloat16))


def test_wrappers_have_no_silent_fallback():
    """Only CPU tensors take the plain versions; any other device launches
    a kernel or raises."""
    meta = [torch.zeros(s, device="meta") for s in ((1, 2, 4), (1, 3, 4),
                                                    (4,), (1, 2, 3))]
    with pytest.raises(ValueError, match="no kernel"):
        k3.attention_scores_fwd(*meta[:3])
    with pytest.raises(ValueError, match="no kernel"):
        k3.attention_scores_bwd(*meta)


# --------------------------------------------------------------------------
# the CUDA kernels' arithmetic, emulated in plain PyTorch at their tiling
# --------------------------------------------------------------------------

FAST_MAX = 20.0     # csrc/attention.cu kFastMax
EMU_SHAPES = [(2, 19, 7, 64), (2, 37, 70, 96), (1, 21, 300, 40)]
EMU_IDS = ["one_tile", "kpt16", "two_key_tiles"]


def _fast(*xs):
    """A chunk takes the fast form when every staged value has |x| <= 20
    (false for inf and NaN, as the kernel's test)."""
    return all(bool((x.abs() <= FAST_MAX).all()) for x in xs)


def _rcp_newton(y):
    """The kernel's FMA-pipe reciprocal: an integer seed, three Newton
    steps (csrc rcp_newton)."""
    seed = torch.tensor(0x7EF311C3, dtype=torch.int32) - y.view(torch.int32)
    r = seed.view(torch.float32)
    for _ in range(3):
        r = r + r * (1 - y * r)
    return r


def _r(a, b, guard=True, newton=None):
    """r = 1 / (1 + E_a E_b) = (1 - tanh(a + b)) / 2 of every pair, a
    (n, d) and b (m, d) -> (n, m, d): the fast form (``newton``, an (n, m)
    mask, marks the pairs whose reciprocal takes Newton steps), or tanh
    where the guard takes a chunk off it."""
    if guard and not _fast(a, b):
        return 0.5 - 0.5 * torch.tanh(a[:, None] + b[None])
    y = 1.0 + torch.exp(2 * a)[:, None] * torch.exp(2 * b)[None]
    r = 1.0 / y
    if newton is not None:
        r = torch.where(newton[:, :, None], _rcp_newton(y), r)
    return r


def _emulate_forward(q, k, v, temp, guard=True, fq=16, ft=64, dc=32):
    """The forward kernel's sums: per (b, 16 queries, 64 keys) block and
    32-deep chunk, sum v * r, the reciprocal of query rows 1, 3, .. with
    key rows 32 .. 63 by Newton steps (a consumer's element (1, 1) of its
    2 x 2); then s = (sum v - 2 sum v * r) / temp."""
    newton = (torch.arange(fq)[:, None] % 2 == 1) & (torch.arange(ft) >= 32)
    B, Tq, D = q.shape
    Tk = k.shape[1]
    out = torch.empty(B, Tq, Tk)
    for b in range(B):
        for q0 in range(0, Tq, fq):
            for t0 in range(0, Tk, ft):
                qt, kt = q[b, q0:q0 + fq], k[b, t0:t0 + ft]
                acc = torch.zeros(qt.shape[0], kt.shape[0])
                vsum = torch.zeros(())
                for d0 in range(0, D, dc):
                    sl = slice(d0, d0 + dc)
                    nt = newton[:qt.shape[0], :kt.shape[0]]
                    acc += (_r(qt[:, sl], kt[:, sl], guard, nt)
                            * v[sl]).sum(-1)
                    vsum += v[sl].sum()
                out[b, q0:q0 + fq, t0:t0 + ft] = (vsum - 2 * acc) / temp
    return out


def _bwd_kpt(Tk):
    """Keys a warp of the backward's key tile (8 warps): csrc bwd_kpt."""
    per_warp = -(-Tk // 8)
    return next((n for n in (8, 16, 24) if per_warp <= n), 32)


def _emulate_backward(q, k, v, ds, temp, guard=True, bq=32, bd=32):
    """The fused backward's factored sums: per (b, 32-column slice), key
    tile of 8 * KPT keys and chunk of 32 query rows, r once an element;
    p = ds r (1 - r) summed over keys into dQ and over queries into dK
    (both times 4 v / temp, since 1 - th^2 = 4 r (1 - r)); dv from one
    partial a (b, slice), sum ds - 2 sum ds * r, summed over b."""
    B, Tq, D = q.shape
    Tk = k.shape[1]
    tile = 8 * _bwd_kpt(Tk)
    dq, dk = torch.zeros_like(q), torch.zeros_like(k)
    dv_part = torch.zeros(B, D)
    for b in range(B):
        for d0 in range(0, D, bd):
            sl = slice(d0, d0 + bd)
            gsum, dva = torch.zeros(()), torch.zeros(dv_part[b, sl].shape)
            for k0 in range(0, Tk, tile):
                kc = k[b, k0:k0 + tile, sl]
                for q0 in range(0, Tq, bq):
                    qc = q[b, q0:q0 + bq, sl]
                    g = ds[b, q0:q0 + bq, k0:k0 + tile, None]
                    if guard and not _fast(kc, qc):
                        r = 0.5 - 0.5 * torch.tanh(qc[:, None] + kc[None])
                    else:
                        r = _r(qc, kc, guard=False)
                    gr = g * r
                    p = gr - gr * r
                    dq[b, q0:q0 + bq, sl] += p.sum(1)
                    dk[b, k0:k0 + tile, sl] += p.sum(0)
                    dva += gr.sum((0, 1))
                    gsum += g.sum()
            dv_part[b, sl] = gsum - 2 * dva
    scale = 4 * v / temp
    return dq * scale, dk * scale, dv_part.sum(0) / temp


@pytest.mark.parametrize("shape", EMU_SHAPES, ids=EMU_IDS)
@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_kernel_forward_arithmetic_matches_pallas_interpret(shape, guarded):
    """E-product form, sum v - 2 sum v r and the |x| <= 20 guard, held to
    JAX's Pallas kernel within 1e-5 of the output scale; with values
    beyond 20 the guarded chunks run (and without the guard, inf * 0
    turns outputs into NaN)."""
    q, k, v, _ = (_guarded_data if guarded else _data)(*shape, seed=9)
    ref = np.asarray(attention_scores_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.3,
        interpret=True))
    ours = _emulate_forward(_t(q), _t(k), _t(v), 1.3).numpy()
    _rel_close(ours, ref, TOL)
    if guarded:
        unguarded = _emulate_forward(_t(q), _t(k), _t(v), 1.3, guard=False)
        assert not torch.isfinite(unguarded).all()


@pytest.mark.parametrize("shape", EMU_SHAPES, ids=EMU_IDS)
@pytest.mark.parametrize("guarded", [False, True], ids=["plain", "guarded"])
def test_kernel_backward_arithmetic_matches_scores_bwd(shape, guarded):
    """The fused backward's factored sums (r once an element for dQ, dK
    and dv), held to JAX's ``_scores_bwd`` within 1e-4 of each gradient's
    largest value, with and without guarded chunks."""
    q, k, v, ds = (_guarded_data if guarded else _data)(*shape, seed=10)
    ref = _scores_bwd(1.3, (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)),
                      jnp.asarray(ds))
    ours = _emulate_backward(_t(q), _t(k), _t(v), _t(ds), 1.3)
    for o, r in zip(ours, ref):
        _rel_close(o.numpy(), r, 1e-4)
    if guarded:
        unguarded = _emulate_backward(_t(q), _t(k), _t(v), _t(ds), 1.3,
                                      guard=False)
        assert not all(torch.isfinite(g).all() for g in unguarded)


def test_fma_pipe_reciprocal_is_exact_to_rounding():
    """The forward's Newton reciprocal over the fast form's whole range,
    1 <= y <= e^80: within 3 fp32 ulps of 1 / y."""
    rng = np.random.default_rng(11)
    y = torch.from_numpy(np.exp(rng.uniform(0, 80, 100000))
                         .astype(np.float32))
    y = torch.cat([y, torch.tensor([1.0, 2.0, 3.0, float(np.exp(80.0))])])
    rel = (_rcp_newton(y).double() * y.double() - 1).abs().max()
    assert rel <= 3 * 2.0 ** -24, float(rel)


def test_guard_threshold_keeps_the_fast_form_finite():
    """At the threshold the fast form is finite and exact: every staged
    value at +-20 puts E_a * E_b in [e^-80, e^80], normal floats."""
    x = torch.tensor([[-20.0, 20.0, -20.0, 20.0, 0.0]])
    y = torch.tensor([[-20.0, 20.0, 20.0, -20.0, 20.0]])
    assert _fast(x, y) and not _fast(x, y + 1e-3)
    prod = torch.exp(2 * x) * torch.exp(2 * y)
    assert bool((prod >= torch.finfo(torch.float32).tiny).all())
    assert bool(torch.isfinite(prod).all())
    th = 1 - 2 * _r(x.T[:, :1], y.T[:, :1])[range(5), range(5), 0]
    torch.testing.assert_close(th, torch.tanh(x + y)[0], rtol=0,
                               atol=2e-7)


def test_chip_smoke_k3_bound_shares_the_reciprocals_between_pipes():
    """chip_smoke.py's K3 bound: each element's reciprocal may run on the
    special-function pipe (one op) or on the FMA pipe (a Newton reciprocal,
    6 instructions); the pipes run at once, so the least time shares the
    reciprocals out until both finish together. FMA-pipe work is counted
    in instructions at 128 lanes a clock. At the training batch that is
    6/14 of them on the FMA pipe forward (2 instructions an element) and
    2/14 backward (6)."""
    import chip_smoke
    e = 6 * 320 * 64 * 640
    sfu, fma = chip_smoke.SFU_OPS_S, chip_smoke.FMA_INSTR_S
    assert fma == pytest.approx(chip_smoke.PEAK_OPS_S["fp32"] / 2, rel=2e-3)
    for per_elem, share, ms in ((2, 6 / 14, 0.01075), (6, 2 / 14, 0.01612)):
        t, by = chip_smoke.k3_bound(0, per_elem * e, e)
        assert by == "operations"
        assert t == pytest.approx((1 - share) * e / sfu * 1e3)
        assert t == pytest.approx((per_elem + 6 * share) * e / fma * 1e3)
        assert t == pytest.approx(ms, abs=1e-5)
    # 8 or more instructions an element: every reciprocal on the
    # special-function pipe, the FMA pipe sets the time
    assert chip_smoke.k3_bound(0, 10 * e, e)[0] == pytest.approx(
        10 * e / fma * 1e3)
    # no FMA work: the Newton share alone balances the pipes
    assert chip_smoke.k3_bound(0, 0, e)[0] == pytest.approx(
        e / (sfu + fma / 6) * 1e3)
    assert chip_smoke.k3_bound(chip_smoke.HBM_BYTES_S, 1, 1) == (1e3,
                                                                 "bytes")


def test_chip_smoke_guarded_share_counts_the_kernels_tiles():
    """The guarded share chip_smoke.py prints: the forward's (16 query,
    64 key, 32-deep) tiles that stage a value beyond |x| <= 20."""
    import chip_smoke
    q, k = torch.zeros(2, 40, 70), torch.zeros(2, 100, 70)
    assert chip_smoke.k3_guarded_share(q, k) == 0.0
    q[1, 35, 69] = -21.0          # batch 1, query tile 2, chunk 2
    n_tiles = 2 * 3 * 2 * 3       # batch x query tiles x key tiles x chunks
    assert chip_smoke.k3_guarded_share(q, k) == pytest.approx(2 / n_tiles)
    k[0, 99, 0] = float("nan")    # batch 0, key tile 1, chunk 0: 3 tiles
    assert chip_smoke.k3_guarded_share(q, k) == pytest.approx(5 / n_tiles)


# --------------------------------------------------------------------------
# card-only cases
# --------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_kernels_match_plain_on_card(cuda_device, dtype, tol):
    """Forward and backward kernels against the plain versions on the same
    inputs accumulated in fp32, relative to each output's scale: the
    backward's key tiles of 8, 16 and 32 keys a warp (Tk = 64, 100, 300;
    300 in two tiles) and values beyond the fast form's |x| <= 20."""
    for shape, make in (((6, 320, 64, 640), _data), ((3, 19, 7, 640), _data),
                        ((2, 33, 45, 100), _data),
                        ((2, 33, 100, 96), _data),
                        ((2, 40, 300, 96), _data),
                        ((6, 320, 64, 640), _guarded_data)):
        q, k, v, ds = (_t(a).to(cuda_device, dtype)
                       for a in make(*shape, seed=7))
        f32 = [x.float() for x in (q, k, v, ds)]
        s = k3.attention_scores_fwd(q, k, v, 1.3)
        ref = k3.attention_scores_reference(*f32[:3], 1.3)
        assert (s.float() - ref).abs().max() <= tol * ref.abs().max()
        grads = k3.attention_scores_bwd(q, k, v, ds, 1.3)
        refs = k3.attention_scores_backward_reference(*f32, 1.3)
        for g, r in zip(grads, refs):
            assert g.dtype == dtype
            assert (g.float() - r).abs().max() <= tol * r.abs().max()


@pytest.mark.cuda
def test_backward_kernel_is_deterministic(cuda_device):
    for make, shape in ((_data, (6, 320, 64, 640)),
                        (_guarded_data, (6, 320, 64, 640)),
                        (_data, (2, 40, 300, 96))):
        q, k, v, ds = (_t(a).to(cuda_device) for a in make(*shape, seed=8))
        first = k3.attention_scores_bwd(q, k, v, ds)
        for _ in range(3):
            again = k3.attention_scores_bwd(q, k, v, ds)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_kernel_refuses_unsupported_dtype(cuda_device):
    q, k, v, ds = (_t(a).to(cuda_device, torch.float16)
                   for a in _data(1, 4, 3, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3.attention_scores_fwd(q, k, v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3.attention_scores_bwd(q, k, v, ds)
