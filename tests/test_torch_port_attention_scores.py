"""Kernel K3 (flowtron_tpu_torch/ops/attention.py): its plain forward and
backward against the JAX package's Pallas kernel (interpret mode), its
XLA path and its custom-VJP backward, the autograd.Function around them,
and the wrapper's routing. Card-only cases (``-m cuda``) hold the CUDA
kernels against the plain versions."""

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
    inputs accumulated in fp32, relative to each output's scale."""
    for shape in ((6, 320, 64, 640), (3, 19, 7, 640), (2, 33, 45, 100)):
        q, k, v, ds = (_t(a).to(cuda_device, dtype)
                       for a in _data(*shape, seed=7))
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
    q, k, v, ds = (_t(a).to(cuda_device) for a in _data(6, 320, 64, 640, 8))
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
