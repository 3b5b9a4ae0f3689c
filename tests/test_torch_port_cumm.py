"""Cumulative attention in the port (``use_cumm_attention``: the
conditioning layer of models/attention.py, the per-frame training pass
and the seven-entry loop carry of models/ar_step.py) against the JAX
package at toy widths, the zero-init coupling heads perturbed, inputs
drawn with numpy:

- training: every forward output and the losses within 1e-5, the
  gradients within 1e-4 of each tensor's largest;
- inference: mel within 1e-4 with n_valid identical, gated and not;
- the chunked loop: mel and all seven carry entries within 1e-4 of
  JAX's chunk by chunk;
- (test_torch_port_cumm_stream.py: streaming and the multistream mux);
- routing: a cumulative-attention flow never reaches kernel K1's
  wrapper (so neither its plain version nor the kernel).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.models import flowtron_forward as jax_forward  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.models.ar_step import (  # noqa: E402
    ar_step_infer as jax_ar_step_infer,
)
from flowtron_tpu.models.flowtron import (  # noqa: E402
    flowtron_infer as jax_flowtron_infer,
)
from flowtron_tpu.train.loss import flowtron_loss as jax_loss  # noqa: E402

from flowtron_tpu_torch.models import ar_step as port_ar_step  # noqa: E402
from flowtron_tpu_torch.models.ar_step import (  # noqa: E402
    ar_step_infer, in_k1_subset,
)
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_forward, flowtron_infer, flowtron_init,
)
from flowtron_tpu_torch.train.loss import flowtron_loss  # noqa: E402
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)
from tests.test_torch_port_streaming import (  # noqa: E402
    SMALL, _gate_threshold, _inputs, _pair as _plain_pair,
)
from tests.test_torch_port_train import (  # noqa: E402
    DIMS, LOSS_KW, _rel, _t, make_batch,
)

ARGS = ("mel", "speaker_ids", "text", "in_lens", "out_lens")


def _pair(n_flows, seed, dims=SMALL):
    """A JAX Flowtron with cumulative attention and perturbed heads, and
    the port's copy of it."""
    params, cfg = jax_init(jax.random.PRNGKey(seed), n_flows=n_flows,
                           use_gate_layer=True, use_cumm_attention=True,
                           **dims)
    rng = np.random.default_rng(seed)
    for f in params["flows"]:
        for k in ("w", "b"):
            f["conv"][k] = jnp.asarray(0.05 * rng.standard_normal(
                f["conv"][k].shape).astype(np.float32))
    model, tcfg = flowtron_init(0, n_flows=n_flows, use_gate_layer=True,
                                use_cumm_attention=True, **dims)
    model.load_state_dict(flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return (params, cfg), (model, tcfg)


@pytest.fixture(scope="module")
def one_flow():
    return _pair(1, 3)


@pytest.fixture(scope="module")
def two_flows():
    return _pair(2, 4)


# -- training ----------------------------------------------------------------
@pytest.fixture(scope="module")
def trained():
    """One batch through both packages' training forward, losses and
    gradients (JAX's in one jitted call). The prior is passed and, as in
    the JAX package, not applied by a cumulative-attention flow."""
    (params, cfg), (model, tcfg) = _pair(2, 6, DIMS)
    batch = make_batch(seed=8)

    def jax_total(p):
        out = jax_forward(p, cfg, *(jnp.asarray(batch[k]) for k in ARGS),
                          attn_prior=jnp.asarray(batch["attn_prior"]))
        losses = jax_loss(out, jnp.asarray(batch["gate_target"]),
                          jnp.asarray(batch["in_lens"]),
                          jnp.asarray(batch["out_lens"]), **LOSS_KW)
        return sum(losses), (out, losses)

    (_, (jout, jlosses)), grads = jax.jit(
        jax.value_and_grad(jax_total, has_aux=True))(params)
    out = flowtron_forward(model, tcfg, *(_t(batch[k]) for k in ARGS),
                           attn_prior=_t(batch["attn_prior"]))
    losses = flowtron_loss(out, _t(batch["gate_target"]),
                           _t(batch["in_lens"]), _t(batch["out_lens"]),
                           **LOSS_KW)
    sum(losses).backward()
    return dict(model=model, out=out, jout=jout, losses=losses,
                jlosses=jlosses, grads=flowtron_state_dict_from_jax(
                    jax.tree.map(np.asarray, grads)))


def test_cumm_training_forward_matches_jax(trained):
    """z, each flow's log_s, attn and attn_logprob, and the gate."""
    out, jout = trained["out"], trained["jout"]
    for o, r in ((out[0], jout[0]), (out[2], jout[2]),
                 *zip(out[1], jout[1]), *zip(out[3], jout[3]),
                 *zip(out[4], jout[4])):
        assert tuple(o.shape) == np.asarray(r).shape
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=1e-5, rtol=1e-6)


def test_cumm_training_losses_match_jax(trained):
    for name, o, r in zip(("nll", "gate", "ctc"), trained["losses"],
                          trained["jlosses"]):
        assert _rel(o, r) <= 1e-5, (name, float(o), float(r))


def test_cumm_training_gradients_match_jax(trained):
    """Within 1e-4 of each tensor's largest (scale floored at 1e-3). Each
    conditioning conv is one parameter, though its state_dict holds it
    under the reference's two names."""
    model, grads = trained["model"], trained["grads"]
    names = [n for n, _ in model.named_parameters()]
    assert "flows.0.attn_cond_layer.location_conv_hidden.conv.weight" \
        in names
    for name, p in model.named_parameters():
        ref = grads[name].numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)


# -- inference ---------------------------------------------------------------
@pytest.mark.parametrize("gated", [False, True])
def test_cumm_inference_matches_jax(two_flows, gated):
    (params, cfg), (model, tcfg) = two_flows
    residual, sids, text = _inputs(2, 28, 13, Tk=6)
    thresh = _gate_threshold(model, tcfg, residual, sids, text, 6) \
        if gated else 1e6
    jmel, jattn, jnv = jax.jit(
        lambda p, r, s, t: jax_flowtron_infer(p, cfg, r, s, t,
                                              gate_threshold=thresh))(
        params, jnp.asarray(residual), jnp.asarray(sids), jnp.asarray(text))
    mel, attns, nv = flowtron_infer(model, tcfg, _t(residual), _t(sids),
                                    _t(text), gate_threshold=thresh)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    if gated:
        assert int(nv.min()) < 28
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), atol=1e-4)
    for a, r in zip(attns, jattn):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4)


@pytest.mark.parametrize("cumm", [True, False])
def test_cumm_chunked_carry_matches_jax(one_flow, cumm):
    """Three chunks with the carry on both sides: each chunk's mel and
    gates and every entry of the seven-entry carry, the attention ones
    (B, Tk), within 1e-4. A flow without cumulative attention carries
    the same seven entries as JAX's (the port's carry had five)."""
    (params, _), (model, _) = one_flow if cumm else _plain_pair(1, 0)
    rng = np.random.default_rng(9)
    z = (rng.standard_normal((20, 2, 8)) * 0.5).astype(np.float32)
    enc = (rng.standard_normal((5, 2, 16)) * 0.3).astype(np.float32)
    key_mask = np.arange(5)[None] < np.asarray([5, 3])[:, None]
    jstep = jax.jit(lambda zc, c: jax_ar_step_infer(
        params["flows"][0], zc, jnp.asarray(enc), jnp.asarray(key_mask),
        carry=c, return_carry=True))
    jcarry = pcarry = None
    for a, b in ((0, 6), (6, 13), (13, 20)):
        jm, _, jg, jcarry = jstep(jnp.asarray(z[a:b]), jcarry)
        with torch.no_grad():
            pm, _, pg, pcarry = ar_step_infer(
                model.flows[0], _t(z[a:b]), _t(enc), _t(key_mask),
                carry=pcarry, return_carry=True)
        np.testing.assert_allclose(pm.numpy(), np.asarray(jm), atol=1e-4)
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=1e-4)
    assert len(pcarry) == len(jcarry) == 7
    assert tuple(pcarry[5].shape) == tuple(pcarry[6].shape) == (2, 5)
    for p, j in zip(jax.tree.leaves(pcarry), jax.tree.leaves(jcarry)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-4)


def test_cumm_flow_never_reaches_k1(two_flows, monkeypatch):
    """K1 has no conditioning layer: every route, fused="early" included,
    runs the loop, and the subset predicate says so."""
    _, (model, tcfg) = two_flows

    def k1(*a, **k):
        raise AssertionError("fused_flow_infer called")
    monkeypatch.setattr(port_ar_step, "fused_flow_infer", k1)
    assert not in_k1_subset(model.flows[0], None, 1.0)
    assert not in_k1_subset(model.flows[1].ar_step, None, 1.0)
    residual, sids, text = _inputs(1, 10, 2, Tk=4)
    for fused in (True, "early"):
        mel, _, nv = flowtron_infer(model, tcfg, _t(residual), _t(sids),
                                    _t(text), fused=fused)
        assert mel.shape == (1, 8, 10) and bool(torch.isfinite(mel).all())


def test_cumm_bf16_policy_keeps_the_fp32_parameters():
    """The bf16 policy runs on cast copies (``functional_call``): after a
    bf16 step every parameter, the conditioning convs included, is still
    the fp32 master, so the fp32 validation after it runs."""
    _, (model, tcfg) = _pair(2, 6, DIMS)
    batch = {k: _t(v) for k, v in make_batch(seed=10).items()}
    args = [batch[k] for k in ARGS]
    out = flowtron_forward(model, tcfg, *args, compute_dtype=torch.bfloat16,
                           remat=True)
    assert out[0].dtype == torch.bfloat16
    sum(flowtron_loss(out, batch["gate_target"], batch["in_lens"],
                      batch["out_lens"], **LOSS_KW)).backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    with torch.no_grad():
        z = flowtron_forward(model, tcfg, *args)[0]
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
