"""The port's training forward against the JAX package at toy widths: the
teacher-forced attention, the masked LSTMs (fused and loop versions),
encoder dropout, flowtron_forward, the losses, the gradients of the total
loss, the bf16 policy and the invertibility oracle. Same weights through
flowtron_state_dict_from_jax, the zero-init coupling heads perturbed,
inputs drawn with numpy."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.models import flowtron_forward as jax_forward  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.models.attention import (  # noqa: E402
    attention_forward as jax_attention_forward,
)
from flowtron_tpu.ops.lstm import lstm_forward as jax_lstm_forward  # noqa: E402
from flowtron_tpu.train.loss import (  # noqa: E402
    attention_ctc_loss as jax_ctc, flowtron_loss as jax_loss,
)

from flowtron_tpu_torch.models.attention import attention_forward  # noqa: E402
from flowtron_tpu_torch.models.encoder import Encoder, _conv_stack  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_forward, flowtron_init, flowtron_test_invertibility,
)
from flowtron_tpu_torch.ops.lstm import (  # noqa: E402
    LSTM, bilstm_forward, lstm_forward, lstm_fused,
)
from flowtron_tpu_torch.train.loss import (  # noqa: E402
    attention_ctc_loss, flowtron_loss,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)

DIMS = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)
LOSS_KW = dict(sigma=1.0, gate_loss=True, use_ctc_loss=True,
               blank_logprob=-8.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def make_batch(B=3, T=18, Tk=7, M=8, seed=0):
    """Padded lengths, a normalised random prior, the reference's gate
    target; numpy."""
    rng = np.random.default_rng(seed)
    out_lens = np.asarray([T, T - 5, T - 3][:B])
    in_lens = np.asarray([Tk, Tk - 3, Tk - 1][:B])
    mel = rng.standard_normal((B, M, T)).astype(np.float32) - 2.0
    text = rng.integers(1, 185, (B, Tk))
    gate = np.zeros((B, T), np.float32)
    prior = np.zeros((B, T, Tk), np.float32)
    for b in range(B):
        mel[b, :, out_lens[b]:] = 0
        text[b, in_lens[b]:] = 0
        gate[b, out_lens[b] - 1:] = 1
        p = rng.uniform(0.05, 1.0, (out_lens[b], in_lens[b]))
        prior[b, :out_lens[b], :in_lens[b]] = p / p.sum(-1, keepdims=True)
    return {"mel": mel, "speaker_ids": np.asarray([0, 1, 0][:B]),
            "text": text, "in_lens": in_lens, "out_lens": out_lens,
            "gate_target": gate, "attn_prior": prior}


def perturbed_jax_params(seed=0):
    params, cfg = jax_init(jax.random.PRNGKey(seed), n_flows=2,
                           use_gate_layer=True, **DIMS)
    rng = np.random.default_rng(seed + 1)
    for f in params["flows"]:
        for k in ("w", "b"):
            f["conv"][k] = jnp.asarray(0.05 * rng.standard_normal(
                f["conv"][k].shape).astype(np.float32))
    return params, cfg


def port_model(params):
    model, cfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS)
    model.load_state_dict(flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return model, cfg


@pytest.fixture(scope="module")
def models():
    params, cfg = perturbed_jax_params()
    model, tcfg = port_model(params)
    return params, cfg, model, tcfg


def _jax_out(params, cfg, batch, **kw):
    return jax_forward(params, cfg, *(jnp.asarray(batch[k]) for k in (
        "mel", "speaker_ids", "text", "in_lens", "out_lens")),
        attn_prior=jnp.asarray(batch["attn_prior"]), **kw)


def _port_out(model, cfg, batch, **kw):
    return flowtron_forward(model, cfg, *(_t(batch[k]) for k in (
        "mel", "speaker_ids", "text", "in_lens", "out_lens")),
        attn_prior=_t(batch["attn_prior"]), **kw)


# --------------------------------------------------------------------------
# attention and LSTMs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_prior", [True, False])
def test_attention_forward_matches_jax(models, with_prior):
    params, _, model, _ = models
    rng = np.random.default_rng(2)
    Tq, B, Tk = 11, 3, 6
    queries = rng.standard_normal((Tq, B, 16)).astype(np.float32)
    keys = rng.standard_normal((Tk, B, 16)).astype(np.float32)
    key_mask = np.arange(Tk)[None] < np.asarray([6, 3, 5])[:, None]
    prior = rng.uniform(0.01, 1, (B, Tq, Tk)).astype(np.float32) \
        if with_prior else None
    ref = jax_attention_forward(
        params["flows"][0]["attention_layer"], jnp.asarray(queries),
        jnp.asarray(keys), jnp.asarray(keys), jnp.asarray(key_mask),
        None if prior is None else jnp.asarray(prior))
    ours = attention_forward(
        model.flows[0].attention_layer, _t(queries), _t(keys), _t(keys),
        _t(key_mask), None if prior is None else _t(prior))
    for o, r in zip(ours, ref):          # context, attn, attn_logprob
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("bidirectional", [False, True])
def test_fused_lstm_matches_loop_masked(bidirectional):
    """torch's fused LSTM with packing (the CUDA path) against the plain
    loop (the CPU path) on the CPU, where both run."""
    lstm = LSTM(6, 5, num_layers=2, bidirectional=bidirectional,
                generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (9, 3, 6)).astype(np.float32))
    mask = torch.arange(9)[:, None] < torch.tensor([9, 4, 7])[None]
    with torch.no_grad():
        out, (h, c) = lstm_fused(lstm, x, mask)
        if bidirectional:
            ref = bilstm_forward(lstm, x, mask)
        else:
            ref, finals = lstm_forward(lstm, x, mask)
            for k, (hk, ck) in enumerate(finals):
                torch.testing.assert_close(h[k], hk, atol=1e-6, rtol=0)
                torch.testing.assert_close(c[k], ck, atol=1e-6, rtol=0)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=0)
    assert bool((out[~mask] == 0).all())


def test_lstm_forward_matches_jax_masked(models):
    params, _, model, _ = models
    rng = np.random.default_rng(3)
    x = rng.standard_normal((10, 3, 24)).astype(np.float32)
    mask = np.arange(10)[:, None] < np.asarray([10, 6, 8])[None]
    ref, ref_fin = jax_lstm_forward(params["flows"][0]["lstm"],
                                    jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out, fin = lstm_forward(model.flows[0].lstm, _t(x), _t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    for (h, c), (rh, rc) in zip(fin, ref_fin):
        np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-5)
        np.testing.assert_allclose(c.numpy(), np.asarray(rc), atol=1e-5)


# --------------------------------------------------------------------------
# dropout
# --------------------------------------------------------------------------

def _one_conv_encoder():
    return Encoder(encoder_n_convolutions=1, encoder_embedding_dim=12,
                   generator=torch.Generator().manual_seed(0))


def test_dropout_is_seeded_reproducible_and_scaled_by_two():
    enc = _one_conv_encoder()
    x = torch.randn(2, 12, 9, generator=torch.Generator().manual_seed(1))
    mask = (torch.arange(9)[None] < torch.tensor([9, 6])[:, None])[:, None]
    with torch.no_grad():
        plain = _conv_stack(enc, x, mask)
        drop = [_conv_stack(enc, x, mask, True,
                            torch.Generator().manual_seed(s))
                for s in (5, 5, 6)]
    torch.testing.assert_close(drop[0], drop[1], rtol=0, atol=0)
    assert not torch.equal(drop[0], drop[2])
    kept = drop[0] != 0
    torch.testing.assert_close(drop[0][kept], 2 * plain[kept])
    frac = float(kept.sum()) / float((plain != 0).sum())
    assert 0.3 < frac < 0.7, frac
    # no generator or train=False: no dropout
    with torch.no_grad():
        torch.testing.assert_close(_conv_stack(enc, x, mask, True, None),
                                   plain)


# --------------------------------------------------------------------------
# the model and the losses
# --------------------------------------------------------------------------

def test_flowtron_forward_matches_jax(models):
    """z, every flow's log_s, the gate, attn and attn_logprob, with the
    prior and padded lengths; dropout off (train=False) on both sides."""
    params, cfg, model, tcfg = models
    batch = make_batch()
    ref = _jax_out(params, cfg, batch)
    with torch.no_grad():
        ours = _port_out(model, tcfg, batch)
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5)
    np.testing.assert_allclose(ours[2].numpy(), np.asarray(ref[2]),
                               atol=1e-5)
    for i in range(2):
        for o, r in ((ours[1][i], ref[1][i]), (ours[3][i], ref[3][i])):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
        np.testing.assert_allclose(ours[4][i].numpy(), np.asarray(ref[4][i]),
                                   atol=1e-5, rtol=1e-6)
    assert ours[5:] == (None, None, None)


def _rel(a, b):
    a, b = (float(x.detach()) if torch.is_tensor(x) else float(x)
            for x in (a, b))
    return abs(a - b) / max(1e-12, abs(b))


def test_flowtron_loss_matches_jax(models):
    params, cfg, model, tcfg = models
    batch = make_batch(seed=4)
    ref = jax_loss(_jax_out(params, cfg, batch),
                   jnp.asarray(batch["gate_target"]),
                   jnp.asarray(batch["in_lens"]),
                   jnp.asarray(batch["out_lens"]), **LOSS_KW)
    with torch.no_grad():
        ours = flowtron_loss(_port_out(model, tcfg, batch),
                             _t(batch["gate_target"]), _t(batch["in_lens"]),
                             _t(batch["out_lens"]), **LOSS_KW)
    for name, o, r in zip(("nll", "gate", "ctc"), ours, ref):
        assert o.dtype == torch.float32
        assert _rel(o, r) <= 1e-5, (name, float(o), float(r))


def test_ctc_impossible_alignment_scores_zero_as_jax():
    """A mel shorter than its text has no CTC path: optax's loss is
    ~1e5 there and JAX maps it to 0; F.ctc_loss gives inf, which
    zero_infinity=True maps to 0 (with a finite gradient)."""
    rng = np.random.default_rng(5)
    lp = np.log(rng.dirichlet(np.ones(6), (2, 10))).astype(np.float32)
    in_lens, out_lens = np.asarray([6, 3]), np.asarray([3, 10])
    ref = jax_ctc(jnp.asarray(lp), jnp.asarray(in_lens),
                  jnp.asarray(out_lens), -8.0)
    x = _t(lp).requires_grad_()
    ours = attention_ctc_loss(x, _t(in_lens), _t(out_lens), -8.0)
    assert _rel(ours, ref) <= 1e-5
    only_second = attention_ctc_loss(x[1:], _t(in_lens[1:]),
                                     _t(out_lens[1:]), -8.0)
    assert _rel(ours, only_second / 2) <= 1e-6
    ours.backward()
    assert bool(torch.isfinite(x.grad).all())
    assert bool((x.grad[0] == 0).all())


def test_total_loss_gradients_match_jax(models):
    """Gradient of nll + gate + ctc per parameter tensor, within 1e-4 of
    that tensor's largest gradient. The encoder conv biases feed an
    instance norm, so their true gradient is 0 and both sides hold
    rounding noise: the scale is floored at 1e-3."""
    params, cfg, model, tcfg = models
    batch = make_batch(seed=6)

    def jax_total(p):
        nll, gate, ctc = jax_loss(_jax_out(p, cfg, batch),
                                  jnp.asarray(batch["gate_target"]),
                                  jnp.asarray(batch["in_lens"]),
                                  jnp.asarray(batch["out_lens"]), **LOSS_KW)
        return nll + gate + ctc

    grads = flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.grad(jax_total)(params)))
    model.zero_grad(set_to_none=True)
    nll, gate, ctc = flowtron_loss(
        _port_out(model, tcfg, batch), _t(batch["gate_target"]),
        _t(batch["in_lens"]), _t(batch["out_lens"]), **LOSS_KW)
    (nll + gate + ctc).backward()
    for name, p in model.named_parameters():
        ref = grads[name].numpy()
        scale = max(np.abs(ref).max(), 1e-3)
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * scale, (name, err, scale)
    model.zero_grad(set_to_none=True)


def _dtypes(out):
    """The dtype of z, every log_s, the gate, every attn and attn_logprob,
    as strings, for either package's forward tuple."""
    return [str(x.dtype).replace("torch.", "") for x in
            (out[0], *out[1], out[2], *out[3], *out[4])]


def test_bf16_policy_loss_matches_jax_bf16(models):
    """fp16_run's bf16 policy on both sides, with the prior: each output
    has JAX's dtype (its fp32 posterior promotes everything after it),
    the nll within 1e-4 and the total loss within 1e-3 (the encoder and
    the first attention LSTM round to bf16 at other places), and the fp32
    master weights get fp32 gradients."""
    params, cfg, model, tcfg = models
    batch = make_batch(seed=7)
    jax_out = _jax_out(params, cfg, batch, compute_dtype=jnp.bfloat16)
    ref = jax_loss(jax_out, jnp.asarray(batch["gate_target"]),
                   jnp.asarray(batch["in_lens"]),
                   jnp.asarray(batch["out_lens"]), **LOSS_KW)
    out = _port_out(model, tcfg, batch, compute_dtype=torch.bfloat16)
    assert _dtypes(out) == _dtypes(jax_out)
    ours = flowtron_loss(out, _t(batch["gate_target"]), _t(batch["in_lens"]),
                         _t(batch["out_lens"]), **LOSS_KW)
    msg = ([float(x.detach()) for x in ours], [float(x) for x in ref])
    assert _rel(ours[0], ref[0]) <= 1e-4, msg
    assert _rel(sum(ours), sum(ref)) <= 1e-3, msg
    model.zero_grad(set_to_none=True)
    sum(ours).backward()
    p = model.flows[0].conv.weight
    assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    assert float(p.grad.abs().max()) > 0
    model.zero_grad(set_to_none=True)


def test_bf16_policy_without_prior_stays_bf16_as_jax(models):
    """Without a prior nothing leaves bf16 on either side but the
    attention log-probabilities; z and the nll agree."""
    params, cfg, model, tcfg = models
    batch = make_batch(seed=3)
    jax_out = jax_forward(params, cfg, *(jnp.asarray(batch[k]) for k in (
        "mel", "speaker_ids", "text", "in_lens", "out_lens")),
        compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        out = flowtron_forward(model, tcfg, *(_t(batch[k]) for k in (
            "mel", "speaker_ids", "text", "in_lens", "out_lens")),
            compute_dtype=torch.bfloat16)
    assert _dtypes(out) == _dtypes(jax_out)
    assert out[0].dtype == torch.bfloat16
    kw = dict(LOSS_KW, use_ctc_loss=False)
    args = ("gate_target", "in_lens", "out_lens")
    nll = flowtron_loss(out, *(_t(batch[k]) for k in args), **kw)[0]
    ref = jax_loss(jax_out, *(jnp.asarray(batch[k]) for k in args), **kw)[0]
    assert _rel(nll, ref) <= 1e-3, (float(nll), float(ref))


def test_invertibility_oracle_on_cpu(models):
    _, _, model, tcfg = models
    rng = np.random.default_rng(8)
    residual = _t((0.5 * rng.standard_normal((2, 8, 14))).astype(np.float32))
    err = flowtron_test_invertibility(model, tcfg, residual,
                                      torch.tensor([0, 1]),
                                      torch.randint(1, 185, (2, 6)))
    assert float(err) <= 1e-5
