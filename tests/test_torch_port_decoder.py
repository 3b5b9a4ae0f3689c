"""Kernel K1 (flowtron_tpu_torch/ops/decoder.py): its plain version
against the JAX Pallas kernel (interpret mode) and the JAX scan path, the
port's routing in ar_step_infer, and early-exit semantics. Toy widths as
in tests/test_pallas.py; zero-init coupling heads are perturbed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402
from flowtron_tpu.models.ar_step import (  # noqa: E402
    ar_step_params, ar_step_infer as jax_ar_step_infer,
)
from flowtron_tpu.models.attention import (  # noqa: E402
    attention_precompute as jax_attention_precompute,
)
from flowtron_tpu.ops.decoder_pallas import (  # noqa: E402
    pack_flow_weights as jax_pack, fused_flow_infer as jax_fused,
)

from flowtron_tpu_torch.models.ar_step import ARStep, ar_step_infer  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_init, flowtron_infer,
)
from flowtron_tpu_torch.ops.decoder import (  # noqa: E402
    fused_flow_infer, fused_flow_infer_reference,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)

SMALL = dict(n_mel_channels=8, n_speaker_dim=4, n_text_channels=12,
             n_hidden=16, n_attn_channels=8, n_lstm_layers=2)
DIMS = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)


def _jax_flow(seed=0):
    p = ar_step_params(jax.random.PRNGKey(seed), add_gate=True, **SMALL)
    rng = np.random.default_rng(seed + 1)
    p["conv"]["w"] = jnp.asarray(
        0.05 * rng.standard_normal(p["conv"]["w"].shape).astype(np.float32))
    p["conv"]["b"] = jnp.asarray(
        0.05 * rng.standard_normal(p["conv"]["b"].shape).astype(np.float32))
    return p


def _torch_flow(p):
    """Load one JAX flow into an ARStep through the full-model bridge."""
    flow = ARStep(add_gate=True, **SMALL)
    sd = flowtron_state_dict_from_jax({
        "speaker_embedding": {"table": np.zeros((1, 4), np.float32)},
        "embedding": {"table": np.zeros((1, 12), np.float32)},
        "encoder": {"convolutions": [], "lstm": {"layers": []}},
        "flows": [jax.tree.map(np.asarray, p)]})
    flow.load_state_dict({k[len("flows.0."):]: v for k, v in sd.items()
                          if k.startswith("flows.0.")}, strict=True)
    return flow


@pytest.fixture(scope="module")
def case():
    p = _jax_flow()
    rng = np.random.default_rng(2)
    N, B, M, Tk = 20, 3, 8, 5
    residual = (rng.standard_normal((N, B, M)) * 0.5).astype(np.float32)
    text = rng.standard_normal((Tk, B, 16)).astype(np.float32)
    key_mask = (np.arange(Tk)[None] < np.asarray([5, 3, 4])[:, None])
    return p, _torch_flow(p), residual, text, key_mask


def _t(a):
    return torch.from_numpy(np.array(a))


class TestPlainVersion:
    def test_matches_pallas_interpret_with_key_mask(self, case):
        p, flow, residual, text, key_mask = case
        kp, vals = jax_attention_precompute(p["attention_layer"],
                                            jnp.asarray(text),
                                            jnp.asarray(text))
        km = key_mask.astype(np.float32)
        mel_j, attn_j, gates_j = jax_fused(
            jax_pack(p, dtype=jnp.float32), jnp.asarray(residual), kp, vals,
            jnp.asarray(km), 1.3, interpret=True)
        ours = fused_flow_infer_reference(
            flow.packed_weights(), _t(residual), _t(kp), _t(vals), _t(km),
            1.3)
        for a, r in zip(ours, (mel_j, attn_j, gates_j)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                       atol=1e-5)

    @pytest.mark.parametrize("fused", [False, True])
    def test_port_paths_match_jax_scan(self, case, fused):
        """ar_step_infer on CPU: the plain loop (fused=False) and K1's
        plain version (fused=True) both equal the JAX scan."""
        p, flow, residual, text, key_mask = case
        mel_j, attn_j, nv_j = jax_ar_step_infer(
            p, jnp.asarray(residual), jnp.asarray(text),
            key_mask=jnp.asarray(key_mask), gate_threshold=0.45)
        with torch.no_grad():
            mel, attn, nv = ar_step_infer(
                flow, _t(residual), _t(text), key_mask=_t(key_mask),
                gate_threshold=0.45, fused=fused)
        np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=1e-5)
        np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j),
                                   atol=1e-5)
        np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_j))

    @pytest.mark.parametrize("fused", [False, "early"])
    def test_prior_and_per_stream_temperature_on_plain_loop(self, case,
                                                            fused):
        """Outside K1's subset a CPU flow runs the plain loop even when
        fused is asked for, as the JAX package falls back to its scan."""
        p, flow, residual, text, _ = case
        rng = np.random.default_rng(9)
        prior = rng.uniform(0.01, 1, (3, 20, 5)).astype(np.float32)
        temp = np.asarray([[0.7], [1.0], [1.6]], np.float32)
        mel_j, _, _ = jax_ar_step_infer(
            p, jnp.asarray(residual), jnp.asarray(text),
            attn_prior=jnp.asarray(prior), temperature=jnp.asarray(temp),
            gate_threshold=1e6, fused=fused)
        with torch.no_grad():
            mel, _, _ = ar_step_infer(flow, _t(residual), _t(text),
                                      attn_prior=_t(prior),
                                      temperature=_t(temp),
                                      gate_threshold=1e6, fused=fused)
        np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=1e-5)

    def test_wrapper_has_no_silent_fallback(self, case):
        """Only CPU tensors take the plain version; any other device
        launches the kernel or raises."""
        _, flow, residual, text, key_mask = case
        w = {k: (v.to("meta") if torch.is_tensor(v) else
                 [tuple(t.to("meta") for t in pair) for pair in v])
             for k, v in flow.packed_weights().items()}
        meta = torch.zeros(20, 3, 8, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            fused_flow_infer(w, meta, meta, meta, meta, 1.0)


class TestEarlyExit:
    @pytest.fixture(scope="class")
    def models(self):
        params, cfg = jax_flowtron_init(jax.random.PRNGKey(0), n_flows=2,
                                        use_gate_layer=True, **DIMS)
        rng = np.random.default_rng(1)
        for f in params["flows"]:
            f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
                f["conv"]["w"].shape).astype(np.float32))
        gate = params["flows"][-1]["gate_layer"]
        gate["w"] = jnp.ones_like(gate["w"]) * 0.2
        model, tcfg = flowtron_init(0, n_flows=2, use_gate_layer=True,
                                    **DIMS)
        model.load_state_dict(flowtron_state_dict_from_jax(
            jax.tree.map(np.asarray, params)), strict=True)
        return params, cfg, model, tcfg

    # 0.35: every stream fires early, later frames are skipped;
    # 0.55: one early hit, two never
    @pytest.mark.parametrize("thresh", [0.35, 0.55])
    def test_matches_scan_on_valid_prefix(self, models, thresh):
        params, cfg, model, tcfg = models
        rng = np.random.default_rng(3)
        B, N = 3, 40
        residual = (rng.standard_normal((B, 8, N)) * 0.8).astype(np.float32)
        text = rng.integers(1, 185, (B, 7))
        sids = np.asarray([0, 1, 0])
        mel_s, _, nv_s = jax_flowtron_infer(
            params, cfg, jnp.asarray(residual), jnp.asarray(sids),
            jnp.asarray(text), gate_threshold=thresh)
        mel_e, _, nv_e = flowtron_infer(
            model, tcfg, _t(residual), _t(sids), _t(text),
            gate_threshold=thresh, fused="early")
        nv_s = np.asarray(nv_s)
        np.testing.assert_array_equal(nv_e.numpy(), nv_s)
        for b in range(B):
            n = int(nv_s[b])
            np.testing.assert_allclose(mel_e.numpy()[b, :, :n],
                                       np.asarray(mel_s)[b, :, :n],
                                       atol=1e-4, err_msg=f"b={b}")
        assert not np.isnan(mel_e.numpy()).any()

    def test_skipped_frames_are_zero_with_gate_one(self, case):
        p, flow, residual, text, key_mask = case
        with torch.no_grad():
            from flowtron_tpu_torch.models.attention import (
                attention_precompute)
            kp, vals = attention_precompute(flow.attention_layer, _t(text),
                                            _t(text))
            w = flow.packed_weights()
            args = (w, _t(residual), kp, vals,
                    torch.ones(3, 5), 1.0)
            mel, attn, gates = fused_flow_infer(*args)
            thresh = float(gates[:5].max(dim=0).values.min()) - 1e-4
            mel_e, attn_e, gates_e = fused_flow_infer(
                *args, early_exit=True, gate_threshold=thresh)
        hit = gates > thresh
        stop = int(hit.to(torch.int64).argmax(dim=0).max())   # done_at
        assert stop < 19
        torch.testing.assert_close(mel_e[:stop + 1], mel[:stop + 1])
        assert bool((mel_e[stop + 1:] == 0).all())
        assert bool((attn_e[stop + 1:] == 0).all())
        assert bool((gates_e[stop + 1:] == 1).all())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(case, cuda_device):
    _, flow, residual, text, key_mask = case
    flow = flow.to(cuda_device)
    from flowtron_tpu_torch.models.attention import attention_precompute
    with torch.no_grad():
        kp, vals = attention_precompute(flow.attention_layer,
                                        _t(text).to(cuda_device),
                                        _t(text).to(cuda_device))
    args = (flow.packed_weights(), _t(residual).to(cuda_device), kp, vals,
            _t(key_mask.astype(np.float32)).to(cuda_device), 1.0)
    for early in (False, True):
        ours = fused_flow_infer(*args, early_exit=early, gate_threshold=0.45)
        ref = fused_flow_infer_reference(*args, early_exit=early,
                                         gate_threshold=0.45)
        for a, r in zip(ours, ref):
            torch.testing.assert_close(a, r, atol=1e-5, rtol=0)
    # a prior is outside K1's subset: the flow runs the per-frame loop on
    # the card, as JAX falls back to its scan, and K1 is not launched
    prior = torch.full((3, 20, 5), 0.2)
    launches = fused_flow_infer.launches
    with torch.no_grad():
        mel_card, _, nv_card = ar_step_infer(
            flow, args[1], _t(text).to(cuda_device),
            attn_prior=prior.to(cuda_device))
        assert fused_flow_infer.launches == launches
        mel_cpu, _, nv_cpu = ar_step_infer(flow.cpu(), args[1].cpu(),
                                           _t(text), attn_prior=prior)
    torch.testing.assert_close(mel_card.cpu(), mel_cpu, atol=1e-4, rtol=0)
    assert torch.equal(nv_card.cpu(), nv_cpu)
