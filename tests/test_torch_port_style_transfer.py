"""Style transfer and external attention maps in the port against the JAX
package at toy widths: ``posterior_mean``, ``collect_z``,
``style_transfer`` (JAX's ``jax.random`` draw passed in as ``noise``),
``flowtron_infer(attns=...)`` with a gate that fires before N in the
backward flow, the maps fed back, ``attention_forward(attn_map=...)``,
the routing that keeps a map away from K1, and the style-transfer script
on a tiny corpus."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.infer.style_transfer import (  # noqa: E402
    collect_z as jax_collect_z, posterior_mean as jax_posterior_mean,
    style_transfer as jax_style_transfer,
)
from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402
from flowtron_tpu.models.attention import (  # noqa: E402
    attention_forward as jax_attention_forward,
)

from flowtron_tpu_torch.infer.style_transfer import (  # noqa: E402
    collect_z, posterior_mean, style_transfer,
)
from flowtron_tpu_torch.models import ar_step  # noqa: E402
from flowtron_tpu_torch.models.attention import attention_forward  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_init, flowtron_infer,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)
M = DIMS["n_mel_channels"]
GATE_FIRES = 0.45      # a threshold the gate of the backward flow passes
                       # before N on these inputs (asserted where used)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """JAX params with perturbed heads, and the port's model with the same
    weights."""
    rng = np.random.default_rng(0)
    params, cfg = jax_flowtron_init(jax.random.PRNGKey(0), n_flows=2,
                                    use_gate_layer=True, **DIMS)
    for f in params["flows"]:
        f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            f["conv"]["w"].shape).astype(np.float32))
    model, tcfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS)
    model.load_state_dict(flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return params, cfg, model, tcfg


def _reference_batch(seed=5):
    """Three references of unequal text and mel lengths, padded."""
    rng = np.random.default_rng(seed)
    out_lens = np.array([11, 7, 9])
    in_lens = np.array([6, 4, 5])
    mel = np.zeros((3, M, 11), np.float32)
    text = np.zeros((3, 6), np.int64)
    for b in range(3):
        mel[b, :, :out_lens[b]] = rng.standard_normal((M, out_lens[b]))
        text[b, :in_lens[b]] = rng.integers(1, 185, in_lens[b])
    return {"mel": mel, "speaker_ids": np.array([0, 1, 1]), "text": text,
            "in_lens": in_lens, "out_lens": out_lens}


@pytest.mark.parametrize("case", ["tiling", "strong_prior", "unequal"])
def test_posterior_mean_matches_jax(case):
    """The tiling and ridge cases of tests/test_style_transfer.py and
    utterances of unequal length, exact to 1e-7."""
    rng = np.random.default_rng(1)
    if case == "tiling":
        z_list, lam, n = [np.ones((4, 3), np.float32),
                          3 * np.ones((6, 3), np.float32)], 1e-4, 8
    elif case == "strong_prior":
        z_list, lam, n = [np.ones((4, 2), np.float32)], 10.0, 4
    else:
        z_list = [rng.standard_normal((T, M)).astype(np.float32)
                  for T in (5, 13, 9, 2)]
        lam, n = 1e-4, 17
    lens = [len(z) for z in z_list]
    ours = posterior_mean(z_list, lens, n, lam)
    ref = jax_posterior_mean(z_list, lens, n, lam)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, atol=1e-7, rtol=0)


def test_collect_z_matches_jax(models):
    params, cfg, model, tcfg = models
    batch = _reference_batch()
    ref = jax_collect_z(params, cfg, *(jnp.asarray(batch[k]) for k in (
        "mel", "speaker_ids", "text", "in_lens", "out_lens")))
    z = collect_z(model, tcfg, *(_t(batch[k]) for k in (
        "mel", "speaker_ids", "text", "in_lens", "out_lens")))
    assert not z.requires_grad
    np.testing.assert_allclose(z.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("thresh", [1e6, GATE_FIRES])
def test_style_transfer_matches_jax(models, thresh):
    """JAX's draw (``jax.random.normal(PRNGKey(seed), ...)``) passed in as
    ``noise``: mel 1e-4, ``n`` identical; with the gate off and with a
    gate that fires before n_frames."""
    params, cfg, model, tcfg = models
    batch = _reference_batch()
    rng = np.random.default_rng(2)
    text_ids = list(rng.integers(1, 185, 6))
    n_frames, seed = 14, 77
    mel_j, n_j = jax_style_transfer(params, cfg, batch, text_ids, 1,
                                    n_frames=n_frames, gate_threshold=thresh,
                                    seed=seed)
    noise = np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                       (1, M, n_frames)))
    mel, n = style_transfer(model, tcfg, batch, text_ids, 1,
                            n_frames=n_frames, gate_threshold=thresh,
                            seed=seed, device="cpu", noise=noise)
    assert n == n_j
    assert (n == n_frames) == (thresh == 1e6)
    assert mel.shape == (M, n)
    np.testing.assert_allclose(mel, np.asarray(mel_j), atol=1e-4)


def test_style_transfer_draws_from_a_seeded_torch_generator(models):
    """Without ``noise`` the draw is ``torch.Generator(device)`` seeded
    with ``seed``: one seed gives one mel, another seed another."""
    _, _, model, tcfg = models
    batch = _reference_batch()
    kw = dict(n_frames=10, gate_threshold=1e6, device="cpu")
    a, _ = style_transfer(model, tcfg, batch, [5, 6, 7], 0, seed=3, **kw)
    b, _ = style_transfer(model, tcfg, batch, [5, 6, 7], 0, seed=3, **kw)
    c, _ = style_transfer(model, tcfg, batch, [5, 6, 7], 0, seed=4, **kw)
    noise = torch.randn(1, M, 10, generator=torch.Generator().manual_seed(3))
    d, _ = style_transfer(model, tcfg, batch, [5, 6, 7], 0, noise=noise,
                          **kw)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, d)
    assert not np.array_equal(a, c)


def _softmax_maps(rng, B, N, Tk, n_flows=2):
    maps = []
    for _ in range(n_flows):
        x = rng.standard_normal((B, N, Tk)).astype(np.float32) * 2
        e = np.exp(x - x.max(-1, keepdims=True))
        maps.append((e / e.sum(-1, keepdims=True)).astype(np.float32))
    return maps


def _infer_inputs(seed=3, B=2, N=16, Tk=7):
    rng = np.random.default_rng(seed)
    residual = (rng.standard_normal((B, M, N)) * 0.5).astype(np.float32)
    text = rng.integers(1, 185, (B, Tk))
    return rng, residual, np.asarray([0, 1]), text, np.asarray([Tk, Tk - 2])


@pytest.mark.parametrize("fused", [False, "early"])
def test_infer_with_external_maps_matches_jax(models, fused):
    """The same random softmax maps through both packages: mel 1e-4 over
    the valid frames, the returned attention 1e-5, ``n_valid`` identical
    and below N (the gate fires in the backward flow, whose map JAX
    does not flip)."""
    params, cfg, model, tcfg = models
    rng, residual, sids, text, in_lens = _infer_inputs()
    B, _, N = residual.shape
    maps = _softmax_maps(rng, B, N, text.shape[1])
    mel_j, attns_j, nv_j = jax_flowtron_infer(
        params, cfg, jnp.asarray(residual), jnp.asarray(sids),
        jnp.asarray(text), gate_threshold=GATE_FIRES,
        in_lens=jnp.asarray(in_lens), attns=[jnp.asarray(a) for a in maps],
        fused=fused)
    mel, attns, nv = flowtron_infer(
        model, tcfg, _t(residual), _t(sids), _t(text),
        gate_threshold=GATE_FIRES, in_lens=_t(in_lens),
        attns=[_t(a) for a in maps], fused=fused)
    nv_j = np.asarray(nv_j)
    np.testing.assert_array_equal(nv.numpy(), nv_j)
    assert (nv_j < N).all(), nv_j
    for b in range(B):
        n = int(nv_j[b])
        np.testing.assert_allclose(mel.numpy()[b, :, :n],
                                   np.asarray(mel_j)[b, :, :n], atol=1e-4)
    for a, a_j in zip(attns, attns_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(a_j), atol=1e-5)


@pytest.mark.parametrize("thresh", [1e6, GATE_FIRES])
def test_maps_fed_back_give_the_same_mel(models, thresh):
    """tests/test_model.py's round trip in the port: the maps one run
    returns, reversed, fed back through ``attns=`` give its mel (1e-5)."""
    _, _, model, tcfg = models
    _, residual, sids, text, in_lens = _infer_inputs(seed=4)
    args = (model, tcfg, _t(residual), _t(sids), _t(text))
    kw = dict(gate_threshold=thresh, in_lens=_t(in_lens))
    mel1, attns, nv1 = flowtron_infer(*args, **kw)
    mel2, _, nv2 = flowtron_infer(*args, attns=list(reversed(attns)), **kw)
    np.testing.assert_array_equal(nv2.numpy(), nv1.numpy())
    np.testing.assert_allclose(mel2.numpy(), mel1.numpy(), atol=1e-5)


def test_attention_forward_external_map_matches_jax(models):
    """``attn_map`` against JAX's ``attn``: no scores, context and attn
    1e-5, no logprob."""
    params, _, model, _ = models
    rng = np.random.default_rng(6)
    Tq, B, Tk = 5, 2, 4
    queries = rng.standard_normal((Tq, B, 16)).astype(np.float32)
    keys = rng.standard_normal((Tk, B, 16)).astype(np.float32)
    amap = _softmax_maps(rng, B, Tq, Tk, n_flows=1)[0]
    ref = jax_attention_forward(
        params["flows"][0]["attention_layer"], jnp.asarray(queries),
        jnp.asarray(keys), jnp.asarray(keys), attn=jnp.asarray(amap))
    ours = attention_forward(model.flows[0].attention_layer, _t(queries),
                             _t(keys), _t(keys), attn_map=_t(amap))
    assert ref[2] is None and ours[2] is None
    for o, r in zip(ours[:2], ref[:2]):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(r),
                                   atol=1e-5)


def test_external_map_never_reaches_k1(models, monkeypatch):
    """A flow with a map runs the loop, even where K1 (or its plain
    version, ``fused`` on the CPU) would run without one: the JAX package's
    routing (flowtron_tpu/models/ar_step.py:222)."""
    _, _, model, tcfg = models
    rng, residual, sids, text, _ = _infer_inputs(seed=7)
    maps = _softmax_maps(rng, 2, residual.shape[2], text.shape[1])
    flow = model.flows[0]
    assert ar_step.in_k1_subset(flow, None, 1.0)
    assert not ar_step.in_k1_subset(flow, None, 1.0, attn=_t(maps[0]))
    calls = []
    real = ar_step.fused_flow_infer
    monkeypatch.setattr(ar_step, "fused_flow_infer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    flowtron_infer(model, tcfg, _t(residual), _t(sids), _t(text),
                   fused="early", attns=[_t(a) for a in maps])
    assert calls == []
    flowtron_infer(model, tcfg, _t(residual), _t(sids), _t(text),
                   fused="early")
    assert len(calls) == 2


def test_style_transfer_script_end_to_end(tmp_path, monkeypatch):
    """``python -m flowtron_tpu_torch.scripts.style_transfer`` on a tiny
    corpus at toy widths: the mel ``.npy`` (80, n) and the wav of n hops
    under JAX's script's names."""
    from scipy.io import wavfile
    from flowtron_tpu_torch.config import load_config
    from flowtron_tpu_torch.data.synth import make_aligned_corpus
    from flowtron_tpu_torch.scripts.style_transfer import main
    refs, _ = make_aligned_corpus(str(tmp_path / "corpus"), n_utterances=3,
                                  seed=2)
    dims = {"n_speaker_dim": 4, "n_text_dim": 12, "n_hidden": 16,
            "n_attn_channels": 8}
    overrides = [f"model_config.{k}={v}" for k, v in dims.items()]
    monkeypatch.chdir(ROOT)       # config.json's cmudict paths
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    config = load_config("config.json", overrides)
    model, _ = flowtron_init(3, **config["model_config"])
    ckpt = str(tmp_path / "ft.pt")
    torch.save(model.state_dict(), ckpt)
    out = tmp_path / "out"
    main(["-c", "config.json", "-p", *overrides, "-f", ckpt, "-r", refs,
          "-t", "A new sentence.", "-i", "0", "-n", "12", "-g", "1e6",
          "-o", str(out), "--seed", "9"])
    mel = np.load(out / "style_sid0_seed9_mel.npy")
    assert mel.shape == (80, 12) and np.isfinite(mel).all()
    sr, wav = wavfile.read(out / "style_sid0_seed9.wav")
    assert sr == 22050 and wav.dtype == np.int16
    assert len(wav) == (12 - 1) * 256      # Griffin-Lim: (frames - 1) hops
