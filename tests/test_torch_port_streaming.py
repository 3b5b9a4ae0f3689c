"""Streaming synthesis in the port (flowtron_tpu_torch/infer/streaming.py,
the carry of models/ar_step.py) against the JAX package at toy widths.

- The carry: a chunked loop equals one pass bit for bit, and a carried
  call never reaches kernel K1's wrapper, whatever ``fused`` says.
- ``StreamingMelSynthesizer`` against JAX's from the same ``residual``
  within 1e-4: one flow with the gate in the stream, two flows with the
  prelude, per-stream silence past the gate, per-call temperature and
  max_frames.
- ``StreamingVocoder`` against JAX's with latents from JAX's
  ``positional_z`` within 1e-4 of the scale; ``window_spec`` identical.
- ``stream_tts`` end to end: its mel equals the offline ``flowtron_infer``
  from the same latents, its audio one offline vocoder pass with the same
  positional latents within JAX's 5e-3 seam bar.
- ``flowtron-torch-infer --stream -d`` and ``-d`` write their wavs
  (test_torch_port_slice.py's CLI harness); ``--stream`` needs ``-w``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.infer import streaming as jax_streaming  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402

from flowtron_tpu_torch.infer.streaming import (  # noqa: E402
    SILENCE, StreamingMelSynthesizer, StreamingVocoder, positional_z,
    stream_generators, stream_tts, window_spec,
)
from flowtron_tpu_torch.models import ar_step as port_ar_step  # noqa: E402
from flowtron_tpu_torch.models.ar_step import ar_step_infer  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    _encode_text, flowtron_infer, flowtron_init,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax, waveglow_from_jax,
)
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    waveglow_infer_z, waveglow_init,
)
from tests.test_torch_port_slice import DIMS as CLI_DIMS, _cli_wav  # noqa: E402

SMALL = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
             n_mel_channels=8, n_hidden=16, n_attn_channels=8,
             n_lstm_layers=2, mel_encoder_n_hidden=8)
TINY_WG = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
               n_early_size=2, n_layers=2, n_channels=16, kernel_size=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(n_flows, seed):
    """A JAX Flowtron with perturbed heads and the port's copy of it."""
    params, cfg = jax_flowtron_init(jax.random.PRNGKey(seed),
                                    n_flows=n_flows, use_gate_layer=True,
                                    **SMALL)
    rng = np.random.default_rng(seed)
    for f in params["flows"]:
        f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            f["conv"]["w"].shape).astype(np.float32))
    model, tcfg = flowtron_init(0, n_flows=n_flows, use_gate_layer=True,
                                **SMALL)
    model.load_state_dict(flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    return (params, cfg), (model, tcfg)


@pytest.fixture(scope="module")
def one_flow():
    return _pair(1, 0)


@pytest.fixture(scope="module")
def two_flows():
    return _pair(2, 5)


@pytest.fixture(scope="module")
def wg():
    params, cfg = jax_waveglow_init(jax.random.PRNGKey(2), **TINY_WG)
    rng = np.random.default_rng(3)
    for wn in params["wn"]:
        wn["end"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            wn["end"]["w"].shape).astype(np.float32))
    model, tcfg = waveglow_init(**TINY_WG)
    model.load_state_dict(waveglow_from_jax(jax.tree.map(np.asarray, params),
                                            cfg), strict=True)
    return (params, cfg), (model, tcfg)


def _inputs(B, N, seed, Tk=7):
    rng = np.random.default_rng(seed)
    residual = (rng.standard_normal((B, 8, N)) * 0.6).astype(np.float32)
    text = rng.integers(1, 185, (B, Tk))
    return residual, np.arange(B) % 2, text


def _gate_threshold(model, tcfg, residual, sids, text, t_min):
    """A threshold at which stream 0's gate (on the last flow, over the
    flipped latents when that flow is a backward one) first fires at a
    frame >= t_min: the midpoint between that frame's gate and the largest
    before it, for the first frame that tops them by 2e-3."""
    flow = model.flows[-1]
    z = _t(residual).permute(2, 0, 1)
    if hasattr(flow, "ar_step"):
        flow, z = flow.ar_step, z.flip(0)
    with torch.no_grad():
        enc = _encode_text(model, tcfg, _t(sids), _t(text))
        _, _, gates, _ = ar_step_infer(flow, z, enc, return_carry=True)
    g = gates[:, 0].double()
    before = torch.cummax(g, 0).values
    t = next(t for t in range(t_min, len(g)) if g[t] > before[t - 1] + 2e-3)
    return float(g[t] + before[t - 1]) / 2


def _stream_both(jax_pair, port_pair, residual, sids, text, chunk, thresh,
                 max_frames, **kw):
    (params, cfg), (model, tcfg) = jax_pair, port_pair
    js = jax_streaming.StreamingMelSynthesizer(
        params, cfg, chunk_frames=chunk, gate_threshold=thresh,
        max_frames=max_frames)
    ps = StreamingMelSynthesizer(model, tcfg, chunk_frames=chunk,
                                 gate_threshold=thresh, max_frames=max_frames)
    out = {}
    for name, s, conv, args in (
            ("jax", js, jnp.asarray, (jax.random.PRNGKey(0),)),
            ("port", ps, _t, (None,))):
        chunks = [np.asarray(c) for c in s.stream(
            *args, conv(sids), conv(text), residual=conv(residual), **kw)]
        out[name] = (chunks, s.n_valid.copy())
    return out


def test_carry_round_trip_is_bitwise(one_flow):
    """Three chunks with the carry equal one pass, bit for bit."""
    _, (model, tcfg) = one_flow
    rng = np.random.default_rng(2)
    z = _t((rng.standard_normal((24, 2, 8)) * 0.5).astype(np.float32))
    enc = _t((rng.standard_normal((5, 2, 16)) * 0.3).astype(np.float32))
    flow = model.flows[0]
    with torch.no_grad():
        full = ar_step_infer(flow, z, enc, return_carry=True)
        carry, parts = None, []
        for a, b in ((0, 5), (5, 16), (16, 24)):
            parts.append(ar_step_infer(flow, z[a:b], enc, carry=carry,
                                       return_carry=True))
            carry = parts[-1][3]
    assert torch.equal(torch.cat([p[0] for p in parts]), full[0])
    assert torch.equal(torch.cat([p[1] for p in parts], dim=1), full[1])
    assert torch.equal(torch.cat([p[2] for p in parts]), full[2])
    for a, b in zip(jax.tree.leaves(carry), jax.tree.leaves(full[3])):
        assert torch.equal(a, b)


def test_carried_call_never_reaches_k1(one_flow, monkeypatch):
    """fused=True with a carry, or asking for one, runs the loop: K1 starts
    from zero state. Without either, fused=True reaches K1's wrapper."""
    _, (model, _) = one_flow

    def k1(*a, **k):
        raise AssertionError("fused_flow_infer called")
    monkeypatch.setattr(port_ar_step, "fused_flow_infer", k1)
    z = torch.zeros(6, 1, 8)
    enc = torch.zeros(4, 1, 16)
    flow = model.flows[0]
    with torch.no_grad():
        *_, carry = ar_step_infer(flow, z, enc, fused=True,
                                  return_carry=True)
        ar_step_infer(flow, z, enc, fused="early", carry=carry,
                      return_carry=True)
        mel, _, nv = ar_step_infer(flow, z, enc, fused=True, carry=carry)
        assert mel.shape == (6, 1, 8) and nv.shape == (1,)
        with pytest.raises(AssertionError, match="fused_flow_infer"):
            ar_step_infer(flow, z, enc, fused=True)


def test_one_flow_gate_in_stream_matches_jax(one_flow):
    """n_flows == 1: chunks of 8, the gate fired by stream 0 mid-stream;
    n_valid identical, frames within 1e-4, frames past each stream's own
    n_valid silence."""
    residual, sids, text = _inputs(2, 40, 12)
    thresh = _gate_threshold(*one_flow[1], residual, sids, text, 10)
    out = _stream_both(*one_flow, residual, sids, text, 8, thresh, 400)
    (jc, jnv), (pc, pnv) = out["jax"], out["port"]
    np.testing.assert_array_equal(pnv, jnv)
    assert 10 < pnv[0] < 40
    assert [c.shape for c in pc] == [c.shape for c in jc]
    streamed = np.concatenate(pc, axis=2)
    np.testing.assert_allclose(streamed, np.concatenate(jc, axis=2),
                               atol=1e-4)
    for b in range(2):
        past = streamed[b, :, int(pnv[b]):]
        assert past.size == 0 or np.all(past == np.float32(SILENCE))


def test_two_flow_prelude_matches_jax_and_offline(two_flows):
    """n_flows == 2: the prelude (the gated backward flow) offline, flow 0
    streamed; against JAX's streamer and the port's offline inference."""
    residual, sids, text = _inputs(2, 36, 26, Tk=6)
    thresh = _gate_threshold(*two_flows[1], residual, sids, text, 8)
    out = _stream_both(*two_flows, residual, sids, text, 16, thresh, 36)
    (jc, jnv), (pc, pnv) = out["jax"], out["port"]
    np.testing.assert_array_equal(pnv, jnv)
    streamed = np.concatenate(pc, axis=2)
    np.testing.assert_allclose(streamed, np.concatenate(jc, axis=2),
                               atol=1e-4)
    model, tcfg = two_flows[1]
    mel, _, nv = flowtron_infer(model, tcfg, _t(residual), _t(sids),
                                _t(text), gate_threshold=thresh)
    np.testing.assert_array_equal(nv.numpy(), pnv)
    for b in range(2):
        n = int(pnv[b])
        np.testing.assert_allclose(streamed[b, :, :n], mel.numpy()[b, :, :n],
                                   atol=1e-5)
        assert np.all(streamed[b, :, n:] == np.float32(SILENCE))


def test_per_call_temperature_and_max_frames_match_jax(one_flow):
    residual, sids, text = _inputs(1, 32, 9, Tk=6)
    (params, cfg), (model, tcfg) = one_flow
    js = jax_streaming.StreamingMelSynthesizer(
        params, cfg, chunk_frames=8, gate_threshold=1e6, max_frames=32)
    ps = StreamingMelSynthesizer(model, tcfg, chunk_frames=8,
                                 gate_threshold=1e6, max_frames=32)
    runs = {}
    for kw in ({"temperature": 1.0}, {"temperature": 3.0},
               {"max_frames": 9}):
        j = np.concatenate([np.asarray(c) for c in js.stream(
            jax.random.PRNGKey(1), jnp.asarray(sids), jnp.asarray(text),
            residual=jnp.asarray(residual), **kw)], axis=2)
        p = np.concatenate([c.numpy() for c in ps.stream(
            None, _t(sids), _t(text), residual=_t(residual), **kw)], axis=2)
        np.testing.assert_array_equal(ps.n_valid, js.n_valid)
        assert p.shape == j.shape
        np.testing.assert_allclose(p, j, atol=1e-4)
        runs[tuple(kw.items())] = p
    assert not np.allclose(runs[(("temperature", 1.0),)],
                           runs[(("temperature", 3.0),)])
    assert ps.n_valid[0] == 9


def test_streaming_vocoder_matches_jax(wg):
    """Chunks of 20 mel frames, context 16, lookahead 8, latents from JAX's
    positional_z on both sides."""
    (params, cfg), (model, tcfg) = wg
    mel = (np.random.default_rng(4).standard_normal((1, 8, 60)) * 0.5
           - 4.0).astype(np.float32)
    key = jax.random.PRNGKey(9)

    def source(start, n):
        z_main, z_early = jax_streaming.positional_z(key, cfg, 1, start, n,
                                                     0.8)
        return _t(z_main), [None if z is None else _t(z) for z in z_early]

    jv = jax_streaming.StreamingVocoder(params, cfg, key, sigma=0.8,
                                        context=16, lookahead=8)
    pv = StreamingVocoder(model, tcfg, latents=source, context=16,
                          lookahead=8, max_frames=60)
    for s in range(0, 60, 20):
        j = jv.push(jnp.asarray(mel[:, :, s:s + 20]))
        p = pv.push(_t(mel[:, :, s:s + 20]))
        assert p.shape == j.shape
        if j.size:
            np.testing.assert_allclose(p, j, atol=1e-4 * np.abs(j).max())
    j, p = jv.flush(), pv.flush()
    np.testing.assert_allclose(p, j, atol=1e-4 * np.abs(j).max())


def test_window_spec_matches_jax():
    for e0 in (0, 3, 16, 40):
        for n in (1, 8, 20):
            for F in range(e0 + n, e0 + n + 40, 7):
                for ctx, la in ((24, 16), (4, 4), (0, 0)):
                    for at_end in (False, True):
                        args = (e0, n, F, ctx, la, at_end)
                        assert window_spec(*args) == \
                            jax_streaming.window_spec(*args), args


def test_positional_z_is_a_function_of_position():
    cfg = waveglow_init(**TINY_WG)[1]
    src = positional_z(torch.Generator().manual_seed(3), cfg, 2, 100, 0.8)
    a_main, a_early = src(10, 50)
    b_main, b_early = src(30, 70)
    assert torch.equal(a_main[:, :, 20:], b_main[:, :, :30])
    assert torch.equal(a_early[2][:, :, 20:], b_early[2][:, :, :30])
    assert a_early[0] is None and a_main.shape == (2, 6, 50)
    with pytest.raises(ValueError, match="outside"):
        src(90, 20)


def test_stream_tts_matches_offline(two_flows, wg):
    """stream_tts end to end: chunks of 16 frames at max 48; the streamed
    mel equals the offline inference from the stream's own latents, the
    audio one offline vocoder pass with the same positional latents
    within 5e-3 of the scale, n_valid * 256 samples in all."""
    model, tcfg = two_flows[1]
    wg_model, wg_cfg = wg[1]
    _, sids, text = _inputs(1, 48, 10, Tk=6)
    seen = []
    push = StreamingVocoder.push

    def spy(self, mel_chunk):
        seen.append(mel_chunk.clone())
        return push(self, mel_chunk)

    StreamingVocoder.push = spy
    try:
        chunks = list(stream_tts(model, tcfg, wg_model, wg_cfg, 11, _t(sids),
                                 _t(text), chunk_frames=16,
                                 gate_threshold=0.5, max_frames=48,
                                 context=8, lookahead=8))
    finally:
        StreamingVocoder.push = push
    audio = np.concatenate(chunks, axis=1)
    streamed_mel = torch.cat(seen, dim=2)
    n = streamed_mel.shape[2]
    assert audio.shape == (1, n * 256) and np.isfinite(audio).all()

    g_mel, g_voc = stream_generators(11)
    residual = 0.5 * torch.randn(1, 8, 48, generator=g_mel)
    mel, _, nv = flowtron_infer(model, tcfg, residual, _t(sids), _t(text),
                                gate_threshold=0.5)
    assert int(nv[0]) == n
    np.testing.assert_allclose(streamed_mel.numpy(), mel[:, :, :n].numpy(),
                               atol=1e-5)
    z_main, z_early = positional_z(g_voc, wg_cfg, 1, 48 * 32, 0.8)(0, n * 32)
    offline = waveglow_infer_z(wg_model, wg_cfg, streamed_mel, z_main,
                               z_early).numpy()
    assert np.abs(audio - offline).max() / np.abs(offline).max() < 5e-3


@pytest.mark.parametrize("flags", [["--stream", "-d", "0.1"], ["-d", "0.1"]])
def test_cli_stream_and_denoise_write_wav(tmp_path, monkeypatch, flags):
    """--stream writes the wav chunk by chunk (through a StreamingDenoiser
    with -d); -d alone runs the Denoiser on the whole wav."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    rate, frames = _cli_wav(tmp_path, dict(CLI_DIMS, n_mel_channels=80),
                            flags)
    assert rate == 22050 and frames % 256 == 0 and frames > 0


def test_cli_stream_needs_a_vocoder(tmp_path, monkeypatch):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="requires a vocoder"):
        _cli_wav(tmp_path, dict(CLI_DIMS, n_mel_channels=80), ["--stream"],
                 vocoder=False)
