"""The port's WaveGlow bias denoiser (flowtron_tpu_torch/vocoder/denoiser.py)
against the JAX package's on a tiny WaveGlow whose zero-init ``end`` convs
are perturbed (at init the sigma-0 bias audio is zero and the denoiser a
no-op): ``bias_spec`` and the denoised audio within 1e-4 of the scale, per
row strengths, and ``StreamingDenoiser`` against JAX's and against the
offline ``Denoiser`` over several chunk splits."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402
from flowtron_tpu.vocoder.denoiser import (  # noqa: E402
    Denoiser as JaxDenoiser, StreamingDenoiser as JaxStreamingDenoiser,
)

from flowtron_tpu_torch.utils.convert import waveglow_from_jax  # noqa: E402
from flowtron_tpu_torch.vocoder.denoiser import (  # noqa: E402
    Denoiser, StreamingDenoiser,
)
from flowtron_tpu_torch.vocoder.waveglow import waveglow_init  # noqa: E402

TINY = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
            n_early_size=2, n_layers=2, n_channels=16, kernel_size=3)


def _close(a, ref, tol):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    err = float(np.abs(a - ref).max()) / max(1e-12, float(np.abs(ref).max()))
    assert err <= tol, err


@pytest.fixture(scope="module")
def denoisers():
    params, cfg = jax_waveglow_init(jax.random.PRNGKey(0), **TINY)
    rng = np.random.default_rng(1)
    for wn in params["wn"]:
        wn["end"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            wn["end"]["w"].shape).astype(np.float32))
    model, tcfg = waveglow_init(**TINY)
    model.load_state_dict(waveglow_from_jax(jax.tree.map(np.asarray, params),
                                            cfg), strict=True)
    return JaxDenoiser(params, cfg, n_mel_channels=8), \
        Denoiser(model, tcfg, n_mel_channels=8)


def _audio(B=2, T=6000, seed=2):
    return (0.3 * np.random.default_rng(seed).standard_normal((B, T))) \
        .astype(np.float32)


def test_bias_spec_matches_jax(denoisers):
    jden, den = denoisers
    assert den.bias_spec.shape == (1, 513, 1)
    assert float(den.bias_spec.abs().max()) > 0     # the heads matter
    _close(den.bias_spec.numpy(), jden.bias_spec, 1e-4)


@pytest.mark.parametrize("strength", [0.0, 0.1, 2.0])
def test_denoised_audio_matches_jax(denoisers, strength):
    jden, den = denoisers
    x = _audio()
    ours = den(torch.from_numpy(x), strength=strength)
    ref = jden(jnp.asarray(x), strength=strength)
    assert ours.shape == (2, 256 * (6000 // 256))
    _close(ours.numpy(), ref, 1e-4)


def test_per_row_strengths_match_rows_alone(denoisers):
    """A (B, 1, 1) strength denoises each row as that row alone (the
    engine's per-request strengths)."""
    _, den = denoisers
    x = torch.from_numpy(_audio())
    both = den(x, strength=torch.tensor([0.0, 1.5])[:, None, None])
    for b, s in enumerate((0.0, 1.5)):
        np.testing.assert_allclose(both[b].numpy(),
                                   den(x[b:b + 1], strength=s)[0].numpy(),
                                   atol=1e-6)
    assert not torch.allclose(both[0], both[1])


@pytest.mark.parametrize("chunks", [[6000], [300, 5700], [1000] * 6,
                                    [511, 1, 2049, 3439]])
def test_streaming_denoiser_matches_jax_and_offline(denoisers, chunks):
    jden, den = denoisers
    x = _audio(B=1)[0]
    outs, jouts = [], []
    sd, jsd = StreamingDenoiser(den, 0.5), JaxStreamingDenoiser(jden, 0.5)
    at = 0
    for n in chunks:
        outs.append(sd.feed(x[at:at + n]))
        jouts.append(jsd.feed(x[at:at + n]))
        at += n
    outs.append(sd.flush())
    jouts.append(jsd.flush())
    ours, ref = np.concatenate(outs), np.concatenate(jouts)
    _close(ours, ref, 1e-4)
    offline = den(torch.from_numpy(x[None]), strength=0.5)[0].numpy()
    _close(ours, offline, 1e-4)
