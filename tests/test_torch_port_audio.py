"""The port's STFT, inverse STFT and Griffin-Lim (flowtron_tpu_torch/audio/)
against the JAX package on the same numpy-drawn audio and magnitudes:
framing, magnitude and log-mel, the window envelope, overlap-add and the
inverse STFT within 1e-5 of the output scale; the numpy Griffin-Lim and
the vocoder-less CLI's mel inversion within 1e-6; the tensor Griffin-Lim
from the same initial phases within 1e-4; a one-frame mel is silence."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.audio.griffin_lim import (  # noqa: E402
    InverseSTFT as JaxInverseSTFT, _overlap_add as jax_overlap_add,
    griffin_lim as jax_griffin_lim, griffin_lim_numpy as jax_gl_numpy,
    window_sumsquare as jax_window_sumsquare,
)
from flowtron_tpu.audio.stft import (  # noqa: E402
    MelSpectrogram as JaxMelSpectrogram, _frame_signal as jax_frame_signal,
)
from flowtron_tpu.infer.sampling import (  # noqa: E402
    mel_to_audio_griffinlim as jax_mel_to_audio,
)

from flowtron_tpu_torch.audio.griffin_lim import (  # noqa: E402
    InverseSTFT, _overlap_add, griffin_lim, griffin_lim_numpy,
    window_sumsquare,
)
from flowtron_tpu_torch.audio.stft import (  # noqa: E402
    MelSpectrogram, _frame_signal, dynamic_range_compression,
    dynamic_range_decompression,
)
from flowtron_tpu_torch.infer.sampling import (  # noqa: E402
    mel_to_audio_griffinlim,
)

DATA = {"sampling_rate": 22050, "filter_length": 1024, "hop_length": 256,
        "win_length": 1024, "mel_fmin": 0.0, "mel_fmax": 8000.0}


def _audio(B=2, T=4000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 22050
    sig = 0.4 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal((B, T))
    return np.clip(sig, -1, 1).astype(np.float32)


def _close(a, ref, tol):
    """max |a - ref| within ``tol`` of ref's largest magnitude."""
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    scale = max(1e-12, float(np.abs(ref).max()))
    err = float(np.abs(a - ref).max()) / scale
    assert err <= tol, err


@pytest.mark.parametrize("T", [1, 300, 1024, 4000, 4097])
@pytest.mark.parametrize("fl,hop", [(1024, 256), (800, 200), (64, 24)])
def test_frame_signal_matches_jax(T, fl, hop):
    """Frames of the reflect-padded signal, bitwise, also for signals
    shorter than the pad and hops that do not divide the frame."""
    x = _audio(T=T)
    ours = _frame_signal(torch.from_numpy(x), fl, hop)
    ref = np.asarray(jax_frame_signal(jnp.asarray(x), fl, hop))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("cfg", [{}, {"filter_length": 512,
                                      "hop_length": 128, "win_length": 400,
                                      "n_mel_channels": 40}])
def test_mel_spectrogram_matches_jax(cfg):
    x = _audio()
    ours, ref = MelSpectrogram(**cfg), JaxMelSpectrogram(**cfg)
    _close(ours.magnitude(torch.from_numpy(x)).numpy(),
           ref.magnitude(jnp.asarray(x)), 1e-5)
    _close(ours(torch.from_numpy(x)).numpy(), ref(jnp.asarray(x)), 1e-5)
    mag = np.abs(np.random.default_rng(1).standard_normal(
        (2, ours.filter_length // 2 + 1, 9))).astype(np.float32)
    _close(ours.mel_from_magnitude(torch.from_numpy(mag)).numpy(),
           ref.mel_from_magnitude(jnp.asarray(mag)), 1e-5)
    np.testing.assert_array_equal(ours.mel_numpy(x[0]),
                                  ref.mel_numpy(x[0]))


def test_dynamic_range_round_trip():
    x = torch.tensor([0.0, 1e-6, 0.5, 2.0])
    y = dynamic_range_compression(x)
    np.testing.assert_allclose(y.numpy(), np.log(np.clip(x.numpy(), 1e-5,
                                                         None)), rtol=1e-6)
    np.testing.assert_allclose(dynamic_range_decompression(y).numpy(),
                               np.clip(x.numpy(), 1e-5, None), rtol=1e-6)


@pytest.mark.parametrize("n_frames", [1, 2, 17])
@pytest.mark.parametrize("fl,hop,wl", [(1024, 256, 1024), (800, 200, 600)])
def test_window_sumsquare_and_overlap_add_match_jax(n_frames, fl, hop, wl):
    np.testing.assert_array_equal(
        window_sumsquare(wl, fl, hop, n_frames),
        jax_window_sumsquare(wl, fl, hop, n_frames))
    frames = np.random.default_rng(n_frames).standard_normal(
        (2, n_frames, fl)).astype(np.float32)
    _close(_overlap_add(torch.from_numpy(frames), fl, hop).numpy(),
           jax_overlap_add(jnp.asarray(frames), fl, hop), 1e-6)


@pytest.mark.parametrize("fl,hop,wl", [(1024, 256, 1024), (512, 128, 400)])
def test_inverse_stft_matches_jax(fl, hop, wl):
    rng = np.random.default_rng(2)
    mag = np.abs(rng.standard_normal((2, fl // 2 + 1, 12))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
    ours = InverseSTFT(fl, hop, wl)(torch.from_numpy(mag),
                                    torch.from_numpy(phase))
    ref = JaxInverseSTFT(fl, hop, wl)(jnp.asarray(mag), jnp.asarray(phase))
    assert ours.shape == (2, hop * 11)
    _close(ours.numpy(), ref, 1e-5)


def test_one_instance_over_several_lengths_matches_jax():
    """The window, mel basis, reflect index and window-sumsquare
    normalisation are built once and kept: one MelSpectrogram and one
    InverseSTFT, called at lengths that come and go back, still agree
    with JAX at each."""
    ms, jms = MelSpectrogram(), JaxMelSpectrogram()
    istft, jistft = InverseSTFT(), JaxInverseSTFT()
    rng = np.random.default_rng(3)
    for T, n_frames in [(4000, 12), (1500, 5), (4000, 12), (1500, 3)]:
        x = _audio(T=T, seed=T)
        _close(ms(torch.from_numpy(x)).numpy(), jms(jnp.asarray(x)), 1e-5)
        mag = np.abs(rng.standard_normal((2, 513, n_frames))).astype(
            np.float32)
        phase = rng.uniform(-np.pi, np.pi, mag.shape).astype(np.float32)
        _close(istft(torch.from_numpy(mag), torch.from_numpy(phase)).numpy(),
               jistft(jnp.asarray(mag), jnp.asarray(phase)), 1e-5)


def test_griffin_lim_from_the_same_phases_matches_jax():
    """The tensor Griffin-Lim from JAX's own initial phases, 8 iterations,
    within 1e-4 of the output scale."""
    x = _audio(T=5120, seed=3)
    ms, jms = MelSpectrogram(), JaxMelSpectrogram()
    mag = np.asarray(jms.magnitude(jnp.asarray(x)))
    key = jax.random.PRNGKey(4)
    angles = np.asarray(jax.random.uniform(key, mag.shape, minval=-np.pi,
                                           maxval=np.pi))
    jistft, istft = JaxInverseSTFT(), InverseSTFT()

    def jax_forward(s):
        frames = jax_frame_signal(s, 1024, 256)
        return jnp.fft.rfft(frames * jms.window[None, None, :],
                            axis=-1).swapaxes(1, 2)

    ref = jax_griffin_lim(jnp.asarray(mag), jax_forward, jistft, n_iters=8,
                          key=key)
    mag = np.array(mag)
    ours = griffin_lim(torch.from_numpy(mag), ms.stft, istft, n_iters=8,
                       angles=torch.from_numpy(angles))
    _close(ours.numpy(), ref, 1e-4)
    # without angles: a seeded draw, the same on every call
    a = griffin_lim(torch.from_numpy(mag), ms.stft, istft, n_iters=1,
                    generator=torch.Generator().manual_seed(5))
    b = griffin_lim(torch.from_numpy(mag), ms.stft, istft, n_iters=1,
                    generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("n_frames", [1, 2, 3, 12])
def test_griffin_lim_numpy_matches_jax(n_frames):
    mags = np.random.default_rng(n_frames).uniform(
        0, 1, (513, n_frames)).astype(np.float32)
    ours = griffin_lim_numpy(mags, n_iters=3, seed=1)
    ref = jax_gl_numpy(mags, n_iters=3, seed=1)
    assert ours.shape == ref.shape == (256 * (n_frames - 1),)
    if n_frames > 1:
        _close(ours, ref, 1e-6)


def test_mel_to_audio_griffinlim_matches_jax():
    mel = (np.random.default_rng(6).standard_normal((80, 10)) - 4.0) \
        .astype(np.float32)
    ours = mel_to_audio_griffinlim(mel, DATA, n_iters=4)
    ref = jax_mel_to_audio(mel, DATA, n_iters=4)
    assert ours.shape == (9 * 256,)
    _close(ours, ref, 1e-6)


def test_one_frame_mel_is_silence():
    mel = np.full((80, 1), -3.0, np.float32)
    audio = mel_to_audio_griffinlim(mel, DATA, n_iters=1)
    assert audio.shape == (256,) and np.all(audio == 0)
