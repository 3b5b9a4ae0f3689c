"""The port's native (C++) data path against numpy and the JAX package:
its own copy of ``mel.cpp`` built with ``g++`` into a temporary build
directory, ``NativeMel`` against JAX's ``MelSpectrogram.mel_numpy`` and
the port's numpy mel (1e-5, JAX's bar in tests/test_data.py),
``decode_wav`` against scipy bitwise, and ``Data(use_native=True)``
against the port's numpy path and JAX's ``Data``."""

import os
import shutil

import numpy as np
import pytest
from scipy.io import wavfile

torch = pytest.importorskip("torch")

from flowtron_tpu.audio import MelSpectrogram as JaxMel  # noqa: E402
from flowtron_tpu.data import Data as JaxData  # noqa: E402

from flowtron_tpu_torch import native  # noqa: E402
from flowtron_tpu_torch.audio.stft import MelSpectrogram  # noqa: E402
from flowtron_tpu_torch.data.dataset import Data  # noqa: E402
from flowtron_tpu_torch.data.synth import make_aligned_corpus  # noqa: E402
from flowtron_tpu_torch.ops import _build  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """A fresh build directory and no library loaded in this process; the
    test skips, as JAX's does, only when there is no C++ toolchain."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain available")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path / "build"


def test_library_builds_into_the_build_directory(build_dir):
    """Built at first use from the port's own source, into the build
    directory (never into the package), and reused afterwards."""
    assert not native.available()
    assert native.build()
    libs = list(build_dir.glob("mel-*.so"))
    assert len(libs) == 1 and native.available()
    assert _build.build_seconds["mel"] > 0
    assert not list(native.SOURCE.parent.glob("*.so"))
    _build._loaded.clear()
    native.build()                       # a second process: reused
    assert _build.build_seconds["mel"] == 0.0


def test_source_is_the_jax_package_copy():
    """Only the comments differ from flowtron_tpu/native/mel.cpp."""
    def code(path):
        with open(path) as f:
            return [line for line in f if not line.lstrip().startswith("//")]
    assert code(native.SOURCE) == code(
        os.path.join(ROOT, "flowtron_tpu", "native", "mel.cpp"))


@pytest.mark.parametrize("n_samples", [11025, 300, 1])
def test_mel_matches_numpy_and_jax(build_dir, n_samples):
    ours, ref = MelSpectrogram(), JaxMel()
    nm = native.NativeMel(ours.window, ours.mel_basis)
    rng = np.random.default_rng(n_samples)
    audio = (rng.standard_normal(n_samples) * 0.1).astype(np.float32)
    mel = nm(audio)
    np.testing.assert_allclose(mel, ours.mel_numpy(audio), atol=1e-5)
    np.testing.assert_allclose(mel, ref.mel_numpy(audio), atol=1e-5)


def test_decode_wav_matches_scipy_bitwise(build_dir, tmp_path):
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal(5000) * 8000).astype(np.int16)
    path = tmp_path / "x.wav"
    wavfile.write(path, 22050, pcm)
    dec, sr = native.decode_wav(str(path))
    assert sr == 22050 and dec.dtype == np.float32
    np.testing.assert_array_equal(dec, pcm.astype(np.float32))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav" * 10)
    with pytest.raises(ValueError, match="unsupported wav"):
        native.decode_wav(str(bad))


def test_dataset_use_native_matches_numpy_and_jax(build_dir, tmp_path,
                                                  monkeypatch):
    """``Data(use_native=True)`` loads the library (``_native_mel`` is
    set, so no numpy fallback hides here) and gives the numpy path's and
    JAX's items: speaker and text identical, mel within 1e-5 plus 1e-5 of
    the value. On coded tones the C++ float32 FFT lies several 1e-5 from
    numpy in the quietest bins (chip_smoke.py's ``native_mel`` prints the
    largest), above JAX's 1e-5 bar, which was set on white noise (the
    case above); the same source in the JAX package gives the same
    mels."""
    train_fl, _ = make_aligned_corpus(str(tmp_path / "corpus"),
                                      n_utterances=3, seed=4)
    monkeypatch.chdir(ROOT)
    kw = dict(p_arpabet=0.0, cmudict_path="data/cmudict_dictionary")
    nat = Data(train_fl, use_native=True, **kw)
    assert nat._native_mel is not None and nat._native_decode is not None
    plain = Data(train_fl, **kw)
    assert plain._native_mel is None
    ref = JaxData(train_fl, **kw)
    for i in range(len(nat)):
        a, b, r = nat[i], plain[i], ref[i]
        np.testing.assert_allclose(a[0], b[0], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(a[0], r[0], atol=1e-5, rtol=1e-5)
        assert a[1] == b[1] == r[1]
        np.testing.assert_array_equal(a[2], r[2])


def test_dataset_falls_back_to_numpy_when_the_build_fails(build_dir,
                                                          tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """No compiler: the reason is printed and numpy runs, as in the JAX
    package."""
    train_fl, _ = make_aligned_corpus(str(tmp_path / "corpus"),
                                      n_utterances=1, seed=5)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    data = Data(train_fl, use_native=True, p_arpabet=0.0)
    assert data._native_mel is None
    assert "native data path unavailable" in capsys.readouterr().out
    assert data[0][0].shape[0] == 80
