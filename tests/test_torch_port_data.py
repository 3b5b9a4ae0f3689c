"""The port's host data pipeline against the JAX package's: the numpy
log-mel, the beta-binomial prior, Data (text ids with the same seeded
ARPAbet draws, speakers, priors), DataCollate, BatchIterator and the
coded-tone corpus generator."""

import filecmp
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flowtron_tpu.audio import MelSpectrogram as JaxMel  # noqa: E402
from flowtron_tpu.audio import mel_filterbank as jax_filterbank  # noqa: E402
from flowtron_tpu.data import (  # noqa: E402
    BatchIterator as JaxBatchIterator, Data as JaxData,
    DataCollate as JaxCollate,
)
from flowtron_tpu.data.dataset import data_kwargs as jax_data_kwargs  # noqa: E402
from flowtron_tpu.data.prior import beta_binomial_prior as jax_prior  # noqa: E402
from flowtron_tpu.data.synth import make_aligned_corpus as jax_corpus  # noqa: E402

from flowtron_tpu_torch.audio.mel import mel_filterbank  # noqa: E402
from flowtron_tpu_torch.audio.stft import MelSpectrogram  # noqa: E402
from flowtron_tpu_torch.data.collate import (  # noqa: E402
    BatchIterator, DataCollate, PrefetchIterator,
)
from flowtron_tpu_torch.data.dataset import Data, data_kwargs  # noqa: E402
from flowtron_tpu_torch.data.prior import beta_binomial_prior  # noqa: E402
from flowtron_tpu_torch.data.synth import make_aligned_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_CFG = dict(p_arpabet=0.5, cmudict_path="", heteronyms_path="",
                use_attn_prior=True, attn_prior_threshold=0.0,
                betab_scaling_factor=1.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    train_fl, val_fl = make_aligned_corpus(str(root), n_utterances=8,
                                           n_speakers=2, seed=3, val_count=2)
    return str(root), train_fl, val_fl


def test_corpus_wavs_byte_identical_to_jax(corpus, tmp_path):
    root, train_fl, val_fl = corpus
    jax_root = str(tmp_path / "jax")
    j_train, j_val = jax_corpus(jax_root, n_utterances=8, n_speakers=2,
                                seed=3, val_count=2)
    names = sorted(f for f in os.listdir(root) if f.endswith(".wav"))
    assert names == sorted(f for f in os.listdir(jax_root)
                           if f.endswith(".wav"))
    for name in names:
        assert filecmp.cmp(os.path.join(root, name),
                           os.path.join(jax_root, name), shallow=False)
    for ours, theirs in ((train_fl, j_train), (val_fl, j_val)):
        with open(ours) as a, open(theirs) as b:
            assert a.read().replace(root, "R") == \
                b.read().replace(jax_root, "R")


def test_filterbank_identical():
    np.testing.assert_array_equal(
        mel_filterbank(22050, 1024, 80, 0.0, 8000.0),
        jax_filterbank(22050, 1024, 80, 0.0, 8000.0))


@pytest.mark.parametrize("n_samples", [22050, 12345])
def test_mel_matches_jax_mel_numpy(corpus, n_samples):
    from scipy.io import wavfile
    root = corpus[0]
    _, wav = wavfile.read(os.path.join(root, "utt0000.wav"))
    audio = (wav[:n_samples] / 32768.0).astype(np.float32)
    ours = MelSpectrogram().mel_numpy(audio)
    ref = JaxMel().mel_numpy(audio)
    assert ours.shape == ref.shape == (80, len(audio) // 256 + 1)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("P,M,scale", [(7, 40, 1.0), (64, 320, 1.0),
                                       (12, 30, 0.5)])
def test_prior_matches_jax(P, M, scale):
    np.testing.assert_allclose(beta_binomial_prior(P, M, scale),
                               jax_prior(P, M, scale), atol=1e-6)


def _cfg(p_arpabet, cmudict):
    return dict(DATA_CFG, p_arpabet=p_arpabet, cmudict_path=cmudict)


@pytest.mark.parametrize("p_arpabet", [0.0, 1.0])
def test_data_items_match_jax(corpus, mini_cmudict, p_arpabet):
    """Same filelist order, ids (ARPAbet drawn from the same seeded
    stream), speaker ids, mel and prior, item by item."""
    _, train_fl, _ = corpus
    ours = Data(train_fl, **_cfg(p_arpabet, mini_cmudict))
    ref = JaxData(train_fl, **_cfg(p_arpabet, mini_cmudict))
    assert ours.audiopaths_and_text == ref.audiopaths_and_text
    assert ours.speaker_ids == ref.speaker_ids
    assert len(ours) == len(ref) == 6
    for i in range(len(ours)):
        mel, sid, ids, prior = ours[i]
        r_mel, r_sid, r_ids, r_prior = ref[i]
        np.testing.assert_array_equal(ids, r_ids)
        assert sid == r_sid
        np.testing.assert_allclose(mel, r_mel, atol=1e-5)
        np.testing.assert_allclose(prior, r_prior, atol=1e-6)


def test_collate_and_batch_order_identical(corpus):
    _, train_fl, _ = corpus
    ours = Data(train_fl, **DATA_CFG)
    ref = JaxData(train_fl, **DATA_CFG)
    for ptm in (1, 32):
        a = list(BatchIterator(ours, 4, DataCollate(use_attn_prior=True,
                                                    pad_to_multiple=ptm),
                               seed=7, drop_last=False))
        b = list(JaxBatchIterator(ref, 4, JaxCollate(use_attn_prior=True,
                                                     pad_to_multiple=ptm),
                                  seed=7, drop_last=False))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_allclose(x[k], y[k], atol=1e-5, err_msg=k)


def test_prefetch_iterator_yields_and_reraises():
    assert list(PrefetchIterator(range(5))) == list(range(5))

    def boom():
        yield 1
        raise ValueError("producer failed")

    it = iter(PrefetchIterator(boom()))
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)


def test_data_kwargs_match_jax_and_refuse_typos():
    import json
    with open(os.path.join(ROOT, "config.json")) as f:
        data_config = json.load(f)["data_config"]
    assert data_kwargs(data_config) == jax_data_kwargs(data_config)
    with pytest.raises(TypeError, match="hop_lenght"):
        data_kwargs(dict(data_config, hop_lenght=512))

