"""The port's checkpoint evaluation (train/evaluate.py,
``flowtron-torch-evaluate``) and tone-CER (data/tone_cer.py) against the
JAX package on the CPU at toy widths.

- Tone-CER: the templates within 1e-6 of JAX's; ``levenshtein``,
  ``cer``, ``decode_mel`` and ``decode_audio`` identical on the same
  inputs; ``tone_cer_report``'s rows identical, the port fed JAX's
  ``jax.random`` latents.
- Evaluation: one ``.pt`` checkpoint read by both packages (JAX's
  ``load_model_for_inference`` reads it through ``warmstart``): nll,
  gate, ctc, the total and the three health means within 1e-5; the
  invertibility oracle within 1e-6 on a given residual; the plots, the
  tone-CER and oracle keys; the CLI's one JSON line; a directory
  that is no checkpoint refused with the reason.
"""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.config import load_config as jax_load_config  # noqa: E402
from flowtron_tpu.data import tone_cer as jax_tone_cer  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.models.flowtron import (  # noqa: E402
    flowtron_test_invertibility as jax_invertibility,
)
from flowtron_tpu.train.evaluate import evaluate as jax_evaluate  # noqa: E402

from flowtron_tpu_torch.audio.stft import MelSpectrogram  # noqa: E402
from flowtron_tpu_torch.cli import evaluate_main  # noqa: E402
from flowtron_tpu_torch.config import load_config  # noqa: E402
from flowtron_tpu_torch.data import tone_cer  # noqa: E402
from flowtron_tpu_torch.data.synth import synth_utterance  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_init, flowtron_test_invertibility,
)
from flowtron_tpu_torch.train.evaluate import evaluate  # noqa: E402
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)
from tests.test_torch_port_trainer_options import short_corpus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(n_speakers=2, n_speaker_dim=4, n_text_dim=12, n_hidden=16,
           n_attn_channels=8)          # 80 mels: the data pipeline's
TEXTS = ("ab", "ka mo", "to", "mi da", "su", "pe", "ri", "no")


# -- tone-CER ----------------------------------------------------------------
@pytest.mark.parametrize("shift", [1.0, 2.0 ** (1 / 8)])
def test_char_templates_match_jax(shift):
    ours = tone_cer.char_templates(pitch_shift=shift)
    ref = jax_tone_cer.char_templates(pitch_shift=shift)
    assert ours.shape == ref.shape == (26, 80)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_levenshtein_and_cer_match_jax():
    pairs = [("", ""), ("abc", ""), ("", "abc"), ("kitten", "sitting"),
             ("ab cd", "abd"), ("tone cer", "tone  cr"), ("aaaa", "a")]
    for a, b in pairs:
        assert tone_cer.levenshtein(a, b) == jax_tone_cer.levenshtein(a, b)
        assert tone_cer.cer(a, b) == jax_tone_cer.cer(a, b)


@pytest.mark.parametrize("sid", [0, 3])
def test_decode_mel_and_audio_match_jax(sid):
    """A coded-tone utterance at speaker ``sid``'s pitch: the same string
    from its audio and from its mel in both packages (and the text read
    back)."""
    shift = tone_cer.corpus_pitch_shift(sid)
    wave, _ = synth_utterance("bad dog", seed=4, pitch_shift=shift)
    ours = tone_cer.decode_audio(wave, pitch_shift=shift)
    assert ours == jax_tone_cer.decode_audio(wave, pitch_shift=shift)
    mel = MelSpectrogram().mel_numpy(wave.astype(np.float32))
    templates = tone_cer.char_templates(pitch_shift=shift)
    assert tone_cer.decode_mel(mel, templates) == \
        jax_tone_cer.decode_mel(mel, templates)
    assert tone_cer.cer(ours, "bad dog") <= 0.3


# -- evaluation --------------------------------------------------------------
@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A short coded-tone corpus (six validation utterances, two
    speakers), config.json at toy widths over it, and one ``.pt``
    checkpoint (the JAX model's weights, heads perturbed) both packages
    read."""
    root = tmp_path_factory.mktemp("evaluate")
    files = short_corpus(str(root), TEXTS, 6, n_speakers=2)
    overrides = [f"data_config.training_files={files[0]}",
                 f"data_config.validation_files={files[1]}",
                 "train_config.batch_size=4",
                 *(f"model_config.{k}={v}" for k, v in TOY.items())]
    cwd = os.getcwd()
    os.chdir(ROOT)                # config.json's cmudict and heteronyms
    try:
        config = load_config("config.json", overrides)
        jax_config = jax_load_config("config.json", overrides)
    finally:
        os.chdir(cwd)
    params, cfg = jax_init(jax.random.PRNGKey(2), n_flows=2, **TOY)
    rng = np.random.default_rng(3)
    for f in params["flows"]:
        for k in ("w", "b"):
            f["conv"][k] = 0.05 * rng.standard_normal(
                f["conv"][k].shape).astype(np.float32)
    params = jax.tree.map(np.asarray, params)
    model, tcfg = flowtron_init(0, n_flows=2, **TOY)
    model.load_state_dict(flowtron_state_dict_from_jax(params), strict=True)
    ckpt = str(root / "model.pt")
    torch.save({"model": model.state_dict()}, ckpt)
    return dict(config=config, jax_config=jax_config, ckpt=ckpt,
                params=params, cfg=cfg, model=model, tcfg=tcfg, root=root,
                overrides=overrides)


def test_evaluate_matches_jax(setup, monkeypatch):
    monkeypatch.chdir(ROOT)
    ref = jax_evaluate(setup["jax_config"], setup["ckpt"],
                       invertibility_frames=0)
    ours = evaluate(setup["config"], setup["ckpt"], invertibility_frames=0,
                    device="cpu")
    assert set(ours) == set(ref)
    for k in ("loss", "nll", "gate", "ctc", "attn_diagonality",
              "attn_monotonicity", "gate_accuracy"):
        assert abs(ours[k] - ref[k]) <= 1e-5 * max(abs(ref[k]), 1e-6), \
            (k, ours[k], ref[k])


def test_invertibility_oracle_matches_jax(setup):
    """Both oracles on the checkpoint's weights and one given residual."""
    rng = np.random.default_rng(3)
    residual = (0.5 * rng.standard_normal((1, 80, 12))).astype(np.float32)
    text, sid = np.asarray([[5, 17, 40, 9]]), np.asarray([1])
    ref = jax.jit(lambda p, r: jax_invertibility(
        p, setup["cfg"], r, jnp.asarray(sid), jnp.asarray(text)))(
        setup["params"], jnp.asarray(residual))
    ours = flowtron_test_invertibility(
        setup["model"], setup["tcfg"], torch.from_numpy(residual),
        torch.from_numpy(sid), torch.from_numpy(text))
    assert abs(float(ours) - float(ref)) <= 1e-6, (float(ours), float(ref))


def _tone_model(setup, letter):
    """The checkpoint's model with its outputs set to one letter's tone:
    flow 0 the identity, flow 1's head a constant (log_s = 6 and the
    bias chosen so that the inverse gives log(template) + z e^-6), its
    gate off. Both packages' copies."""
    params = jax.tree.map(np.array, setup["params"])
    m = np.log(50 * tone_cer.char_templates()[ord(letter) - 97] + 1e-4)
    s = 6.0
    for f in params["flows"]:
        f["conv"]["w"][:] = 0
        f["conv"]["b"][:] = 0
    last = params["flows"][1]
    last["conv"]["b"][:] = np.concatenate(
        [np.full(80, s), -m * np.exp(s)]).astype(np.float32)
    last["gate_layer"]["b"][:] = -20.0
    model, tcfg = flowtron_init(0, n_flows=2, **TOY)
    model.load_state_dict(flowtron_state_dict_from_jax(params), strict=True)
    return params, model, tcfg


def test_tone_cer_report_rows_match_jax_with_its_latents(setup):
    """Two validation transcripts (speakers 0 and 1) synthesized from
    JAX's own draws for seeds 1234 + k (sigma applied by each package) by
    a model that renders the tone of "a", decoded through the mel and
    through Griffin-Lim: every row identical, and the mel decode of
    speaker 0 reads the letter."""
    params, model, tcfg = _tone_model(setup, "a")
    n_frames, seed, kw = 48, 1234, dict(max_texts=2, n_frames=48)
    ref = jax_tone_cer.tone_cer_report(setup["jax_config"], params,
                                       setup["cfg"], seed=seed, **kw)
    latents = [np.array(jax.random.normal(jax.random.PRNGKey(seed + k),
                                          (1, 80, n_frames)))
               for k in range(2)]
    ours = tone_cer.tone_cer_report(setup["config"], model, tcfg, seed=seed,
                                    latents=latents, **kw)
    assert ours["rows"] == ref["rows"]
    assert ours["rows"][0]["hyp_mel"] == "a"
    assert ours["rows"][0]["n_frames"] == n_frames
    assert ours["tone_cer"] == ref["tone_cer"]
    assert ours["tone_cer_mel"] == ref["tone_cer_mel"]


def test_evaluate_writes_plots_tone_cer_and_oracle(setup, monkeypatch):
    monkeypatch.chdir(ROOT)
    plots = str(setup["root"] / "plots")
    result = evaluate(setup["config"], setup["ckpt"],
                      invertibility_frames=12, plots_dir=plots,
                      tone_cer_texts=1, device="cpu")
    assert {"tone_cer", "tone_cer_mel", "invertibility_err"} <= set(result)
    assert 0 <= result["invertibility_err"] <= 1e-5
    assert result["tone_cer"] >= 0 and result["tone_cer_mel"] >= 0
    for name in ("attention.png", "gate.png"):
        assert os.path.getsize(os.path.join(plots, name)) > 0


def test_evaluate_cli_prints_one_json_line(setup, monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    assert evaluate_main(["-c", "config.json", "-p", *setup["overrides"],
                          "-f", setup["ckpt"],
                          "--invertibility-frames", "8"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert {"loss", "nll", "gate", "ctc", "gate_accuracy",
            "invertibility_err"} <= set(result)
    assert all(np.isfinite(v) for v in result.values())


def test_evaluate_names_the_pt_only_limit(setup, tmp_path):
    """A JAX pickle loads (tests/test_torch_port_jax_pickle.py), and so do
    the checkpoint directories of both packages
    (tests/test_torch_port_dist_ckpt.py); a directory that is none of
    them is refused, naming the markers it lacks."""
    with pytest.raises(ValueError, match="not a checkpoint directory"):
        evaluate(setup["config"], str(tmp_path), device="cpu")
