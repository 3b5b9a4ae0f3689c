"""The trainer's options that the port used to refuse, on the CPU at toy
widths over a coded-tone corpus (config.json through ``-p``-style
overrides):

- ``tone_cer_validation_texts``: each validation synthesizes that many
  validation transcripts, writes ``tone_cer_mel`` into the log's
  validation line and TensorBoard's ``validation/tone_cer_mel``;
- ``profile_dir``: ``torch.profiler`` records steps 10 to 14 into
  ``trace.json``, in a 16-step run and in a 12-step run that ends inside
  the window;
- ``remat`` through ``flowtron-torch-train``; then remat against the
  plain step: the loss and every gradient within 1e-6 relative (fp32 and
  bf16, the Gaussian-mixture head, cumulative attention), and three
  RAdam steps.
"""

import copy
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flowtron_tpu_torch.cli import train_main  # noqa: E402
from flowtron_tpu_torch.config import load_config  # noqa: E402
from flowtron_tpu_torch.data.synth import synth_utterance  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_forward, flowtron_init,
)
from flowtron_tpu_torch.train import logger as port_logger  # noqa: E402
from flowtron_tpu_torch.train.loop import make_train_step, train  # noqa: E402
from flowtron_tpu_torch.train.loss import flowtron_loss  # noqa: E402
from flowtron_tpu_torch.train.radam import RAdam  # noqa: E402
from tests.test_torch_port_train import DIMS, _t, make_batch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(n_speaker_dim=4, n_text_dim=12, n_hidden=16, n_attn_channels=8)


def short_corpus(root, texts, n_val, n_speakers=1):
    """Coded-tone utterances of ``texts`` (a few letters each, ~20-40 mel
    frames, so a step is cheap) under ``root``, speaker ``u %
    n_speakers`` at its corpus pitch; the first ``n_val`` for validation.
    Returns (train filelist, validation filelist)."""
    from scipy.io import wavfile
    lines = []
    for u, text in enumerate(texts):
        sid = u % n_speakers
        wave, _ = synth_utterance(text, seed=u,
                                  pitch_shift=2.0 ** (sid / 8.0))
        path = os.path.join(root, f"utt{u}.wav")
        wavfile.write(path, 22050, (wave * 25000).astype(np.int16))
        lines.append(f"{path}|{text}|{sid}")
    files = []
    for name, part in (("train", lines[n_val:]), ("val", lines[:n_val])):
        files.append(os.path.join(root, f"{name}_filelist.txt"))
        with open(files[-1], "w") as f:
            f.write("\n".join(part) + "\n")
    return tuple(files)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return short_corpus(str(tmp_path_factory.mktemp("options_corpus")),
                        ("ab", "ka", "to", "mi da", "su", "pe"), 2)


def _overrides(corpus, out_dir, **extra):
    train_fl, val_fl = corpus
    kv = {"data_config.training_files": train_fl,
          "data_config.validation_files": val_fl,
          "train_config.output_directory": out_dir,
          "train_config.batch_size": 2, "train_config.fp16_run": False,
          "train_config.with_tensorboard": False,
          **{f"model_config.{k}": v for k, v in TOY.items()}, **extra}
    return [f"{k}={v}" for k, v in kv.items()]


def _train(corpus, out_dir, monkeypatch, **extra):
    """train() on config.json with the overrides; returns the log."""
    monkeypatch.chdir(ROOT)       # config.json's cmudict and heteronyms
    config = load_config("config.json", _overrides(corpus, out_dir, **extra))
    train(config, device="cpu")
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _trace_steps(path):
    """The training steps a Chrome trace saw: the iterations whose
    ``Optimizer.step`` it holds, counted."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events]
    return sum(n.startswith("Optimizer.step") for n in names), names


@pytest.mark.parametrize("option", ["tone_cer", "profile_dir",
                                    "profile_dir_ends_inside", "remat"])
def test_formerly_refused_option_runs(option, corpus, tmp_path,
                                      monkeypatch):
    out_dir = str(tmp_path / "out")
    if option == "tone_cer":
        tags = []
        monkeypatch.setattr(port_logger.FlowtronLogger, "add_scalar",
                            lambda self, tag, value, step:
                            tags.append((tag, step, value)))
        log = _train(corpus, out_dir, monkeypatch, **{
            "train_config.epochs": 1, "train_config.iters_per_checkpoint": 1,
            "train_config.tone_cer_validation_texts": 1,
            "train_config.with_tensorboard": True})
        vals = [r["validation"] for r in log if "validation" in r]
        assert len(vals) == 2
        assert all(np.isfinite(v["tone_cer_mel"]) and v["tone_cer_mel"] >= 0
                   for v in vals)
        logged = [(s, v) for t, s, v in tags
                  if t == "validation/tone_cer_mel"]
        assert logged == [(i, v["tone_cer_mel"]) for i, v in enumerate(vals)]
    elif option.startswith("profile_dir"):
        prof = str(tmp_path / "prof")
        epochs = 8 if option == "profile_dir" else 6    # 2 steps an epoch
        log = _train(corpus, out_dir, monkeypatch, **{
            "train_config.epochs": epochs,
            "train_config.iters_per_checkpoint": 1000,
            "train_config.profile_dir": prof})
        assert len([r for r in log if "loss" in r]) == 2 * epochs
        n_steps, names = _trace_steps(os.path.join(prof, "trace.json"))
        # steps 10..14, or 10..11 where the run ends inside the window
        assert n_steps == (5 if option == "profile_dir" else 2), n_steps
        assert any(n.startswith("aten::") for n in names)
    else:
        monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
        monkeypatch.chdir(ROOT)
        train_main(["-c", "config.json", "-p", *_overrides(
            corpus, out_dir, **{"train_config.epochs": 1,
                                "train_config.iters_per_checkpoint": 1,
                                "train_config.remat": True})])
        with open(os.path.join(out_dir, "train_log.jsonl")) as f:
            steps = [r for r in map(json.loads, f) if "loss" in r]
        assert len(steps) == 2 and all(np.isfinite(r["loss"])
                                       for r in steps)


# -- remat against the plain step -------------------------------------------
REMAT_CASES = {"fp32": {}, "bf16": {}, "gm": dict(n_components=3,
                                                  mean_scale=2.0),
               "cumm": dict(use_cumm_attention=True)}


def _perturbed(**kw):
    model, cfg = flowtron_init(0, n_flows=2, **DIMS, **kw)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for f in (model.flows[0], model.flows[1].ar_step):
            f.conv.weight.normal_(0, 0.05, generator=g)
            f.conv.bias.normal_(0, 0.05, generator=g)
    return model, cfg


@pytest.mark.parametrize("case", sorted(REMAT_CASES))
def test_remat_gives_the_plain_loss_and_gradients(case):
    """Training mode (encoder dropout on, from one seeded generator for
    both runs) with the prior and CTC: the loss and each parameter's
    gradient within 1e-6 of the plain step's, relative to the largest."""
    kw = REMAT_CASES[case]
    batch = {k: _t(v) for k, v in make_batch(seed=11).items()}
    dtype = torch.bfloat16 if case == "bf16" else None
    runs = []
    for remat in (False, True):
        model, cfg = _perturbed(**kw)
        out = flowtron_forward(
            model, cfg, *(batch[k] for k in ("mel", "speaker_ids", "text",
                                             "in_lens", "out_lens")),
            attn_prior=batch["attn_prior"], train=True,
            generator=torch.Generator().manual_seed(5),
            compute_dtype=dtype, remat=remat)
        losses = flowtron_loss(out, batch["gate_target"], batch["in_lens"],
                               batch["out_lens"],
                               gm_loss="n_components" in kw,
                               use_ctc_loss=True, blank_logprob=-8.0)
        total = sum(losses)
        total.backward()
        runs.append((float(total), {n: p.grad.clone() for n, p in
                                    model.named_parameters()}))
    (loss, grads), (loss_r, grads_r) = runs
    assert abs(loss_r - loss) <= 1e-6 * abs(loss)
    assert set(grads) == set(grads_r)
    for name, g in grads.items():
        scale = max(float(g.abs().max()), 1e-12)
        err = float((grads_r[name] - g).abs().max())
        assert err <= 1e-6 * scale, (name, err, scale)


def test_remat_three_radam_steps_equal_the_plain_steps():
    batch = {k: _t(v) for k, v in make_batch(seed=12).items()}
    base, cfg = _perturbed()
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        params = list(model.parameters())
        step = make_train_step(model, cfg, RAdam(params, lr=1e-3), params,
                               {"sigma": 1.0, "use_ctc_loss": True,
                                "grad_clip_val": 1.0, "remat": remat})
        losses = [float(step(batch, None, torch.tensor(1.0),
                             torch.tensor(1.0))["loss"]) for _ in range(3)]
        runs.append((losses, model.state_dict()))
    (losses, sd), (losses_r, sd_r) = runs
    np.testing.assert_allclose(losses_r, losses, rtol=1e-6)
    for name, v in sd.items():
        scale = max(float(v.abs().max()), 1e-12)
        assert float((sd_r[name] - v).abs().max()) <= 1e-6 * scale, name
