"""``flowtron_tpu_torch.cli.train_main`` end to end on the CPU: a
coded-tone corpus, config.json at toy widths through ``-p``, two steps
with TensorBoard on (as every config in the repo has it); the
checkpoint it writes loads into the port's inference path with
strict=True and into the JAX package's ``warmstart`` as a ``.pt``, and a
resumed run carries on from its iteration."""

import json
import os

import numpy as np
import pytest
import jax

torch = pytest.importorskip("torch")

from flowtron_tpu.config import load_config  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.train.checkpoints import (  # noqa: E402
    export_torch_state_dict, warmstart as jax_warmstart,
)

from flowtron_tpu_torch.cli import train_main  # noqa: E402
from flowtron_tpu_torch.data.synth import make_aligned_corpus  # noqa: E402
from flowtron_tpu_torch.infer.sampling import (  # noqa: E402
    load_model_for_inference,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(n_speaker_dim=4, n_text_dim=12, n_hidden=16, n_attn_channels=8)


def _overrides(train_fl, val_fl, out_dir, **extra):
    kv = {"data_config.training_files": train_fl,
          "data_config.validation_files": val_fl,
          "train_config.output_directory": out_dir,
          "train_config.epochs": 1, "train_config.iters_per_checkpoint": 1,
          "train_config.with_tensorboard": True,
          "train_config.batch_size": 2,
          **{f"model_config.{k}": v for k, v in DIMS.items()}, **extra}
    return [f"{k}={v}" for k, v in kv.items()]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_cli")
    train_fl, val_fl = make_aligned_corpus(str(tmp / "corpus"),
                                           n_utterances=6, seed=1,
                                           val_count=2)
    out_dir = str(tmp / "out")
    overrides = _overrides(train_fl, val_fl, out_dir)
    cwd = os.getcwd()
    os.chdir(ROOT)          # config.json's cmudict and heteronyms paths
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("FLOWTRON_PLATFORM", "cpu")
            train_main(["-c", "config.json", "-p", *overrides])
        config = load_config("config.json", overrides)
    finally:
        os.chdir(cwd)
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return config, out_dir, log, (train_fl, val_fl)


def test_two_steps_log_and_checkpoints(run):
    _, out_dir, log, _ = run
    steps = [r for r in log if "loss" in r]
    assert [r["iteration"] for r in steps] == [0, 1]
    assert all(np.isfinite(r[k]) for r in steps
               for k in ("loss", "nll", "gate", "ctc", "grad_norm"))
    assert [r["iteration"] for r in log if "validation" in r] == [0, 1]
    assert sorted(f for f in os.listdir(out_dir) if f.endswith(".pt")) == \
        ["model_0.pt", "model_1.pt"]


def test_train_with_tensorboard_writes_event_file(run):
    """``with_tensorboard: true``: the steps and validations land in
    ``<output_directory>/logs`` (scalars and the attention and gate
    images)."""
    _, out_dir, _, _ = run
    logs = os.path.join(out_dir, "logs")
    files = [f for f in os.listdir(logs) if "tfevents" in f]
    assert len(files) == 1
    assert os.path.getsize(os.path.join(logs, files[0])) > 1000


def test_checkpoint_loads_for_inference_strict(run):
    config, out_dir, _, _ = run
    path = os.path.join(out_dir, "model_1.pt")
    model, _ = load_model_for_inference(config, path)
    saved = torch.load(path, weights_only=True)
    assert saved["iteration"] == 1 and "optimizer" in saved
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    # the fp16_run bf16 policy trained fp32 master weights
    assert all(v.dtype == torch.float32 for v in saved["model"].values())


def test_jax_warmstart_takes_the_checkpoint(run):
    config, out_dir, _, _ = run
    path = os.path.join(out_dir, "model_1.pt")
    params, _ = jax_init(jax.random.PRNGKey(0), **config["model_config"])
    params = jax_warmstart(path, params)
    exported = export_torch_state_dict(params)
    saved = torch.load(path, weights_only=True)["model"]
    assert exported.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(np.asarray(exported[k]), v.numpy())


def test_resume_carries_on_from_the_checkpoint(run, tmp_path, monkeypatch):
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    _, out_dir, _, (train_fl, val_fl) = run
    new_out = str(tmp_path / "resumed")
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        train_main(["-c", "config.json", "-p", *_overrides(
            train_fl, val_fl, new_out, **{
                "train_config.epochs": 2,
                "train_config.checkpoint_path":
                    os.path.join(out_dir, "model_1.pt")})])
    finally:
        os.chdir(cwd)
    with open(os.path.join(new_out, "train_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    assert [r["iteration"] for r in log if "validation" not in r] == [2, 3]
