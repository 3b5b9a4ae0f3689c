"""The port's TensorBoard logger (flowtron_tpu_torch/train/logger.py) and
its validation metrics (train/evaluate.py) on the CPU: the three metrics
equal the JAX package's, scalars and images reach an event file (from
tensors as the loop hands them over). ``train_main`` with
``with_tensorboard: true`` is tested in test_torch_port_train_cli.py,
whose training run has it on."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from flowtron_tpu.train import evaluate as jax_evaluate  # noqa: E402

from flowtron_tpu_torch.train import evaluate  # noqa: E402
from flowtron_tpu_torch.train.logger import (  # noqa: E402
    FlowtronLogger, plot_alignment_to_numpy, plot_gate_outputs_to_numpy,
)


def _validation_outputs(seed, B=3, T=12, Tk=7):
    rng = np.random.default_rng(seed)
    attn = rng.uniform(size=(B, T, Tk))
    for b in range(B):           # one near-diagonal stream
        if b == 0:
            attn[b] = np.exp(-((np.arange(T)[:, None] * (Tk - 1) / (T - 1)
                                - np.arange(Tk)[None, :]) ** 2))
    gate = rng.standard_normal((T, B, 1))
    target = (np.arange(T)[None, :] >= np.array([[11], [8], [5]])) \
        .astype(np.float32)
    return attn, gate, target, np.array([12, 9, 1]), np.array([7, 5, 3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    attn, gate, target, out_lens, in_lens = _validation_outputs(seed)
    for name in ("attention_diagonality", "attention_monotonicity"):
        assert getattr(evaluate, name)(attn, out_lens, in_lens) == \
            getattr(jax_evaluate, name)(attn, out_lens, in_lens)
    assert evaluate.gate_accuracy(gate, target, out_lens) == \
        jax_evaluate.gate_accuracy(gate, target, out_lens)
    y = np.random.default_rng(seed).standard_normal(20)
    np.testing.assert_array_equal(evaluate._isotonic_increasing(y),
                                  jax_evaluate._isotonic_increasing(y))


def test_plots_are_images():
    img = plot_alignment_to_numpy(np.random.default_rng(0).uniform(
        size=(7, 12)))
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8
    img = plot_gate_outputs_to_numpy(np.zeros(12), np.full(12, 0.3))
    assert img.ndim == 3 and img.shape[2] == 3


def test_scalars_and_images_written(tmp_path):
    logdir = str(tmp_path / "tb")
    logger = FlowtronLogger(logdir)
    logger.log_training(1.5, 0.1, 1.2, 0.2, 1e-3, iteration=3)
    attn, gate, target, out_lens, in_lens = _validation_outputs(0)
    last = {"attn": torch.from_numpy(attn).float(),
            "gate_pred": torch.from_numpy(gate).float(),
            "batch": {"out_lens": out_lens, "in_lens": in_lens,
                      "gate_target": target}}
    logger.log_validation(1.4, 1.1, 0.1, 0.2, last, iteration=3)
    logger.log_validation(1.0, 0.8, 0.1, 0.1, None, iteration=4)
    logger.writer.flush()
    assert {"training/loss", "learning_rate", "validation/loss",
            "validation/attn_diagonality", "validation/attn_monotonicity",
            "validation/gate_accuracy"} <= logger._scalar_tags
    files = [f for f in os.listdir(logdir) if "tfevents" in f]
    assert len(files) == 1
    # the two images make the event file non-trivial
    assert os.path.getsize(os.path.join(logdir, files[0])) > 1000


def test_logger_refuses_without_tensorboardx(tmp_path, monkeypatch):
    from flowtron_tpu_torch.train import logger as logger_module
    monkeypatch.setattr(logger_module, "SummaryWriter", None)
    with pytest.raises(RuntimeError, match="tensorboardX"):
        FlowtronLogger(str(tmp_path))
