"""TensorBoard logging of training and validation (port of
flowtron_tpu/train/logger.py; reference:flowtron_logger.py:24-54,
flowtron_plotting_utils.py:23-62): the loss scalars each step, and at
validation the losses, the alignment and gate metrics of
``train/evaluate.py``, and attention and gate plots of a random
validation element.

Needs tensorboardX (the writer) and matplotlib (the plots), as the JAX
package does; without tensorboardX the logger raises instead of logging
nowhere.
"""

import numpy as np
import torch

from flowtron_tpu_torch.train.evaluate import (
    attention_diagonality, attention_monotonicity, gate_accuracy,
)

try:
    from tensorboardX import SummaryWriter
except ImportError:  # pragma: no cover
    SummaryWriter = None


def _numpy(x):
    """A tensor (on any device) or array-like -> numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _figure_to_numpy(fig, plt):
    fig.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return data


def plot_alignment_to_numpy(alignment):
    """(T_text, T_mel) alignment -> HWC uint8 image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 4))
    im = ax.imshow(alignment, aspect="auto", origin="lower",
                   interpolation="none")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("Decoder timestep")
    ax.set_ylabel("Encoder timestep")
    return _figure_to_numpy(fig, plt)


def plot_gate_outputs_to_numpy(gate_targets, gate_outputs):
    """Targets and predicted gate probabilities over frames -> HWC uint8
    image."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(6, 3))
    ax.scatter(range(len(gate_targets)), gate_targets, alpha=0.5,
               color="green", marker="+", s=1, label="target")
    ax.scatter(range(len(gate_outputs)), gate_outputs, alpha=0.5,
               color="red", marker=".", s=1, label="predicted")
    ax.set_xlabel("Frames")
    ax.set_ylabel("Gate state")
    return _figure_to_numpy(fig, plt)


class FlowtronLogger:
    def __init__(self, logdir):
        if SummaryWriter is None:
            raise RuntimeError("tensorboardX is not available")
        self.writer = SummaryWriter(logdir)
        self._scalar_tags = set()   # tags written so far (introspection)

    def add_scalar(self, tag, value, step):
        self._scalar_tags.add(tag)
        self.writer.add_scalar(tag, value, step)

    def log_training(self, loss, gate_loss, nll_loss, ctc_loss,
                     learning_rate, iteration):
        self.add_scalar("training/loss", loss, iteration)
        self.add_scalar("training/loss_gate", gate_loss, iteration)
        self.add_scalar("training/loss_nll", nll_loss, iteration)
        self.add_scalar("training/loss_ctc", ctc_loss, iteration)
        self.add_scalar("learning_rate", learning_rate, iteration)

    def log_validation(self, loss, nll, gate, ctc, last_outputs, iteration):
        """``last_outputs``: the last validation batch's ``attn`` (B, T,
        Tk) and ``gate_pred`` (T, B, 1) (tensors or arrays) and its host
        ``batch`` (``out_lens``, ``in_lens``, ``gate_target``), or None."""
        self.add_scalar("validation/loss", loss, iteration)
        self.add_scalar("validation/loss_nll", nll, iteration)
        self.add_scalar("validation/loss_gate", gate, iteration)
        self.add_scalar("validation/loss_ctc", ctc, iteration)
        if last_outputs is None:
            return
        attn = last_outputs.get("attn")
        attn = None if attn is None else _numpy(attn)
        gate_pred = last_outputs.get("gate_pred")
        gate_pred = None if gate_pred is None else _numpy(gate_pred)
        vbatch = last_outputs.get("batch") or {}
        if (attn is not None and attn.ndim == 3
                and vbatch.get("out_lens") is not None):
            o, i = vbatch["out_lens"], vbatch["in_lens"]
            self.add_scalar("validation/attn_diagonality",
                            attention_diagonality(attn, o, i), iteration)
            self.add_scalar("validation/attn_monotonicity",
                            attention_monotonicity(attn, o, i), iteration)
            if (gate_pred is not None
                    and vbatch.get("gate_target") is not None):
                self.add_scalar(
                    "validation/gate_accuracy",
                    gate_accuracy(gate_pred, vbatch["gate_target"], o),
                    iteration)
        if attn is not None and attn.ndim == 3:
            idx = np.random.randint(attn.shape[0])
            self.writer.add_image(
                "attention_weights", plot_alignment_to_numpy(attn[idx].T),
                iteration, dataformats="HWC")
        if gate_pred is not None:
            idx = np.random.randint(gate_pred.shape[1])
            probs = 1.0 / (1.0 + np.exp(-gate_pred[:, idx, 0]))
            targets = (np.asarray(vbatch["gate_target"])[idx, :len(probs)]
                       if vbatch.get("gate_target") is not None
                       else np.zeros_like(probs))
            self.writer.add_image(
                "gate", plot_gate_outputs_to_numpy(targets, probs),
                iteration, dataformats="HWC")
