"""Entry points of the port (counterpart of __graft_entry__.py):
the flagship forward and loss on the card, and a multi-process dry run on
the CPU.

    python -m flowtron_tpu_torch.entry [N]     # dryrun_multichip(N), N=2

``entry()`` gives ``(fn, example_args)``: ``fn`` is one teacher-forced
forward of the flagship model (LJS, 2 flows, n_hidden 1024) and its total
loss (nll + gate + 0.01 ctc), ``example_args`` the model and a B=4,
T=128, Tk=48 batch, on the card (``utils/device.py``).

``dryrun_multichip(n)`` runs one training step and one inference +
vocoder pass over ``n`` gloo ranks on the CPU, at the JAX dry run's tiny
dims, on the JAX dry run's grid (``dryrun_layout``: (2, n/4, 2) dcn x data
x model when 8 divides n, (n/2, 2) data x model for another even n >= 4,
else n data): the batch split over the batch axes, the large weights
sharded over ``model`` (parallel/tensor_parallel.py). It prints its two
lines in the JAX dry run's shape. The inference pass runs each batch
shard's rows on whole weights gathered in its model group.
"""

import contextlib
import math
import sys

import numpy as np
import torch

FULL = dict(n_speakers=1, n_speaker_dim=128, n_text=185, n_text_dim=512,
            n_mel_channels=80, n_hidden=1024, n_attn_channels=640,
            n_lstm_layers=2, mel_encoder_n_hidden=512)
TINY = dict(n_speakers=2, n_speaker_dim=8, n_text=185, n_text_dim=16,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)
TRAIN_CFG = {"sigma": 1.0, "gate_loss": True, "use_ctc_loss": True,
             "blank_logprob": -8, "grad_clip_val": 1.0}


def make_batch(B, T, Tk, M, seed=0):
    """The JAX dry run's batch (``__graft_entry__.py:_batch``), numpy."""
    rng = np.random.default_rng(seed)
    out_lens = rng.integers(max(2, T - 4), T + 1, B)
    in_lens = rng.integers(max(2, Tk - 2), Tk + 1, B)
    gate = np.zeros((B, T), np.float32)
    for b in range(B):
        gate[b, out_lens[b] - 1:] = 1
    prior = rng.uniform(0.05, 1.0, (B, T, Tk)).astype(np.float32)
    prior /= prior.sum(-1, keepdims=True)
    return {
        "mel": rng.standard_normal((B, M, T)).astype(np.float32),
        "speaker_ids": rng.integers(0, 1, B),
        "text": rng.integers(1, 185, (B, Tk)),
        "in_lens": in_lens, "out_lens": out_lens,
        "gate_target": gate, "attn_prior": prior,
    }


def entry(device=None):
    """(fn, example_args): the flagship forward + loss, on the card."""
    from flowtron_tpu_torch.models.flowtron import (
        flowtron_forward, flowtron_init)
    from flowtron_tpu_torch.train.loss import flowtron_loss
    from flowtron_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    model, cfg = flowtron_init(0, n_flows=2, use_gate_layer=True,
                               device=device, **FULL)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(4, 128, 48, 80).items()}

    def fn(model, mel, speaker_ids, text, in_lens, out_lens, gate_target,
           attn_prior):
        out = flowtron_forward(model, cfg, mel, speaker_ids, text, in_lens,
                               out_lens, attn_prior=attn_prior)
        nll, gate, ctc = flowtron_loss(out, gate_target, in_lens, out_lens,
                                       use_ctc_loss=True, blank_logprob=-8)
        return nll + gate + 0.01 * ctc

    return fn, (model, batch["mel"], batch["speaker_ids"], batch["text"],
                batch["in_lens"], batch["out_lens"], batch["gate_target"],
                batch["attn_prior"])


def dryrun_layout(n):
    """The JAX dry run's grid for n devices (``__graft_entry__.py``):
    (shape, axis names)."""
    if n % 8 == 0:
        return (2, n // 4, 2), ("dcn", "data", "model")
    if n % 2 == 0 and n >= 4:
        return (n // 2, 2), ("data", "model")
    return (n,), ("data",)


def dryrun_rank(B=8, T=12, Tk=5):
    """One rank of ``dryrun_multichip``: a training step on its batch
    shard's rows of the global batch, then inference and vocoding of
    them. Returns the rank's numbers; rank 0 prints the two lines."""
    from flowtron_tpu_torch.models.flowtron import (
        flowtron_infer, flowtron_init)
    from flowtron_tpu_torch.parallel.mesh import Grid, rank, world_size
    from flowtron_tpu_torch.parallel.tensor_parallel import TensorParallel
    from flowtron_tpu_torch.train.loop import make_train_step, to_device
    from flowtron_tpu_torch.train.radam import (
        build_optimizer, trainable_parameters)
    from flowtron_tpu_torch.vocoder.waveglow import (
        waveglow_infer, waveglow_init)

    world, me = world_size(), rank()
    shape, names = dryrun_layout(world)
    grid = Grid({"mesh_shape": list(shape), "mesh_axis_names": list(names)})
    b, n_batch = grid.batch_index, grid.n_batch
    cpu = torch.device("cpu")
    rows = slice(b * B // n_batch, (b + 1) * B // n_batch)
    model, cfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **TINY)
    params = [p for _, p in trainable_parameters(model)]
    opt = build_optimizer(params, "RAdam", 1e-3, 1e-6)
    tp = TensorParallel(model, opt, grid) if grid.model_size > 1 else None
    if tp is not None:
        params = tp.parameters()
    step = make_train_step(model, cfg, opt, params, TRAIN_CFG, grid, tp)
    batch = {k: v[rows] for k, v in
             make_batch(B, T, Tk, TINY["n_mel_channels"]).items()}
    g = torch.Generator().manual_seed(1 + b)
    metrics = step(to_device(batch, cpu), g, torch.tensor(0.01),
                   torch.tensor(1.0))
    loss = float(metrics["loss"])
    if me == 0:
        desc = " x ".join(f"{s} {n}" for s, n in zip(shape, names))
        print(f"dryrun_multichip({world}): mesh=({desc}), "
              f"loss={loss:.4f}", flush=True)

    wg, wg_cfg = waveglow_init(2, n_mel_channels=TINY["n_mel_channels"],
                               n_flows=2, n_layers=2, n_channels=16)
    rng = np.random.default_rng(7)
    M = TINY["n_mel_channels"]
    residual = torch.from_numpy(
        (rng.standard_normal((B, M, T)) * 0.5).astype(np.float32))[rows]
    text = torch.from_numpy(rng.integers(1, 185, (B, Tk)))[rows]
    whole = contextlib.nullcontext() if tp is None else tp.gathered()
    with torch.no_grad(), whole:
        mel, _, n_valid = flowtron_infer(
            model, cfg, residual, torch.zeros(len(text), dtype=torch.long),
            text, gate_threshold=0.5)
        audio = waveglow_infer(wg, wg_cfg, mel, sigma=0.8, seed=3 + b)
    stats = dict(loss=loss, mel_mean=float(mel.mean()),
                 mel_std=float(mel.std()), audio_shape=tuple(audio.shape),
                 audio_std=float(audio.std()),
                 min_n_valid=int(n_valid.min()))
    if me == 0:
        print(f"dryrun_multichip({world}) infer: mel mean="
              f"{stats['mel_mean']:.4f} std={stats['mel_std']:.4f}, "
              f"audio={stats['audio_shape']} std={stats['audio_std']:.4f}, "
              f"min n_valid={stats['min_n_valid']}", flush=True)
    if not (math.isfinite(loss) and math.isfinite(stats["mel_mean"])
            and math.isfinite(stats["audio_std"])):
        raise RuntimeError(f"dryrun_multichip: not finite {stats}")
    return stats


def dryrun_multichip(n_devices=2):
    """``n_devices`` gloo ranks on the CPU, one training step and one
    inference + vocoder pass (``dryrun_rank``); returns each rank's
    numbers."""
    from flowtron_tpu_torch.parallel.launch import launch
    return launch("flowtron_tpu_torch.entry:dryrun_rank", int(n_devices),
                  env={"FLOWTRON_PLATFORM": "cpu"})


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
