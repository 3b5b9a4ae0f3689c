"""Training loop on one device (port of flowtron_tpu/train/loop.py;
reference:train.py:205-377).

``train(config)`` builds the model from ``model_config``, the optimizer
(RAdam or Adam, optax-style global-norm clipping, ``finetune_layers``
freezing), the port's host data pipeline, then steps through
``train_config.epochs``: each step is ``flowtron_forward`` (teacher-forced,
attention scores through kernel K3 on CUDA) -> ``flowtron_loss`` ->
backward -> clip -> optimizer step. Every ``iters_per_checkpoint``
iterations it runs the validation set and writes ``model_{iteration}.pt``
(train/checkpoints.py). ``fp16_run`` selects the bf16 compute policy of
``flowtron_forward`` (fp32 master weights, fp32 losses); ``remat``
rematerializes each flow's teacher-forced pass in the backward.

The CTC weight and the prior strength reach the step as tensors, so a
change of either changes no code path. Each step's numbers go to
``{output_directory}/train_log.jsonl`` and to stdout, and with
``with_tensorboard`` to TensorBoard under ``{output_directory}/logs``
(train/logger.py; tensorboardX and matplotlib). With
``tone_cer_validation_texts`` > 0 each validation also synthesizes that
many validation transcripts and logs their mel-decoded tone-CER
(``validation/tone_cer_mel``, data/tone_cer.py). With ``profile_dir``,
``torch.profiler`` records steps 10 to 14 (CPU and, on the card, CUDA
activity) into ``{profile_dir}/trace.json``, a Chrome trace; a run that
ends inside that window writes it at its end.

Runs on ``cuda:0``, or on the CPU when asked (``utils/device.py``:
``device="cpu"`` or ``FLOWTRON_PLATFORM=cpu``). Features of the
JAX loop that are not ported raise ``NotImplementedError`` naming their
ROADMAP.md item: grain, non-pickle checkpoint formats and a mesh of more
than one device.
"""

import json
import math
import os
import time

import torch

from flowtron_tpu_torch.data.collate import (
    BatchIterator, DataCollate, PrefetchIterator,
)
from flowtron_tpu_torch.data.dataset import Data, data_kwargs
from flowtron_tpu_torch.models.flowtron import flowtron_forward, flowtron_init
from flowtron_tpu_torch.train.checkpoints import (
    load_checkpoint, save_checkpoint, warmstart,
)
from flowtron_tpu_torch.train.logger import FlowtronLogger
from flowtron_tpu_torch.train.loss import flowtron_loss
from flowtron_tpu_torch.train.radam import (
    build_optimizer, clip_by_global_norm, trainable_parameters,
)
from flowtron_tpu_torch.utils.device import resolve_device

_TENSOR_KEYS = ("mel", "speaker_ids", "text", "in_lens", "out_lens",
                "gate_target", "attn_prior")


def prior_strength_schedule(iteration, start_iter, end_iter):
    """Attention-prior anneal: full scaffold (1.0) before start_iter,
    linear ramp to 0.0 at end_iter, prior-free after. end_iter=0
    disables the schedule (constant full prior, reference behavior)."""
    if end_iter <= 0 or iteration <= start_iter:
        return 1.0
    if iteration >= end_iter:
        return 0.0
    return 1.0 - (iteration - start_iter) / float(end_iter - start_iter)


def _loss_settings(static_cfg, train_config):
    return dict(sigma=train_config["sigma"],
                gm_loss=bool(static_cfg["n_components"]),
                gate_loss=bool(train_config.get("gate_loss", True)),
                use_ctc_loss=bool(train_config.get("use_ctc_loss", False)),
                blank_logprob=float(train_config.get("blank_logprob", -1)))


def make_train_step(model, static_cfg, optimizer, params, train_config):
    """The training step: ``step(batch, generator, ctc_weight,
    prior_strength)`` -> metrics (0-d tensors: loss, nll, gate, ctc,
    grad_norm before clipping). ``batch`` holds tensors on the model's
    device; ``params`` are the optimizer's (trainable) parameters."""
    loss_kw = _loss_settings(static_cfg, train_config)
    compute_dtype = torch.bfloat16 if train_config.get("fp16_run") else None
    remat = bool(train_config.get("remat"))
    anneal_end = int(train_config.get("prior_anneal_end_iter", 0))
    clip = float(train_config.get("grad_clip_val", 0.0))

    def step(batch, generator, ctc_weight, prior_strength):
        # the prior raised to lambda scales its additive log term: lambda=1
        # is the full beta-binomial scaffold, lambda=0 a uniform prior
        attn_prior = batch.get("attn_prior")
        if attn_prior is not None and anneal_end > 0:
            attn_prior = (attn_prior + 1e-20) ** prior_strength
        out = flowtron_forward(
            model, static_cfg, batch["mel"], batch["speaker_ids"],
            batch["text"], batch["in_lens"], batch["out_lens"],
            attn_prior=attn_prior, train=True, generator=generator,
            compute_dtype=compute_dtype, remat=remat)
        nll, gate, ctc = flowtron_loss(out, batch["gate_target"],
                                       batch["in_lens"], batch["out_lens"],
                                       **loss_kw)
        total = nll + gate + ctc * ctc_weight
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        grad_norm = clip_by_global_norm(params, clip)
        optimizer.step()
        return {"loss": total.detach(), "nll": nll.detach(),
                "gate": gate.detach(), "ctc": ctc.detach(),
                "grad_norm": grad_norm}

    return step


def make_eval_step(model, static_cfg, train_config):
    """``step(batch)`` -> nll, gate, ctc and the last flow's attention and
    gate predictions, without dropout or gradients."""
    loss_kw = _loss_settings(static_cfg, train_config)

    @torch.no_grad()
    def step(batch):
        out = flowtron_forward(
            model, static_cfg, batch["mel"], batch["speaker_ids"],
            batch["text"], batch["in_lens"], batch["out_lens"],
            attn_prior=batch.get("attn_prior"), train=False)
        nll, gate, ctc = flowtron_loss(out, batch["gate_target"],
                                       batch["in_lens"], batch["out_lens"],
                                       **loss_kw)
        return {"nll": nll, "gate": gate, "ctc": ctc, "attn": out[3][-1],
                "gate_pred": out[2]}

    return step


def to_device(batch, device):
    """A collated numpy batch -> tensors on ``device`` (None dropped)."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in _TENSOR_KEYS
            if batch.get(k) is not None}


def prepare_dataloaders(data_config, batch_size, seed=1234,
                        pad_to_multiple=32):
    if data_config.get("use_grain"):
        raise NotImplementedError(
            "the grain loader is not ported (ROADMAP.md Queue 1, 'Not "
            "ported (decided)'); set data_config.use_grain=false")
    kwargs = data_kwargs(data_config)
    trainset = Data(data_config["training_files"], **kwargs)
    valset = Data(data_config["validation_files"],
                  **dict(kwargs, speaker_ids=trainset.speaker_ids))
    collate = DataCollate(use_attn_prior=trainset.use_attn_prior,
                          pad_to_multiple=pad_to_multiple)
    train_loader = PrefetchIterator(
        BatchIterator(trainset, batch_size, collate, shuffle=True,
                      seed=seed))
    val_loader = BatchIterator(valset, batch_size, collate, shuffle=False,
                               seed=seed, drop_last=False)
    return train_loader, val_loader


def compute_validation_loss(eval_step, val_loader, device, ctc_weight,
                            on_batch=None):
    """Mean nll / gate / ctc over the validation batches and the total
    loss at ``ctc_weight``; also returns the last batch's outputs.
    ``on_batch(out, host_batch)``, when given, sees every batch
    (``evaluate`` accumulates its health metrics with it)."""
    totals = {"nll": 0.0, "gate": 0.0, "ctc": 0.0}
    n, last = 0, None
    for batch in val_loader:
        out = eval_step(to_device(batch, device))
        for k in totals:
            totals[k] += float(out[k])
        n += 1
        last = {**out, "batch": batch}
        if on_batch is not None:
            on_batch(out, batch)
    if n == 0:
        return {"loss": 0.0, **totals}, None
    for k in totals:
        totals[k] /= n
    loss = totals["nll"] + totals["gate"] + totals["ctc"] * ctc_weight
    return {"loss": loss, **totals}, last


def _refuse_unported(train_config, dist_config):
    """Raise for a JAX-loop feature the port does not have yet."""
    refusals = [
        (train_config.get("checkpoint_format") not in (None, "", "pickle")
         or train_config.get("sharded_checkpoints"), "checkpoint_format",
         "deferred item 2 and Queue 1 item 16 (only .pt checkpoints)"),
        (math.prod(max(1, int(s)) for s in
                   dist_config.get("mesh_shape", (-1,))) > 1
         or dist_config.get("dcn_mesh_shape"), "dist_config.mesh_shape",
         "Queue 1 item 16 (DDP); the port trains on one device"),
    ]
    for on, key, item in refusals:
        if on:
            raise NotImplementedError(
                f"{key} is not ported yet; see ROADMAP.md {item}")


PROFILE_STEPS = (10, 15)     # the JAX loop's trace window, [start, stop)


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profiler(prof, profile_dir):
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def train(config, device=None):
    """Main entry: a config dict with train/data/dist/model sections.
    Returns (model, optimizer, the next iteration)."""
    train_config = config["train_config"]
    data_config = dict(config["data_config"])
    _refuse_unported(train_config, config.get("dist_config", {}))
    device = resolve_device(device)

    seed = int(train_config.get("seed", 1234))
    model, static_cfg = flowtron_init(seed, device=device,
                                      **config["model_config"])
    params = [p for _, p in trainable_parameters(
        model, train_config.get("finetune_layers", ()))]
    learning_rate = float(train_config["learning_rate"])
    optimizer = build_optimizer(params,
                                train_config.get("optim_algo", "RAdam"),
                                learning_rate,
                                float(train_config.get("weight_decay", 0.0)))

    iteration = 0
    if train_config.get("warmstart_checkpoint_path"):
        warmstart(train_config["warmstart_checkpoint_path"], model,
                  train_config.get("include_layers") or None)
    if train_config.get("checkpoint_path"):
        iteration = load_checkpoint(
            train_config["checkpoint_path"], model, optimizer,
            train_config.get("ignore_layers", ())) + 1

    train_step = make_train_step(model, static_cfg, optimizer, params,
                                 train_config)
    eval_step = make_eval_step(model, static_cfg, train_config)
    train_loader, val_loader = prepare_dataloaders(
        data_config, int(train_config["batch_size"]), seed=seed)

    output_directory = train_config.get("output_directory", "outdir")
    os.makedirs(output_directory, exist_ok=True)
    log_path = os.path.join(output_directory, "train_log.jsonl")
    logger = FlowtronLogger(os.path.join(output_directory, "logs")) \
        if train_config.get("with_tensorboard") else None

    use_ctc = bool(train_config.get("use_ctc_loss", False))
    ctc_start = int(train_config.get("ctc_loss_start_iter", 0))
    ctc_w = float(train_config.get("ctc_loss_weight", 0.0))
    pa_start = int(train_config.get("prior_anneal_start_iter", 0))
    pa_end = int(train_config.get("prior_anneal_end_iter", 0))
    iters_per_checkpoint = int(train_config.get("iters_per_checkpoint", 1000))
    tone_cer_texts = int(train_config.get("tone_cer_validation_texts", 0))
    epochs = int(train_config.get("epochs", 1))
    epoch_offset = max(0, iteration // max(1, len(train_loader)))
    generator = torch.Generator(device=device)
    profile_dir = train_config.get("profile_dir", "")
    prof = None

    with open(log_path, "a") as log:
        t_last = time.time()
        for epoch in range(epoch_offset, epochs):
            print(f"Epoch: {epoch}")
            for batch in train_loader:
                if profile_dir and iteration == PROFILE_STEPS[0]:
                    prof = _start_profiler(device)
                if prof is not None and iteration == PROFILE_STEPS[1]:
                    _stop_profiler(prof, profile_dir)
                    prof = None
                ctc_weight = ctc_w if (use_ctc and iteration >= ctc_start) \
                    else 0.0
                strength = prior_strength_schedule(iteration, pa_start,
                                                   pa_end)
                # per-iteration dropout stream, so a resumed run draws
                # what an uninterrupted one would
                generator.manual_seed(seed * 1_000_003 + iteration)
                t0 = time.perf_counter()
                metrics = train_step(
                    to_device(batch, device), generator,
                    torch.tensor(ctc_weight, device=device),
                    torch.tensor(strength, device=device))
                metrics = {k: float(v) for k, v in metrics.items()}
                step_s = time.perf_counter() - t0
                now = time.time()
                print(f"{iteration}:\t{metrics['loss']:.9f}\t"
                      f"({now - t_last:.2f}s)", flush=True)
                t_last = now
                if logger is not None:
                    logger.log_training(metrics["loss"], metrics["gate"],
                                        metrics["nll"], metrics["ctc"],
                                        learning_rate, iteration)
                log.write(json.dumps({
                    "iteration": iteration, **metrics, "step_s": step_s,
                    "frames": int(batch["out_lens"].sum()),
                    "padded_shape": list(batch["attn_prior"].shape)
                    if batch.get("attn_prior") is not None
                    else list(batch["mel"].shape)}) + "\n")

                if iteration % iters_per_checkpoint == 0:
                    val, last = compute_validation_loss(
                        eval_step, val_loader, device, ctc_weight)
                    print(f"Validation loss {iteration}: {val['loss']:9f}")
                    if logger is not None:
                        logger.log_validation(
                            val["loss"], val["nll"], val["gate"], val["ctc"],
                            last, iteration)
                    if tone_cer_texts > 0:
                        # content-level intelligibility of free-running
                        # synthesis, decoded from the mel (no vocoder)
                        from flowtron_tpu_torch.data.tone_cer import (
                            tone_cer_report)
                        rep = tone_cer_report(config, model, static_cfg,
                                              max_texts=tone_cer_texts,
                                              via_audio=False)
                        val["tone_cer_mel"] = rep["tone_cer_mel"]
                        print(f"Validation tone-CER(mel) {iteration}: "
                              f"{rep['tone_cer_mel']:.4f}")
                        if logger is not None:
                            logger.add_scalar("validation/tone_cer_mel",
                                              rep["tone_cer_mel"], iteration)
                    log.write(json.dumps({"iteration": iteration,
                                          "validation": val}) + "\n")
                    save_checkpoint(
                        os.path.join(output_directory,
                                     f"model_{iteration}.pt"),
                        model, optimizer, iteration, learning_rate, config)
                log.flush()
                iteration += 1
    if prof is not None:                 # the run ended inside the window
        _stop_profiler(prof, profile_dir)
    return model, optimizer, iteration
