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

Data-parallel over ``torch.distributed`` (parallel/mesh.py): with
``dist_config``'s rendezvous (or ``multiprocess: true`` under
``torchrun``) the ranks step in lockstep on a global batch of
``batch_size`` x world rows, as the JAX loop trains ``batch_size`` x
n_dev over its mesh. ``mesh_shape`` lays the ranks out; every axis but
``model`` splits the batch, so each batch coordinate loads its stride of
every epoch's permutation, ``batch_size`` x (the ``model`` axis's size)
rows, and the ranks of one model group load the same rows. Each rank's
losses are its rows' sums over the global batch's counts (all-reduced
over the batch group before the forward), so the gradients, summed over
the batch group in one flat bucket before the clip, are the global
batch's, as JAX's one program computes them; the printed and logged
losses are the global batch's. Validation all-reduces each batch's losses
the same way. Dropout is drawn from (seed, iteration, batch coordinate),
so a model group draws one set of masks for its rows. Only rank 0 prints,
logs, runs tone-CER and traces.

A ``model`` axis above 1 shards the parameters that the JAX package's
``param_shardings`` shards (parallel/tensor_parallel.py): each rank holds
its slice and its moments at rest, gathers whole tensors within its model
group for the step, and steps its slices; the global norm adds the
slices' squares over the model group. Validation and checkpoints run on
whole tensors gathered on the training thread, so a ``.pt`` or a
directory of such a run is what one process writes, and resuming or
warm-starting loads whole tensors before they are sliced.

Checkpoints go through ``AsyncSaver`` (written off the training thread):
``model_{iteration}.pt`` by rank 0, or with ``checkpoint_format: sharded``
(or ``sharded_checkpoints: true``) the port's ``torch.distributed.
checkpoint`` directory ``model_{iteration}`` written by every rank
(train/dist_ckpt.py). ``orbax`` is the JAX ecosystem's format: the port
writes its own directory for it and says so once. Resuming and
warm-starting read every format of either package
(train/checkpoints.py).

Runs on this rank's card (``cuda:0`` for one process), or on the CPU when
asked (``utils/device.py``: ``device="cpu"`` or ``FLOWTRON_PLATFORM=cpu``).
The grain loader is not ported and raises, naming its ROADMAP.md item.
"""

import contextlib
import json
import os
import time

import torch

from flowtron_tpu_torch.data.collate import (
    BatchIterator, DataCollate, PrefetchIterator,
)
from flowtron_tpu_torch.data.dataset import Data, data_kwargs
from flowtron_tpu_torch.models.flowtron import flowtron_forward, flowtron_init
from flowtron_tpu_torch.parallel.mesh import (
    Grid, all_reduce_sum, broadcast_module, maybe_initialize_distributed,
    rank, sync_gradients, world_size,
)
from flowtron_tpu_torch.parallel.tensor_parallel import TensorParallel
from flowtron_tpu_torch.train.checkpoints import (
    AsyncSaver, load_checkpoint, warmstart,
)
from flowtron_tpu_torch.train.logger import FlowtronLogger
from flowtron_tpu_torch.train.loss import flowtron_loss
from flowtron_tpu_torch.train.radam import (
    build_optimizer, clip_by_global_norm, trainable_parameters,
)
from flowtron_tpu_torch.utils.device import resolve_device
from flowtron_tpu_torch.utils.profiler import start_profiler, stop_profiler

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


def global_norm(batch, group=None):
    """The global batch's (valid frames, rows) as a (2,) float tensor,
    summed over the batch group (a ``RankGroup``; None: every rank); None
    when the group is one rank (each loss then divides by its own batch's
    counts)."""
    if (world_size() if group is None else group.size) == 1:
        return None
    out_lens = batch["out_lens"]
    return all_reduce_sum(torch.stack([
        out_lens.sum(), torch.tensor(len(out_lens), device=out_lens.device)
    ]).float(), group)


def make_train_step(model, static_cfg, optimizer, params, train_config,
                    grid=None, tp=None):
    """The training step: ``step(batch, generator, ctc_weight,
    prior_strength)`` -> metrics (0-d tensors: loss, nll, gate, ctc,
    grad_norm before clipping, and the valid frames; the global batch's
    under several ranks).
    ``batch`` holds tensors on the model's device (this rank's rows);
    ``params`` are the optimizer's (trainable) parameters. ``grid``
    (parallel/mesh.py:Grid; None: every rank a batch shard) names the
    batch group; ``tp`` (a ``TensorParallel``) runs the step on its
    slices."""
    group = None if grid is None else grid.batch_group
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
        norm = global_norm(batch, group)
        args = (static_cfg, batch["mel"], batch["speaker_ids"],
                batch["text"], batch["in_lens"], batch["out_lens"])
        kw = dict(attn_prior=attn_prior, train=True, generator=generator,
                  compute_dtype=compute_dtype, remat=remat)
        out = flowtron_forward(model, *args, **kw) if tp is None \
            else tp.call(flowtron_forward, *args, **kw)
        nll, gate, ctc = flowtron_loss(out, batch["gate_target"],
                                       batch["in_lens"], batch["out_lens"],
                                       norm=norm, **loss_kw)
        total = nll + gate + ctc * ctc_weight
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if tp is None:
            sync_gradients(params, group)
            grad_norm = clip_by_global_norm(params, clip)
        else:
            tp.reduce_gradients()
            grad_norm = clip_by_global_norm(
                params, clip, sharded=tp.sharded_parameters(),
                group=grid.model_group)
        optimizer.step()
        losses = all_reduce_sum(torch.stack([total, nll, gate, ctc]).detach(),
                                group)
        return {"loss": losses[0], "nll": losses[1], "gate": losses[2],
                "ctc": losses[3], "grad_norm": grad_norm,
                "frames": batch["out_lens"].sum() if norm is None
                else norm[0]}

    return step


def make_eval_step(model, static_cfg, train_config, grid=None):
    """``step(batch)`` -> nll, gate, ctc (the global batch's under several
    ranks, summed over ``grid``'s batch group) and this rank's last-flow
    attention and gate predictions, without dropout or gradients. Over a
    ``model`` axis it runs on whole parameters (``TensorParallel.
    gathered``)."""
    group = None if grid is None else grid.batch_group
    loss_kw = _loss_settings(static_cfg, train_config)

    @torch.no_grad()
    def step(batch):
        norm = global_norm(batch, group)
        out = flowtron_forward(
            model, static_cfg, batch["mel"], batch["speaker_ids"],
            batch["text"], batch["in_lens"], batch["out_lens"],
            attn_prior=batch.get("attn_prior"), train=False)
        losses = all_reduce_sum(torch.stack(flowtron_loss(
            out, batch["gate_target"], batch["in_lens"], batch["out_lens"],
            norm=norm, **loss_kw)), group)
        nll, gate, ctc = losses
        return {"nll": nll, "gate": gate, "ctc": ctc, "attn": out[3][-1],
                "gate_pred": out[2]}

    return step


def to_device(batch, device):
    """A collated numpy batch -> tensors on ``device`` (None dropped)."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in _TENSOR_KEYS
            if batch.get(k) is not None}


def prepare_dataloaders(data_config, batch_size, seed=1234,
                        pad_to_multiple=32, grid=None):
    """``batch_size`` is the global batch; each batch coordinate of
    ``grid`` (parallel/mesh.py:Grid; None: one process) loads its stride
    of ``batch_size // n_batch`` rows (the DistributedSampler's role,
    reference:train.py:74-75), the same rows on every rank of a model
    group."""
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
    shards, me = (1, 0) if grid is None else (grid.n_batch,
                                               grid.batch_index)
    local_bs = max(1, batch_size // shards)
    train_loader = PrefetchIterator(
        BatchIterator(trainset, local_bs, collate, shuffle=True,
                      seed=seed, num_shards=shards, shard_index=me))
    val_loader = BatchIterator(valset, local_bs, collate, shuffle=False,
                               seed=seed, drop_last=False, num_shards=shards,
                               shard_index=me)
    return train_loader, val_loader


def compute_validation_loss(eval_step, val_loader, device, ctc_weight,
                            on_batch=None):
    """Mean nll / gate / ctc over the validation batches (each the global
    batch's under several ranks) and the total loss at ``ctc_weight``;
    also returns this rank's last batch's outputs.
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


def checkpoint_format(train_config, announce=True):
    """"pickle" (a ``.pt`` file) or "sharded" (the port's directory) from
    ``checkpoint_format`` / ``sharded_checkpoints``; "orbax" writes the
    port's directory, said once when ``announce``."""
    fmt = train_config.get("checkpoint_format") or (
        "sharded" if train_config.get("sharded_checkpoints") else "pickle")
    if fmt == "orbax":
        if announce:
            print("checkpoint_format orbax: orbax is the JAX package's "
                  "format (ROADMAP.md, 'Not ported (decided)'); the port "
                  "writes its own torch.distributed.checkpoint directory "
                  "model_{iteration} instead, which it reads back as it "
                  "reads orbax directories", flush=True)
        fmt = "sharded"
    if fmt not in ("pickle", "sharded"):
        raise ValueError(f"checkpoint_format {fmt!r}; expected pickle, "
                         "sharded or orbax")
    return fmt


PROFILE_STEPS = (10, 15)     # the JAX loop's trace window, [start, stop)


def _stop_profiler(prof, profile_dir):
    print(f"profiler trace written to {stop_profiler(prof, profile_dir)}")


RANK_SEED_STRIDE = 1_000_000_007   # apart the batch shards' dropout


def train(config, device=None):
    """Main entry: a config dict with train/data/dist/model sections.
    Joins the process group that ``dist_config`` describes (none for one
    process). Returns (model, optimizer, the next iteration)."""
    train_config = config["train_config"]
    data_config = dict(config["data_config"])
    dist_config = config.get("dist_config", {})
    maybe_initialize_distributed(dist_config)
    grid = Grid(dist_config)
    lead = rank() == 0
    device = resolve_device(device)
    fmt = checkpoint_format(train_config, announce=lead)

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
    broadcast_module(model)        # every rank starts from rank 0's weights
    tp = None
    if grid.model_size > 1:        # slices of the sharded leaves at rest
        tp = TensorParallel(model, optimizer, grid)
        params = tp.parameters()

    train_step = make_train_step(model, static_cfg, optimizer, params,
                                 train_config, grid, tp)
    eval_step = make_eval_step(model, static_cfg, train_config, grid)
    batch_size = int(train_config["batch_size"]) * world_size()
    train_loader, val_loader = prepare_dataloaders(data_config, batch_size,
                                                   seed=seed, grid=grid)
    if lead and world_size() > 1:
        print(f"mesh: {grid.sizes}; global batch {batch_size}, "
              f"{batch_size // grid.n_batch} a batch shard", flush=True)

    output_directory = train_config.get("output_directory", "outdir")
    os.makedirs(output_directory, exist_ok=True)
    logger = FlowtronLogger(os.path.join(output_directory, "logs")) \
        if lead and train_config.get("with_tensorboard") else None

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
    profile_dir = train_config.get("profile_dir", "") if lead else ""
    prof = None
    saver = AsyncSaver()
    # whole parameters and moments for validation and a checkpoint's host
    # copy (the copy is taken inside, on this thread)
    whole = contextlib.nullcontext if tp is None else tp.gathered

    log = open(os.path.join(output_directory, "train_log.jsonl"), "a") \
        if lead else None
    try:
        t_last = time.time()
        for epoch in range(epoch_offset, epochs):
            if lead:
                print(f"Epoch: {epoch}")
            for batch in train_loader:
                if profile_dir and iteration == PROFILE_STEPS[0]:
                    prof = start_profiler(device)
                if prof is not None and iteration == PROFILE_STEPS[1]:
                    _stop_profiler(prof, profile_dir)
                    prof = None
                ctc_weight = ctc_w if (use_ctc and iteration >= ctc_start) \
                    else 0.0
                strength = prior_strength_schedule(iteration, pa_start,
                                                   pa_end)
                # per-iteration dropout stream, so a resumed run draws
                # what an uninterrupted one would; each rank its own
                generator.manual_seed(seed * 1_000_003 + iteration
                                      + grid.batch_index * RANK_SEED_STRIDE)
                t0 = time.perf_counter()
                metrics = train_step(
                    to_device(batch, device), generator,
                    torch.tensor(ctc_weight, device=device),
                    torch.tensor(strength, device=device))
                metrics = {k: float(v) for k, v in metrics.items()}
                frames = int(metrics.pop("frames"))
                step_s = time.perf_counter() - t0
                if lead:
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
                        "frames": frames,
                        "padded_shape": list(batch["attn_prior"].shape)
                        if batch.get("attn_prior") is not None
                        else list(batch["mel"].shape)}) + "\n")

                if iteration % iters_per_checkpoint == 0:
                    with whole():
                        val, last = compute_validation_loss(
                            eval_step, val_loader, device, ctc_weight)
                        if lead:
                            _log_validation(config, model, static_cfg, val,
                                            last, iteration, logger, log,
                                            tone_cer_texts)
                        name = f"model_{iteration}" + (
                            ".pt" if fmt == "pickle" else "")
                        saver.save(os.path.join(output_directory, name),
                                   model, optimizer, iteration,
                                   learning_rate, config, fmt=fmt)
                if lead:
                    log.flush()
                iteration += 1
        if prof is not None:             # the run ended inside the window
            _stop_profiler(prof, profile_dir)
        saver.wait()
        if tp is not None:               # hand back what one process would
            tp.unshard()
    finally:
        if log is not None:
            log.close()
    return model, optimizer, iteration


def _log_validation(config, model, static_cfg, val, last, iteration, logger,
                    log, tone_cer_texts):
    """Rank 0's report of a validation: stdout, TensorBoard, tone-CER of
    free-running synthesis decoded from the mel (no vocoder), the log."""
    print(f"Validation loss {iteration}: {val['loss']:9f}")
    if logger is not None:
        logger.log_validation(val["loss"], val["nll"], val["gate"],
                              val["ctc"], last, iteration)
    if tone_cer_texts > 0:
        from flowtron_tpu_torch.data.tone_cer import tone_cer_report
        rep = tone_cer_report(config, model, static_cfg,
                              max_texts=tone_cer_texts, via_audio=False)
        val["tone_cer_mel"] = rep["tone_cer_mel"]
        print(f"Validation tone-CER(mel) {iteration}: "
              f"{rep['tone_cer_mel']:.4f}")
        if logger is not None:
            logger.add_scalar("validation/tone_cer_mel", rep["tone_cer_mel"],
                              iteration)
    log.write(json.dumps({"iteration": iteration, "validation": val}) + "\n")
