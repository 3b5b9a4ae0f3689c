"""Rank functions of the distributed CPU tests
(tests/test_torch_port_ddp.py, tests/test_torch_port_dist_ckpt.py,
tests/test_torch_port_tp.py): each runs in a process that
``flowtron_tpu_torch/parallel/launch.py`` starts, after it joined the
gloo process group, and returns what the test compares. Imports torch and
the port only, so a rank starts quickly."""

import json
import os

import torch

from flowtron_tpu_torch.models.flowtron import flowtron_init
from flowtron_tpu_torch.parallel.mesh import Grid, rank
from flowtron_tpu_torch.parallel.tensor_parallel import TensorParallel
from flowtron_tpu_torch.train import loop
from flowtron_tpu_torch.train.checkpoints import AsyncSaver, load_checkpoint
from flowtron_tpu_torch.train.radam import (
    build_optimizer, trainable_parameters,
)
from flowtron_tpu_torch.utils.convert import radam_state_by_name


def no_dropout(module=loop):
    """Run ``module``'s training forward without dropout, as JAX's step
    with ``dropout_key=None``: a rank draws other dropout masks than one
    process over the whole batch, so only a run without dropout can be
    held against it."""
    forward = module.flowtron_forward

    def without(*args, **kw):
        kw["generator"] = None
        return forward(*args, **kw)
    module.flowtron_forward = without
    return forward


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def step_rank(state, dims, batches, train_cfg, ctc_weight):
    """``make_train_step`` over this rank's batches (one a step) from the
    model ``state``: each step's metrics and the final state."""
    torch.set_num_threads(1)
    model, cfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **dims)
    model.load_state_dict(state)
    params = [p for _, p in trainable_parameters(model)]
    opt = build_optimizer(params, train_cfg["optim_algo"],
                          train_cfg["learning_rate"],
                          train_cfg["weight_decay"])
    step = loop.make_train_step(model, cfg, opt, params, train_cfg)
    metrics = []
    for batch in batches[rank()]:
        out = step(loop.to_device(batch, torch.device("cpu")), None,
                   torch.tensor(ctc_weight), torch.tensor(1.0))
        metrics.append({k: float(v) for k, v in out.items()})
    return {"metrics": metrics, "state": _state(model)}


def train_rank(config):
    """``train(config)`` without dropout: rank 0's log, every rank's final
    model state."""
    torch.set_num_threads(1)
    no_dropout()
    model, _, iteration = loop.train(config)
    out = {"state": _state(model), "iteration": iteration}
    if rank() == 0:
        path = os.path.join(config["train_config"]["output_directory"],
                            "train_log.jsonl")
        with open(path) as f:
            out["log"] = [json.loads(line) for line in f]
    return out


def waveglow_rank(argv):
    """The vocoder trainer's ``main(argv)``: each step's loss and the final
    state."""
    from flowtron_tpu_torch.scripts.train_waveglow import main
    torch.set_num_threads(1)
    model, _, history = main(argv)
    return {"losses": [h["loss"] for h in history], "state": _state(model)}


def tp_step_rank(state, dims, batches, train_cfg, ctc_weight, dist_config,
                 out_dir, one_dir):
    """``make_train_step`` on a grid with a ``model`` axis, over this
    rank's batch shard's batches (``batches[batch_index]``) from the model
    ``state``: each step's metrics, the first step's gradients after the
    reduction (gathered whole), the slices' shapes, the at-rest bytes, the
    replicated parameters as this rank holds them, and the whole final
    state and moments. Then a ``.pt`` and a directory written from the
    gathered state (``out_dir/model_3.pt``, ``out_dir/model_3``), and the
    one-process directory ``one_dir`` resumed into whole tensors, sliced
    and gathered back (``back``)."""
    torch.set_num_threads(1)
    grid = Grid(dist_config)
    model, cfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **dims)
    model.load_state_dict(state)
    opt = build_optimizer([p for _, p in trainable_parameters(model)],
                          train_cfg["optim_algo"], train_cfg["learning_rate"],
                          train_cfg["weight_decay"])
    tp = TensorParallel(model, opt, grid)
    step = loop.make_train_step(model, cfg, opt, tp.parameters(), train_cfg,
                                grid, tp)
    grads = {}
    reduce = tp.reduce_gradients

    def recording():
        reduce()
        if not grads:
            sliced = {n: tp._slices[n].grad for n in tp._params}
            grads.update(tp._gather(sliced))
            grads.update({n: p.grad.clone() for n, p in
                          model.named_parameters() if n not in tp.dims})
    tp.reduce_gradients = recording
    metrics = []
    for batch in batches[grid.batch_index]:
        out = step(loop.to_device(batch, torch.device("cpu")), None,
                   torch.tensor(ctc_weight), torch.tensor(1.0))
        metrics.append({k: float(v) for k, v in out.items()})
    result = {"metrics": metrics, "grads": grads,
              "at_rest": tp.at_rest_bytes(),
              "slices": {n: tuple(s.shape) for n, s in tp._slices.items()},
              "replicated": {n: p.detach().clone() for n, p in
                             model.named_parameters() if n not in tp.dims}}
    saver = AsyncSaver()
    with tp.gathered():
        result["state"] = _state(model)
        result["moments"] = radam_state_by_name(model, opt)
        for name, fmt in (("model_3.pt", "pickle"), ("model_3", "sharded")):
            saver.save(os.path.join(out_dir, name), model, opt, 3,
                       train_cfg["learning_rate"], None, fmt=fmt)
    saver.wait()
    back, _ = flowtron_init(1, n_flows=2, use_gate_layer=True, **dims)
    back_opt = build_optimizer(list(back.parameters()),
                               train_cfg["optim_algo"], 1e-3)
    load_checkpoint(one_dir, back, back_opt)
    back_tp = TensorParallel(back, back_opt, grid)
    result["back_at_rest"] = back_tp.at_rest_bytes()
    back_tp.unshard()
    result["back"] = {"state": _state(back),
                      "moments": radam_state_by_name(back, back_opt)}
    return result


def train_cli_rank(argv):
    """``flowtron-torch-train``'s ``train_main(argv)`` without dropout: rank
    0's log (the output directory is ``train_config.output_directory`` of
    the overrides)."""
    from flowtron_tpu_torch.cli import train_main
    torch.set_num_threads(1)
    no_dropout()
    train_main(argv)
    if rank() != 0:
        return None
    out = next(a.split("=", 1)[1] for a in argv
               if a.startswith("train_config.output_directory="))
    with open(os.path.join(out, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]
