"""Rank functions of the data-parallel CPU tests
(tests/test_torch_port_ddp.py, tests/test_torch_port_dist_ckpt.py): each
runs in a process that ``flowtron_tpu_torch/parallel/launch.py`` starts,
after it joined the gloo process group, and returns what the test
compares. Imports torch and the port only, so a rank starts quickly."""

import json
import os

import torch

from flowtron_tpu_torch.models.flowtron import flowtron_init
from flowtron_tpu_torch.parallel.mesh import rank
from flowtron_tpu_torch.train import loop
from flowtron_tpu_torch.train.radam import (
    build_optimizer, trainable_parameters,
)


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
