"""The port's own checkpoint directory: ``torch.distributed.checkpoint``
(DCP), written by every rank (``checkpoint_format: sharded`` or ``orbax``,
or ``sharded_checkpoints: true``), the counterpart of the JAX package's
sharded and orbax directories:

  <dir>/.metadata, <dir>/*.distcp   DCP's files: {"model": state_dict,
                                    "optimizer": {name: {"step",
                                    "exp_avg", "exp_avg_sq"}}}
  <dir>/flowtron.json               iteration, learning_rate, config and
                                    the optimizer's class; written last,
                                    so it marks a whole checkpoint

The writes go to ``<dir>.tmp``; rank 0 writes the marker there after
every rank's files are down and then swaps the directory in, with
``coord_barrier`` (train/../parallel/mesh.py) between the phases, so the
previous checkpoint at ``<dir>`` survives a crash mid-save and a
half-written directory is never taken for one. DCP's own collectives run
on the same gloo coordination group, never the training group, so the
asynchronous saver may write from its thread while the next steps run.
Every rank holds the whole (replicated) state; DCP's planner writes each
tensor once. The loaders read it under one process or many: parameters
by their state_dict names, moments by parameter name.
"""

import contextlib
import json
import os
import shutil
import warnings

import torch

from flowtron_tpu_torch.parallel.mesh import (
    coord_barrier, coord_group, is_distributed, rank,
)

MARKER = "flowtron.json"
FORMAT = "flowtron_tpu_torch.dcp"


def is_dcp_checkpoint(path):
    return os.path.isfile(os.path.join(path, MARKER))


def _held_names(model, optimizer):
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def snapshot(model, optimizer=None):
    """The state as host tensors, copied now (on the training thread):
    {"model": {name: tensor}, "optimizer": {name: {"step", "exp_avg",
    "exp_avg_sq"}}} with each step a float64 0-d tensor."""
    out = {"model": {k: v.detach().to("cpu", copy=True)
                     for k, v in model.state_dict().items()}}
    if optimizer is not None:
        moments = {}
        for name, p in zip(_held_names(model, optimizer),
                           (p for g in optimizer.param_groups
                            for p in g["params"])):
            state = optimizer.state.get(p)
            if state:
                moments[name] = {
                    "step": torch.tensor(float(state["step"]),
                                         dtype=torch.float64),
                    "exp_avg": state["exp_avg"].detach().to("cpu", copy=True),
                    "exp_avg_sq": state["exp_avg_sq"].detach().to(
                        "cpu", copy=True)}
        out["optimizer"] = moments
    return out


def _dcp():
    # imported at first use: it takes seconds, and most runs write .pt
    import torch.distributed.checkpoint as dcp
    return dcp


@contextlib.contextmanager
def _quiet():
    """DCP warns of its deprecated spellings, and of one process without
    a process group, which ``_dcp_kw`` asks for."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        warnings.filterwarnings("ignore", "torch.distributed is disabled")
        yield


def _dcp_kw():
    # DCP's collectives: the gloo coordination group, or none at all
    if is_distributed():
        return {"process_group": coord_group()}
    return {"no_dist": True}


def write(dirpath, snap, iteration, learning_rate, config=None,
          optimizer_class=None):
    """Write a ``snapshot`` as the checkpoint directory ``dirpath``; every
    rank calls it (from any one thread of each)."""
    dirpath = dirpath.rstrip("/")
    tmp = dirpath + ".tmp"
    if rank() == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    coord_barrier("dcp_mkdir")
    with _quiet():
        dcp = _dcp()
        dcp.save(snap, storage_writer=dcp.FileSystemWriter(tmp), **_dcp_kw())
    coord_barrier("dcp_written")
    if rank() == 0:
        with open(os.path.join(tmp, MARKER), "w") as f:
            json.dump({"format": FORMAT, "version": 1,
                       "iteration": int(iteration),
                       "learning_rate": float(learning_rate),
                       "config": config,
                       "optimizer": optimizer_class}, f)
        if os.path.exists(dirpath):
            shutil.rmtree(dirpath)
        os.replace(tmp, dirpath)
    coord_barrier("dcp_swap")


def read_marker(dirpath):
    with open(os.path.join(dirpath, MARKER)) as f:
        return json.load(f)


def saved_shapes(dirpath):
    """{"model.<name>": shape} of the saved model tensors."""
    meta = _dcp().FileSystemReader(dirpath).read_metadata()
    return {k: tuple(v.size) for k, v in meta.state_dict_metadata.items()
            if k.startswith("model.") and hasattr(v, "size")}


def _load(dirpath, state):
    with _quiet():
        dcp = _dcp()
        dcp.load(state, storage_reader=dcp.FileSystemReader(dirpath),
                 **_dcp_kw())
    return state


def load_model_state(dirpath, names_shapes):
    """{name: tensor} of the saved model tensors ``names_shapes`` asks
    for ({name: shape})."""
    state = {"model": {n: torch.empty(s) for n, s in names_shapes.items()}}
    return _load(dirpath, state)["model"]


def load(dirpath, model, optimizer=None, ignore_layers=()):
    """Resume from a directory of this format: the model (strict), and
    the optimizer's moments and step by parameter name unless
    ``ignore_layers`` is given (those parameters then keep their fresh
    values, as the .pt path does). Returns the saved iteration."""
    own = model.state_dict()
    state = {"model": {k: torch.empty_like(v, device="cpu")
                       for k, v in own.items()}}
    restore_opt = optimizer is not None and not ignore_layers
    if restore_opt:
        held = _held_names(model, optimizer)
        params = dict(model.named_parameters())
        state["optimizer"] = {
            n: {"step": torch.zeros((), dtype=torch.float64),
                "exp_avg": torch.empty_like(params[n], device="cpu"),
                "exp_avg_sq": torch.empty_like(params[n], device="cpu")}
            for n in held}
    _load(dirpath, state)
    loaded = {k: (own[k] if k in ignore_layers else v)
              for k, v in state["model"].items()}
    model.load_state_dict(loaded, strict=True)
    if restore_opt:
        def step(v):       # torch's Adam keeps a tensor, RAdam an int
            if isinstance(optimizer, torch.optim.Adam):
                return torch.tensor(float(v))
            return int(v)
        optimizer.load_state_dict({
            "state": {i: {"step": step(state["optimizer"][n]["step"]),
                          "exp_avg": state["optimizer"][n]["exp_avg"],
                          "exp_avg_sq": state["optimizer"][n]["exp_avg_sq"]}
                      for i, n in enumerate(held)},
            "param_groups": optimizer.state_dict()["param_groups"]})
    return int(read_marker(dirpath)["iteration"])
