"""Checkpoints of the training loop (port of ``save_checkpoint``,
``load_checkpoint`` and ``warmstart`` in flowtron_tpu/train/
checkpoints.py; reference:train.py:85-139).

A checkpoint is one ``torch.save`` file, ``model_{iteration}.pt``, holding
``{"model": state_dict, "optimizer": optimizer.state_dict(),
"iteration", "learning_rate", "config"}`` with the reference's parameter
names and only tensors and primitives, so ``torch.load(...,
weights_only=True)`` reads it: the port's ``load_model_for_inference``
takes it, and so does the JAX package's ``warmstart`` (a ``.pt`` with a
``model`` entry).

A file that is not ``.pt``/``.pth`` is read as the JAX package's pickle
checkpoint (``model_{iteration}``) through the restricted unpickler of
``utils/jax_pickle.py``: its params through
``utils/convert.py:flowtron_state_dict_from_jax``, its optimizer's moments
from the ``RAdamState`` or ``ScaleByAdamState`` inside its masked chain,
and its iteration. On such a file ``ignore_layers`` and ``include_layers``
name JAX's flat pytree keys (``flows.0.lstm.layers.0.w_ih``), as the JAX
package's ``_flatten`` writes them.

A directory is one of three formats, told apart by its marker file:
the port's own ``torch.distributed.checkpoint`` directory
(``flowtron.json``, train/dist_ckpt.py), or the JAX package's sharded
(``index.json``, train/sharded_ckpt.py) or orbax directory
(``meta.json``, train/orbax_ckpt.py). The JAX package's two directory
formats go the pickle's way: their flat params become JAX's pytree, and
their flat optimizer leaves become the moments of its masked RAdam or
Adam (``jax_payload``).

``AsyncSaver`` writes a checkpoint, ``.pt`` or directory, off the
training thread: the state is copied to the host on the training thread
and written on a thread of its own; a directory is written by every rank.
"""

import copy
import os
import threading

import torch

from flowtron_tpu_torch.parallel.mesh import rank
from flowtron_tpu_torch.train import dist_ckpt
from flowtron_tpu_torch.train.orbax_ckpt import is_orbax_checkpoint, read_orbax
from flowtron_tpu_torch.train.sharded_ckpt import (
    is_sharded_checkpoint, read_jax_sharded,
)
from flowtron_tpu_torch.utils.convert import (
    flatten_jax, flowtron_jax_from_state_dict, flowtron_jax_keys,
    flowtron_state_dict_from_jax, radam_state_from_jax, unflatten_jax,
)
from flowtron_tpu_torch.utils.jax_pickle import (
    MaskedNode, RAdamState, adam_moments, load_jax_pickle,
)


def _pt_payload(model, optimizer, iteration, learning_rate, config,
                copy_state=False):
    """The ``.pt`` checkpoint's dict; with ``copy_state`` every tensor a
    host copy taken now, so a thread may write it while training goes
    on."""
    opt = optimizer.state_dict()
    if copy_state:
        opt = copy.deepcopy({
            "state": {i: {k: v.detach().to("cpu", copy=True)
                          if torch.is_tensor(v) else v for k, v in s.items()}
                      for i, s in opt["state"].items()},
            "param_groups": opt["param_groups"]})
    return {
        "model": {k: v.detach().to("cpu", copy=copy_state)
                  for k, v in model.state_dict().items()},
        "optimizer": opt,
        "iteration": int(iteration),
        "learning_rate": float(learning_rate),
        "config": config,
    }


def save_checkpoint(path, model, optimizer, iteration, learning_rate,
                    config=None):
    """Write the checkpoint atomically (a temporary file, then rename)."""
    _write_pt(path, _pt_payload(model, optimizer, iteration, learning_rate,
                                config))


class AsyncSaver:
    """Background checkpoint writer (port of flowtron_tpu/train/
    checkpoints.py:AsyncSaver): ``save`` copies the state to the host on
    the calling (training) thread and writes it on a thread of its own.
    ``fmt`` "pickle" writes the ``.pt`` file (rank 0 only); "sharded"
    writes the port's directory (train/dist_ckpt.py), every rank its part,
    waiting on each other only through ``coord_barrier``'s gloo group.
    One write at a time: ``save`` first waits for the previous one, and
    ``wait`` joins it and raises what it raised."""

    def __init__(self):
        self._thread = None
        self._error = None

    def save(self, path, model, optimizer, iteration, learning_rate,
             config=None, fmt="pickle"):
        self.wait()
        if fmt == "sharded":
            snap = dist_ckpt.snapshot(model, optimizer)
            args = (path, snap, iteration, learning_rate, config,
                    type(optimizer).__name__)
            target = dist_ckpt.write
        elif fmt == "pickle":
            if rank() != 0:
                return
            args = (path, _pt_payload(model, optimizer, iteration,
                                      learning_rate, config, copy_state=True))
            target = _write_pt
        else:
            raise ValueError(f"checkpoint format {fmt!r}; the port writes "
                             "'pickle' (.pt) or 'sharded' (a directory)")

        def run():
            try:
                target(*args)
            except Exception as e:          # raised by wait()
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError("the checkpoint write failed") from error


def _write_pt(path, payload):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def checkpoint_kind(path):
    """"pt", "jax_pickle", "dcp" (the port's directory), "jax_sharded" or
    "orbax"; raises for a directory of none of these."""
    if os.path.isdir(path):
        for kind, found in (("dcp", dist_ckpt.is_dcp_checkpoint),
                            ("jax_sharded", is_sharded_checkpoint),
                            ("orbax", is_orbax_checkpoint)):
            if found(path):
                return kind
        raise ValueError(
            f"{path} is not a checkpoint directory: it has no "
            f"{dist_ckpt.MARKER} (the port's), index.json (the JAX "
            "package's sharded format) or meta.json (its orbax format); a "
            "save that did not finish leaves none of them")
    return "pt" if path.endswith((".pt", ".pth")) else "jax_pickle"


def jax_leaf_order(keys):
    """JAX flat keys in ``jax.tree_util``'s leaf order: dict keys sorted
    at each level, list items by index."""
    return sorted(keys, key=lambda k: [(0, int(c), "") if c.isdigit()
                                       else (1, 0, c) for c in k.split(".")])


def _unflatten_keys(flat):
    """{dotted key: leaf} -> the nested dicts and lists of a JAX pytree
    (a level whose keys are all digits is a list)."""
    tree = {}
    for key, leaf in flat.items():
        node, parts = tree, key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(tree)


def jax_payload(flat_params, opt_leaves, iteration, learning_rate, config,
                model, optimizer):
    """A JAX directory's state as its pickle holds it: ``params`` as JAX's
    pytree, and ``opt_state`` (when ``optimizer`` is given) as a
    ``RAdamState`` whose moment trees hold ``MaskedNode`` at the frozen
    leaves. The flat optimizer leaves are ``jax.tree_util``'s order of
    ``masked_optimizer(build_optimizer(...))``'s state: the step count,
    then the first moments and then the second moments of the trainable
    leaves, each in leaf order; a frozen parameter (outside
    ``finetune_layers``, or a fixed-Gaussian buffer) gives no leaf. The
    trainable leaves are the ones the port's ``optimizer`` holds."""
    params = _unflatten_keys(flat_params)
    payload = {"params": params, "opt_state": None,
               "iteration": iteration, "learning_rate": learning_rate,
               "config": config}
    if optimizer is None:
        return payload
    keys = flowtron_jax_keys(params)
    names = {id(p): n for n, p in model.named_parameters()}
    trainable = {keys[names[id(p)]] for g in optimizer.param_groups
                 for p in g["params"]}
    order = [k for k in jax_leaf_order(flat_params) if k in trainable]
    if len(opt_leaves) != 1 + 2 * len(order):
        raise ValueError(
            f"optimizer state mismatch: the checkpoint has "
            f"{len(opt_leaves)} optimizer leaves, the optimizer's "
            f"{len(order)} parameters need {1 + 2 * len(order)}")
    n = len(order)

    def moments(leaves):
        got = dict(zip(order, leaves))
        return _unflatten_keys({k: got.get(k, MaskedNode())
                                for k in flat_params})
    payload["opt_state"] = RAdamState(opt_leaves[0],
                                      moments(opt_leaves[1:1 + n]),
                                      moments(opt_leaves[1 + n:]))
    return payload


def _read_jax(path, kind, model, optimizer=None):
    """The payload of a JAX package checkpoint of ``kind``."""
    if kind == "jax_pickle":
        return load_jax_pickle(path)
    read = read_jax_sharded if kind == "jax_sharded" else read_orbax
    return jax_payload(*read(path), model, optimizer)


def _load_jax_optimizer(model, optimizer, opt_state):
    """Set ``optimizer``'s state from a JAX optimizer state: step, first
    and second moments of its RAdam or Adam, by parameter name. Raises if
    the two hold moments for different parameters."""
    found = adam_moments(opt_state)
    if found is None:
        raise ValueError("no RAdam or Adam state in the checkpoint's "
                         "optimizer state")
    moments = radam_state_from_jax(found)
    names = {id(p): n for n, p in model.named_parameters()}
    held = [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]
    differ = set(held) ^ set(moments["exp_avg"])
    if differ:
        raise ValueError("the checkpoint's optimizer holds moments for other "
                         f"parameters than the optimizer: {sorted(differ)}")

    def step():     # torch's Adam keeps a tensor a parameter, in place
        if isinstance(optimizer, torch.optim.Adam):
            return torch.tensor(float(moments["step"]))
        return moments["step"]

    state = {i: {"step": step(), "exp_avg": moments["exp_avg"][name],
                 "exp_avg_sq": moments["exp_avg_sq"][name]}
             for i, name in enumerate(held)}
    optimizer.load_state_dict({
        "state": state,
        "param_groups": optimizer.state_dict()["param_groups"]})


def load_checkpoint(path, model, optimizer=None, ignore_layers=()):
    """Resume: load the model (and the optimizer) state; returns the saved
    iteration. With ``ignore_layers`` (exact state_dict names of a
    ``.pt`` or the port's directory, exact flat keys of a JAX pickle,
    sharded or orbax checkpoint), those parameters keep their fresh
    values and the optimizer state is not restored
    (reference:train.py:116-123)."""
    kind = checkpoint_kind(path)
    if kind == "dcp":
        return dist_ckpt.load(path, model, optimizer, ignore_layers)
    if kind != "pt":
        payload = _read_jax(path, kind, model,
                            None if ignore_layers else optimizer)
        params = payload["params"]
        if ignore_layers:
            saved = flatten_jax(params)
            fresh = flatten_jax(flowtron_jax_from_state_dict(
                model.state_dict(), params))
            params = unflatten_jax({k: fresh[k] if k in ignore_layers
                                    else v for k, v in saved.items()}, params)
        model.load_state_dict(flowtron_state_dict_from_jax(params),
                              strict=True)
        if optimizer is not None and not ignore_layers:
            _load_jax_optimizer(model, optimizer, payload["opt_state"])
        return int(payload["iteration"])
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state = payload["model"]
    if ignore_layers:
        fresh = model.state_dict()
        state = {k: (fresh[k] if k in ignore_layers else v)
                 for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    if optimizer is not None and not ignore_layers:
        optimizer.load_state_dict(payload["optimizer"])
    return payload["iteration"]


def _warmstart_jax(params, model, include_layers):
    """JAX's native branch of ``warmstart`` on a JAX params pytree: every
    saved leaf whose flat key holds an ``include_layers`` substring and
    whose shape matches the fresh parameter's; any other keeps its fresh
    value."""
    keys = flowtron_jax_keys(params)
    own = model.state_dict()
    take = {}
    for name, value in flowtron_state_dict_from_jax(params).items():
        if include_layers and not any(s in keys[name]
                                      for s in include_layers):
            continue
        if name in own and value.shape == own[name].shape:
            take[name] = value
    model.load_state_dict(take, strict=False)
    return sorted(take)


def warmstart(path, model, include_layers=None):
    """Partial init. From a ``.pt`` state_dict (under ``state_dict`` or
    ``model``, or bare) or the port's directory: keys filtered by the
    ``include_layers`` substrings, unknown keys ignored, a
    shape-mismatched speaker embedding dropped (reference:train.py:
    101-103), any other mismatch raises. From a JAX pickle, sharded or
    orbax checkpoint, as the JAX package's native branch: the substrings
    match JAX's flat keys and any shape-mismatched key keeps its fresh
    value. Returns the loaded names."""
    kind = checkpoint_kind(path)
    if kind not in ("pt", "dcp"):
        return _warmstart_jax(_read_jax(path, kind, model)["params"], model,
                              include_layers)
    own = model.state_dict()
    if kind == "dcp":
        shapes = {k[len("model."):]: s for k, s in
                  dist_ckpt.saved_shapes(path).items()}
        take = _warmstart_filter(shapes, own, include_layers)
        loaded = dist_ckpt.load_model_state(
            path, {n: shapes[n] for n in take})
        model.load_state_dict(loaded, strict=False)
        return sorted(loaded)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    take = _warmstart_filter({k: v.shape for k, v in sd.items()}, own,
                             include_layers)
    model.load_state_dict({k: sd[k] for k in take}, strict=False)
    return sorted(take)


def _warmstart_filter(shapes, own, include_layers):
    """The saved names that ``warmstart`` takes from a state_dict of
    ``shapes`` ({name: shape}) into one like ``own``."""
    take = []
    for name, shape in shapes.items():
        if include_layers and not any(s in name for s in include_layers):
            continue
        if name not in own:
            continue
        if tuple(shape) != tuple(own[name].shape):
            if "speaker_embedding" in name:
                continue
            raise ValueError(f"{name}: shape {tuple(shape)} != "
                             f"{tuple(own[name].shape)}")
        take.append(name)
    return take
