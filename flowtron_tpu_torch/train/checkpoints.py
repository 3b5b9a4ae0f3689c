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
package's ``_flatten`` writes them. The sharded and orbax directory
formats are not read (ROADMAP.md Queue 1 item 16).
"""

import os

import torch

from flowtron_tpu_torch.utils.convert import (
    flatten_jax, flowtron_jax_from_state_dict, flowtron_jax_keys,
    flowtron_state_dict_from_jax, radam_state_from_jax, unflatten_jax,
)
from flowtron_tpu_torch.utils.jax_pickle import adam_moments, load_jax_pickle


def save_checkpoint(path, model, optimizer, iteration, learning_rate,
                    config=None):
    """Write the checkpoint atomically (a temporary file, then rename)."""
    payload = {
        "model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
        "optimizer": optimizer.state_dict(),
        "iteration": int(iteration),
        "learning_rate": float(learning_rate),
        "config": config,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _is_jax_pickle(path):
    """True for a JAX package pickle checkpoint, False for a ``.pt``;
    raises for the JAX package's directory formats."""
    if os.path.isdir(path):
        raise NotImplementedError(
            "the JAX package's sharded and orbax checkpoint directories are "
            "not read yet; see ROADMAP.md Queue 1 item 16")
    return not path.endswith((".pt", ".pth"))


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
    ``.pt``, exact flat keys of a JAX pickle), those parameters keep
    their fresh values and the optimizer state is not restored
    (reference:train.py:116-123)."""
    if _is_jax_pickle(path):
        payload = load_jax_pickle(path)
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


def _warmstart_jax(path, model, include_layers):
    """JAX's pickle branch of ``warmstart``: every saved leaf whose flat
    key holds an ``include_layers`` substring and whose shape matches the
    fresh parameter's; any other keeps its fresh value."""
    params = load_jax_pickle(path)["params"]
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
    ``model``, or bare): keys filtered by the ``include_layers``
    substrings, unknown keys ignored, a shape-mismatched speaker embedding
    dropped (reference:train.py:101-103), any other mismatch raises. From
    a JAX pickle, as the JAX package's pickle branch: the substrings
    match JAX's flat keys and any shape-mismatched key keeps its fresh
    value. Returns the loaded names."""
    if _is_jax_pickle(path):
        return _warmstart_jax(path, model, include_layers)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt.get("model", ckpt))
    own = model.state_dict()
    take = {}
    for name, value in sd.items():
        if include_layers and not any(s in name for s in include_layers):
            continue
        if name not in own:
            continue
        if value.shape != own[name].shape:
            if "speaker_embedding" in name:
                continue
            raise ValueError(f"{name}: shape {tuple(value.shape)} != "
                             f"{tuple(own[name].shape)}")
        take[name] = value
    model.load_state_dict(take, strict=False)
    return sorted(take)
