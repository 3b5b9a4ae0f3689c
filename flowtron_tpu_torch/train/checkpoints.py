"""Checkpoints of the training loop (port of ``save_checkpoint``,
``load_checkpoint`` and the ``.pt`` branch of ``warmstart`` in
flowtron_tpu/train/checkpoints.py; reference:train.py:85-139).

A checkpoint is one ``torch.save`` file, ``model_{iteration}.pt``, holding
``{"model": state_dict, "optimizer": optimizer.state_dict(),
"iteration", "learning_rate", "config"}`` with the reference's parameter
names and only tensors and primitives, so ``torch.load(...,
weights_only=True)`` reads it: the port's ``load_model_for_inference``
takes it, and so does the JAX package's ``warmstart`` (a ``.pt`` with a
``model`` entry). The JAX package's pickle, sharded and orbax formats are
not read or written here (ROADMAP.md deferred item 2).
"""

import os

import torch


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


def _load(path):
    if not path.endswith((".pt", ".pth")):
        raise NotImplementedError(
            "the port reads .pt checkpoints only; the JAX package's pickle, "
            "sharded and orbax formats are ROADMAP.md deferred item 2")
    return torch.load(path, map_location="cpu", weights_only=True)


def load_checkpoint(path, model, optimizer=None, ignore_layers=()):
    """Resume: load the model (and the optimizer) state; returns the saved
    iteration. With ``ignore_layers``, those parameters (exact state_dict
    names) keep their fresh values and the optimizer state is not
    restored (reference:train.py:116-123)."""
    payload = _load(path)
    state = payload["model"]
    if ignore_layers:
        fresh = model.state_dict()
        state = {k: (fresh[k] if k in ignore_layers else v)
                 for k, v in state.items()}
    model.load_state_dict(state, strict=True)
    if optimizer is not None and not ignore_layers:
        optimizer.load_state_dict(payload["optimizer"])
    return payload["iteration"]


def warmstart(path, model, include_layers=None):
    """Partial init from a ``.pt`` state_dict (under ``state_dict`` or
    ``model``, or bare): keys filtered by the ``include_layers``
    substrings, unknown keys ignored, a shape-mismatched speaker embedding
    dropped (reference:train.py:101-103). Returns the loaded names."""
    ckpt = _load(path)
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
