"""Read the JAX package's orbax checkpoint directory (the restore side of
flowtron_tpu/train/orbax_ckpt.py) without jax or orbax:

  <dir>/state/        orbax's StandardSave of {"params", "opt_arrays"}
                      (tensorstore zarr arrays in an OCDBT store)
  <dir>/meta.json     iteration, learning_rate, config, opt_scalars,
                      n_opt_leaves; written last, so it marks a whole
                      checkpoint

Each leaf is read with ``tensorstore`` (which imports no jax) under its
dotted tree path, as ``state/_METADATA`` lists them: ``params.<flat
key>`` and ``opt_arrays.<i>``. The optimizer's leaves are the array
leaves of ``jax.tree_util``'s leaf order with the Python scalars of
``meta.json``'s ``opt_scalars`` put back at their places, as JAX's
restore does. A bf16 leaf comes back as float32, exactly. Without
``tensorstore`` installed an orbax directory raises and names it.

The port does not write this format: ``checkpoint_format: orbax`` writes
the port's own ``torch.distributed.checkpoint`` directory
(train/dist_ckpt.py).
"""

import json
import os

import numpy as np

MARKER = "meta.json"


def is_orbax_checkpoint(path):
    return os.path.isfile(os.path.join(path, MARKER))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise RuntimeError(
            "reading the JAX package's orbax checkpoint directory needs the "
            "`tensorstore` package, which is not installed; load the "
            "checkpoint's pickle or sharded form instead, or install "
            "tensorstore") from e
    return tensorstore


def _leaf_paths(state_dir):
    """The dotted paths of the stored leaves (an empty container is listed
    too, marked ``skip_deserialize``)."""
    with open(os.path.join(state_dir, "_METADATA")) as f:
        tree = json.load(f)["tree_metadata"]
    return [".".join(str(k["key"]) for k in v["key_metadata"])
            for v in tree.values()
            if not v["value_metadata"].get("skip_deserialize")]


def _read(ts, state_dir, path):
    spec = {"driver": "zarr",
            "kvstore": {"driver": "ocdbt",
                        "base": "file://" + os.path.abspath(state_dir) + "/",
                        "path": path}}
    arr = np.asarray(ts.open(spec).result().read().result())
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def read_orbax(dirpath):
    """(params {flat key: array}, optimizer leaves in order, iteration,
    learning_rate, config)."""
    with open(os.path.join(dirpath, MARKER)) as f:
        meta = json.load(f)
    ts = _tensorstore()
    state_dir = os.path.join(dirpath, "state")
    params, arrays = {}, {}
    for path in _leaf_paths(state_dir):
        head, _, rest = path.partition(".")
        if head == "params":
            params[rest] = _read(ts, state_dir, path)
        elif head == "opt_arrays":
            arrays[int(rest)] = _read(ts, state_dir, path)
    it = iter(arrays[i] for i in sorted(arrays))
    scalars = meta.get("opt_scalars", {})
    opt = [scalars[str(i)] if str(i) in scalars else next(it)
           for i in range(int(meta.get("n_opt_leaves", len(arrays))))]
    return (params, opt, meta["iteration"], meta["learning_rate"],
            meta.get("config"))
