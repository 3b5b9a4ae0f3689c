"""Read the JAX package's sharded checkpoint directory (port of the
restore side of flowtron_tpu/train/sharded_ckpt.py, numpy only):

  <dir>/index.json              array metadata, shard index maps, scalars
  <dir>/<name>.<region>.npy     one file per distinct shard region

Names are the JAX package's flat pytree keys (``flows.0.conv.w``); the
optimizer state is a flat list ``opt.{i:05d}`` in ``jax.tree_util``'s
leaf order (``jax_payload`` in train/checkpoints.py rebuilds its tree).
bf16 is stored as a ``uint16`` view and comes back as float32, exactly.
Every element of every array must be covered by a saved shard, as JAX's
restore requires: an incomplete directory (a partial multi-host save)
raises instead of restoring garbage.
"""

import json
import os

import numpy as np

MARKER = "index.json"


def is_sharded_checkpoint(path):
    return os.path.isfile(os.path.join(path, MARKER))


def read_index(dirpath):
    with open(os.path.join(dirpath, MARKER)) as f:
        return json.load(f)


def bf16_bits_to_f32(bits):
    """bf16 stored as its uint16 bit pattern -> the same values as
    float32 (bf16 is fp32's upper half)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def _from_disk(arr, dtype_name):
    if dtype_name == "bfloat16":
        return bf16_bits_to_f32(arr)
    return np.asarray(arr)


def _read_array(dirpath, meta):
    """The whole array, assembled from its shard files (memory-mapped);
    raises if the shards leave an element uncovered."""
    shape = tuple(meta["shape"])
    dtype = np.float32 if meta["dtype"] == "bfloat16" \
        else np.dtype(meta["dtype"])
    if not shape:                           # 0-d: one shard
        data = np.load(os.path.join(dirpath, meta["shards"][0]["file"]))
        return _from_disk(data, meta["dtype"]).reshape(())
    out = np.empty(shape, dtype)
    covered = np.zeros(shape, bool)
    for sh in meta["shards"]:
        path = os.path.join(dirpath, sh["file"])
        if not os.path.exists(path):
            continue                        # counted as a gap below
        sl = tuple(slice(a, b) for a, b in sh["index"])
        out[sl] = _from_disk(np.load(path, mmap_mode="r"), meta["dtype"])
        covered[sl] = True
    if not covered.all():
        raise ValueError(
            f"{dirpath}: the shards of {meta['shards'][0]['file']!r}... "
            f"leave {int((~covered).sum())} of {covered.size} elements "
            "uncovered (an incomplete or corrupted sharded checkpoint)")
    return out


def restore_flat(dirpath):
    """({flat name: numpy array or Python scalar}, the index) for every
    entry of the checkpoint, params and ``opt.*`` alike."""
    index = read_index(dirpath)
    out = {}
    for name, meta in index["arrays"].items():
        out[name] = meta["scalar"] if "scalar" in meta \
            else _read_array(dirpath, meta)
    return out, index


def read_jax_sharded(dirpath):
    """(params {flat key: array}, optimizer leaves in order, iteration,
    learning_rate, config)."""
    flat, index = restore_flat(dirpath)
    params = {k: v for k, v in flat.items() if not k.startswith("opt.")}
    opt = [flat[k] for k in sorted(k for k in flat if k.startswith("opt."))]
    return (params, opt, index["iteration"], index["learning_rate"],
            index.get("config"))
