"""Processes, their grid and their groups (port of
flowtron_tpu/parallel/mesh.py:15-99 for the batch axes).

The JAX package drives a device mesh from one process; the port runs one
process a rank, one device a rank, as the reference did
(reference:distributed.py:22-133). ``maybe_initialize_distributed`` joins
the ranks: ``dist_config``'s ``coordinator_address`` / ``num_processes`` /
``process_id`` give a TCP rendezvous, ``multiprocess: true`` reads the
environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and neither leaves one process
without a process group. Rank r runs on ``cuda:{LOCAL_RANK %
device_count}`` (``utils/device.py``).

``process_grid`` lays the ranks out as ``mesh_shape`` says, a ``-1``
absorbing the world size. Every axis but ``model`` is a batch axis
(``dcn`` and ``data`` alike): the batch is split over all of them and the
parameters replicated, so gradients are summed over every rank. A
``model`` axis above 1 (tensor parallelism) is not ported and raises,
naming its ROADMAP.md item.

The backend is NCCL when every rank of a host has a card of its own, else
gloo: on the CPU, and when ranks share a card (NCCL refuses two ranks on
one device). ``coord_barrier`` waits on a second gloo group kept for it
alone: the asynchronous checkpoint writer waits from its thread, and a
barrier on the training group there could interleave with the step's
all-reduces and deadlock.
"""

import datetime
import math
import os

import torch
import torch.distributed as dist

MODEL_AXIS = "model"
MODEL_AXIS_ITEM = ("ROADMAP.md Queue 1, (l2) Item 16b / slice C item 23b: "
                   "the `model` axis")

_coord_group = None          # the gloo group of coord_barrier


def is_distributed():
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if is_distributed() else 1


def rank():
    return dist.get_rank() if is_distributed() else 0


def local_rank():
    """This rank's index on its host: ``LOCAL_RANK`` when set (torchrun
    sets it), else the global rank."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def _wants_cpu():
    from flowtron_tpu_torch.utils.device import PLATFORM_VAR
    return (os.environ.get(PLATFORM_VAR, "").lower() == "cpu"
            or not torch.cuda.is_available())


def choose_backend(world):
    """NCCL when each of this host's ranks has a card of its own, else
    gloo (the CPU, or ranks sharing a card)."""
    if _wants_cpu():
        return "gloo"
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return "nccl" if on_host <= torch.cuda.device_count() else "gloo"


def maybe_initialize_distributed(dist_config, timeout_s=600):
    """Join the ranks as ``dist_config`` says; returns True when a process
    group is up (also when it already was), False for one process."""
    global _coord_group
    if is_distributed():
        return True
    timeout = datetime.timedelta(seconds=timeout_s)
    address = dist_config.get("coordinator_address")
    if address:
        world = int(dist_config["num_processes"])
        this = int(dist_config["process_id"])
        init = address if "://" in address else f"tcp://{address}"
    elif dist_config.get("multiprocess"):
        world = int(os.environ["WORLD_SIZE"])
        this = int(os.environ["RANK"])
        init = "env://"
    else:
        return False
    backend = choose_backend(world)
    if backend == "nccl":
        # before the group: NCCL binds each rank to the current device
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", this))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=this, timeout=timeout)
    _coord_group = dist.new_group(backend="gloo", timeout=timeout)
    return True


def destroy():
    """Leave the process group (a no-op without one)."""
    global _coord_group
    if is_distributed():
        dist.destroy_process_group()
    _coord_group = None


def coord_barrier(tag=""):
    """Wait for every rank on the coordination group (gloo, never the
    training group), so that a thread may call it while the training
    thread runs collectives. A no-op for one process. ``tag`` names the
    wait in a timeout's error."""
    if world_size() == 1:
        return
    try:
        dist.barrier(group=_coord_group)
    except RuntimeError as e:
        raise RuntimeError(f"coord_barrier({tag!r}): {e}") from e


def coord_group():
    """The coordination group (None for one process)."""
    return _coord_group


def model_axis_size(dist_config):
    """The ``model`` axis of ``mesh_shape`` (times ``dcn_mesh_shape``'s),
    1 when the mesh has none."""
    names = list(dist_config.get("mesh_axis_names", ("data",)))
    if MODEL_AXIS not in names:
        return 1
    i = names.index(MODEL_AXIS)
    shape = list(dist_config.get("mesh_shape", (-1,)))
    dcn = list(dist_config.get("dcn_mesh_shape") or [1] * len(shape))
    return max(1, int(shape[i])) * max(1, int(dcn[i]))


def refuse_model_axis(dist_config, what="dist_config.mesh_shape"):
    """Raise NotImplementedError for a ``model`` axis above 1."""
    n = model_axis_size(dist_config)
    if n > 1:
        raise NotImplementedError(
            f"{what}: a `model` axis of {n} (tensor parallelism) is not "
            f"ported yet; the port splits the batch only. See "
            f"{MODEL_AXIS_ITEM}")


def process_grid(dist_config, world=None):
    """{axis name: size} of the ranks' grid: ``mesh_shape`` (times
    ``dcn_mesh_shape`` where given, as the JAX package's hybrid mesh), a
    ``-1`` absorbing what the others leave of the world size. Raises for
    a ``model`` axis above 1, and when the grid does not hold exactly the
    world's ranks."""
    refuse_model_axis(dist_config)
    world = world_size() if world is None else int(world)
    names = tuple(dist_config.get("mesh_axis_names", ("data",)))
    shape = [int(s) for s in dist_config.get("mesh_shape", (-1,))]
    dcn = [int(s) for s in dist_config.get("dcn_mesh_shape")
           or [1] * len(shape)]
    if len(names) != len(shape) or len(dcn) != len(shape):
        raise ValueError(f"mesh_shape {shape}, dcn_mesh_shape {dcn} and "
                         f"mesh_axis_names {list(names)} differ in length")
    if -1 in shape:
        i = shape.index(-1)
        known = math.prod(s * d for j, (s, d) in enumerate(zip(shape, dcn))
                          if j != i)
        shape[i] = max(1, world // (known * dcn[i]))
    sizes = [s * d for s, d in zip(shape, dcn)]
    if math.prod(sizes) != world:
        raise ValueError(
            f"mesh {dict(zip(names, sizes))} holds {math.prod(sizes)} "
            f"ranks, the run has {world}: start one process a rank "
            "(torchrun, or dist_config's coordinator_address / "
            "num_processes / process_id)")
    return dict(zip(names, sizes))


def batch_axes(grid, model_axis=MODEL_AXIS):
    """Every axis of the grid but the tensor-parallel one splits the batch
    (``('dcn', 'data')`` on a multi-slice grid)."""
    return tuple(a for a in grid if a != model_axis)


def batch_shard_size(grid, model_axis=MODEL_AXIS):
    return math.prod(grid[a] for a in batch_axes(grid, model_axis))


def all_reduce_sum(tensor):
    """Sum ``tensor`` over the ranks in place (a no-op for one process);
    returns it."""
    if world_size() > 1:
        dist.all_reduce(tensor)
    return tensor


def sync_gradients(params):
    """Sum the gradients of ``params`` over the ranks, in one flat bucket:
    each rank's loss is already divided by the global batch's counts, so
    the sum is the global batch's gradient. Parameters without a gradient
    take no part (the graph is the same on every rank)."""
    if world_size() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n


@torch.no_grad()
def broadcast_module(module, src=0):
    """Give every rank rank ``src``'s parameters and buffers."""
    if world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)
