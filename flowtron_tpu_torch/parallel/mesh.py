"""Processes, their grid and their groups (port of
flowtron_tpu/parallel/mesh.py: the mesh, its batch axes and
``param_shardings``).

The JAX package drives a device mesh from one process; the port runs one
process a rank, one device a rank, as the reference did
(reference:distributed.py:22-133). ``maybe_initialize_distributed`` joins
the ranks: ``dist_config``'s ``coordinator_address`` / ``num_processes`` /
``process_id`` give a TCP rendezvous, ``multiprocess: true`` reads the
environment ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and neither leaves one process
without a process group. Rank r runs on ``cuda:{LOCAL_RANK %
device_count}`` (``utils/device.py``).

``process_grid`` lays the ranks out as ``mesh_shape`` says (times
``dcn_mesh_shape``), a ``-1`` absorbing the world size. Rank r sits where
the JAX package's mesh puts device r: row-major over
``mesh_axis_names``, with the ``dcn`` granules outermost as
``create_hybrid_device_mesh`` lays them out, so the ranks of one model
group are neighbours on one host (``rank_coords``). Every axis but
``model`` is a batch axis (``dcn`` and ``data`` alike); a rank's batch
coordinate is its row-major index over them. ``Grid`` holds this rank's
place and two kinds of group (``grid_groups``): the model group, the
ranks of one batch coordinate (they see the same rows and share the
sharded parameters, parallel/tensor_parallel.py), and the batch group,
the ranks of one model index (they sum gradients and losses). Without a
``model`` axis the batch group is the world. ``param_shardings`` is JAX's
rule for which parameters the ``model`` axis shards, on JAX's shapes.

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


def _grid_shape(dist_config, world):
    """(axis names, per-granule shape, dcn shape) with a ``-1`` resolved;
    raises when the grid does not hold exactly ``world`` ranks."""
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
    total = math.prod(s * d for s, d in zip(shape, dcn))
    if total != world:
        sizes = {n: s * d for n, s, d in zip(names, shape, dcn)}
        raise ValueError(
            f"mesh {sizes} holds {total} ranks, the run has {world}: start "
            "one process a rank (torchrun, or dist_config's "
            "coordinator_address / num_processes / process_id)")
    return names, shape, dcn


def process_grid(dist_config, world=None):
    """{axis name: size} of the ranks' grid: ``mesh_shape`` (times
    ``dcn_mesh_shape`` where given, as the JAX package's hybrid mesh), a
    ``-1`` absorbing what the others leave of the world size. Raises when
    the grid does not hold exactly the world's ranks."""
    world = world_size() if world is None else int(world)
    names, shape, dcn = _grid_shape(dist_config, world)
    return {n: s * d for n, s, d in zip(names, shape, dcn)}


def _unravel(index, shape):
    out = []
    for s in reversed(shape):
        index, i = divmod(index, s)
        out.append(i)
    return out[::-1]


def rank_coords(dist_config, world=None, me=None):
    """{axis name: coordinate} of rank ``me`` (default: this one) on the
    grid, as ``create_hybrid_device_mesh`` places device ``me``: granule
    g = me // (ranks a granule), laid out row-major over
    ``dcn_mesh_shape``, then the rank's place in its granule row-major
    over ``mesh_shape``; along each axis the coordinate is the granule's
    index times the axis's ``mesh_shape`` plus the place."""
    world = world_size() if world is None else int(world)
    me = rank() if me is None else int(me)
    names, shape, dcn = _grid_shape(dist_config, world)
    granule, place = divmod(me, math.prod(shape))
    return {n: g * s + k for n, g, s, k in zip(
        names, _unravel(granule, dcn), shape, _unravel(place, shape))}


def batch_axes(grid, model_axis=MODEL_AXIS):
    """Every axis of the grid but the tensor-parallel one splits the batch
    (``('dcn', 'data')`` on a multi-slice grid)."""
    return tuple(a for a in grid if a != model_axis)


def batch_shard_size(grid, model_axis=MODEL_AXIS):
    return math.prod(grid[a] for a in batch_axes(grid, model_axis))


def model_size(grid, model_axis=MODEL_AXIS):
    """The ``model`` axis's size (1 without one)."""
    return int(grid.get(model_axis, 1))


def batch_index(grid, coords, model_axis=MODEL_AXIS):
    """A rank's batch coordinate: its row-major index over the batch
    axes."""
    index = 0
    for a in batch_axes(grid, model_axis):
        index = index * grid[a] + coords[a]
    return index


def grid_groups(dist_config, world):
    """(model groups, batch groups) as lists of ranks: model group b holds
    the ranks of batch coordinate b in model order, batch group j the
    ranks of model index j in batch order. A pure function."""
    grid = process_grid(dist_config, world)
    M, n_batch = model_size(grid), batch_shard_size(grid)
    model_groups = [[None] * M for _ in range(n_batch)]
    batch_groups = [[None] * n_batch for _ in range(M)]
    for r in range(world):
        c = rank_coords(dist_config, world, r)
        b, j = batch_index(grid, c), c.get(MODEL_AXIS, 0)
        model_groups[b][j] = r
        batch_groups[j][b] = r
    return model_groups, batch_groups


class RankGroup:
    """A set of ranks and its process group (None: the default group,
    when the set is the world)."""

    def __init__(self, ranks, pg=None):
        self.ranks, self.pg = list(ranks), pg

    @property
    def size(self):
        return len(self.ranks)


class Grid:
    """This rank's place on the grid: ``sizes`` ({axis: size}),
    ``coords``, ``model_size``, ``n_batch`` (batch shards),
    ``batch_index``, ``model_index``, and its ``model_group`` and
    ``batch_group`` (``RankGroup``). ``Grid(dist_config)`` makes the
    process groups: every rank calls ``new_group`` for every group, model
    groups first, in one order; without a ``model`` axis it makes none
    (the batch group is the world)."""

    def __init__(self, dist_config, world=None, me=None):
        world = world_size() if world is None else int(world)
        me = rank() if me is None else int(me)
        self.sizes = process_grid(dist_config, world)
        self.coords = rank_coords(dist_config, world, me)
        self.model_size = model_size(self.sizes)
        self.n_batch = batch_shard_size(self.sizes)
        self.batch_index = batch_index(self.sizes, self.coords)
        self.model_index = self.coords.get(MODEL_AXIS, 0)
        model_groups, batch_groups = grid_groups(dist_config, world)
        if self.model_size == 1:
            self.model_group = RankGroup([me])
            self.batch_group = RankGroup(range(world))
            return
        made = {}
        for ranks in model_groups + batch_groups:
            pg = dist.new_group(ranks) if is_distributed() \
                and len(ranks) > 1 else None
            if me in ranks:
                made[tuple(ranks)] = pg
        own_m = model_groups[self.batch_index]
        own_b = batch_groups[self.model_index]
        self.model_group = RankGroup(own_m, made[tuple(own_m)])
        self.batch_group = RankGroup(own_b, made[tuple(own_b)])


def jax_split_dim(name, shape, size, min_cols=8):
    """The port's dim that a ``model`` axis of ``size`` splits in the leaf
    ``name`` of port shape ``shape`` (a Flowtron state_dict name), or None:
    JAX's rule (flowtron_tpu/parallel/mesh.py:param_shardings) on JAX's
    shape. JAX splits the last axis of a 2-D leaf whose last dimension
    divides by ``size`` and is at least ``min_cols``. Its shape comes from
    the leaf's layout in ``utils/convert.py``: linear and LSTM weights are
    transposed there (JAX's last axis is the port's dim 0), a 1x1 conv
    (the flows' head) is 2-D (in, out) in JAX and (out, in, 1) here (dim 0
    again), and every other leaf has one shape in both."""
    from flowtron_tpu_torch.utils.convert import jax_layout
    if jax_layout(name) == "same":
        jax_shape, dim = tuple(shape), len(shape) - 1
    else:                       # transpose / conv1x1: (in, out) in JAX
        jax_shape, dim = (shape[1], shape[0]), 0
    if (size > 1 and len(jax_shape) == 2 and jax_shape[1] % size == 0
            and jax_shape[1] >= min_cols):
        return dim
    return None


def param_shardings(model, grid, model_axis=MODEL_AXIS):
    """{name: ``jax_split_dim``} for every parameter and buffer of a
    ``Flowtron``; ``grid`` is {axis: size} or the model axis's size."""
    size = grid if isinstance(grid, int) else model_size(grid, model_axis)
    return {name: jax_split_dim(name, t.shape, size)
            for name, t in (*model.named_parameters(),
                            *model.named_buffers())}


def _size(group):
    return world_size() if group is None else group.size


def all_reduce_sum(tensor, group=None):
    """Sum ``tensor`` over ``group`` (a ``RankGroup``; None: every rank)
    in place, a no-op for one rank; returns it."""
    if _size(group) > 1:
        dist.all_reduce(tensor, group=None if group is None else group.pg)
    return tensor


def _flat_apply(tensors, collective):
    """Run ``collective`` on one flat bucket of ``tensors`` and copy the
    result back."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def sync_gradients(params, group=None):
    """Sum the gradients of ``params`` over ``group`` (None: every rank),
    in one flat bucket: each rank's loss is already divided by the global
    batch's counts, so the sum is the global batch's gradient. Parameters
    without a gradient take no part (the graph is the same on every
    rank)."""
    if _size(group) == 1:
        return
    _flat_apply([p.grad for p in params if p.grad is not None],
                lambda flat: all_reduce_sum(flat, group))


def broadcast_gradients(params, group):
    """Give every rank of ``group`` its first rank's gradients of
    ``params`` (one flat bucket), so that they are bitwise alike."""
    if group.size == 1:
        return
    _flat_apply([p.grad for p in params if p.grad is not None],
                lambda flat: dist.broadcast(flat, group.ranks[0],
                                            group=group.pg))


@torch.no_grad()
def broadcast_module(module, src=0):
    """Give every rank rank ``src``'s parameters and buffers."""
    if world_size() == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src)
