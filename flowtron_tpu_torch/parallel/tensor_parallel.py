"""Training over a ``model`` axis: each rank of a model group holds its
slice of the sharded parameters (the JAX package leaves this to GSPMD,
flowtron_tpu/parallel/mesh.py:place_params; the port does it by hand over
``torch.distributed`` groups, parallel/mesh.py:Grid).

``param_shardings`` (parallel/mesh.py) names the leaves JAX shards and the
port's dim that holds JAX's last axis. ``TensorParallel(model, optimizer,
grid)`` slices them: rank j of a model group of M keeps chunk j of M
along that dim, at rest, with its optimizer moments; the module keeps the
``Parameter`` object with an empty tensor in it, so a use at rest fails
loudly, and every other leaf stays whole (replicated). Then:

- ``call(fn, *args)`` all-gathers the whole tensors within the model group
  (one flat bucket a dtype) and runs ``fn(model, *args)`` on them through
  ``torch.func.functional_call``, so the bf16 policy's casts and remat's
  recompute see them too;
- ``reduce_gradients()`` after the backward: each rank takes its own
  chunk of each sharded gradient, sums it and the replicated gradients
  over the batch group (the ranks of its model index) in one bucket, and
  then takes the replicated gradients from its model group's first rank,
  so that they, and the replicated parameters the optimizer steps, stay
  bitwise alike across the group (cuDNN's LSTM backward is not
  deterministic, so two ranks on the same rows may differ in the last
  bits);
- ``clip_by_global_norm`` (train/radam.py) sums the slices' squares over
  the model group and adds the replicated leaves' once;
- the optimizer steps each rank's slices: RAdam and Adam are elementwise,
  so a slice's step is the slice of the whole step;
- ``gathered()`` puts whole parameters and whole moments back for a block
  (validation, a checkpoint's host copy), collectively, on the training
  thread; ``unshard()`` for good.

Why not column-parallel products (each rank multiplying by its slice and
gathering activations): cuDNN's LSTMs and kernel K3 take whole weights.
So the forward and backward run whole on every rank of a model group, on
the same rows; what the ``model`` axis buys is JAX's layout at rest (the
parameters and optimizer state of the sharded leaves divided by M) and
JAX's answers: a step equals data parallelism over the batch axes, up to
rounding.
"""

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from flowtron_tpu_torch.parallel.mesh import (
    broadcast_gradients, param_shardings, sync_gradients,
)


class _Bound(nn.Module):
    """``fn(model, ...)`` as a module's forward, so that
    ``functional_call`` can swap ``model``'s tensors for it."""

    def __init__(self, model, fn):
        super().__init__()
        self.model, self.fn = model, fn

    def forward(self, *args, **kwargs):
        return self.fn(self.model, *args, **kwargs)


def _owner(module, name):
    parent, _, attr = name.rpartition(".")
    return (module.get_submodule(parent) if parent else module), attr


class TensorParallel:
    """Hybrid sharding of ``model`` and ``optimizer`` over ``grid``'s model
    group (a ``parallel/mesh.py:Grid`` with ``model_size`` > 1). The
    optimizer's parameter list then holds the slices in place of the
    sharded parameters; ``parameters()`` gives it."""

    def __init__(self, model, optimizer, grid):
        self.model, self.optimizer, self.grid = model, optimizer, grid
        self.M, self.j = grid.model_size, grid.model_index
        self.dims = {n: d for n, d in param_shardings(
            model, grid.model_size).items() if d is not None}
        params = dict(model.named_parameters())
        self._params = {n: params[n] for n in self.dims if n in params}
        self._buffers = [n for n in self.dims if n not in params]
        self._slices = {}           # name -> this rank's slice
        self._whole = None          # the tensors of one call
        self.sharded = True
        self._shard(initial=True)

    # -- layout ------------------------------------------------------------
    def _chunk(self, t, name):
        return t.detach().chunk(self.M, dim=self.dims[name])[self.j].clone()

    def _shard(self, initial=False):
        """Whole -> slices: parameters, buffers and the moments."""
        swap = {}
        for name, p in self._params.items():
            piece = self._chunk(p.data, name)
            if initial:
                self._slices[name] = nn.Parameter(
                    piece, requires_grad=p.requires_grad)
            else:
                self._slices[name].data = piece
            s = self._slices[name]
            swap[p] = s
            state = self.optimizer.state.pop(p, None)
            if state:
                self.optimizer.state[s] = {
                    k: self._chunk(v, name) if _shaped_like(v, p) else v
                    for k, v in state.items()}
            p.data = p.data.new_empty(0)
        for name in self._buffers:
            owner, attr = _owner(self.model, name)
            whole = owner._buffers[attr]
            self._slices[name] = self._chunk(whole, name)
            owner._buffers[attr] = whole.new_empty(0)
        self._swap_params(swap)
        self.sharded = True

    def unshard(self):
        """Slices -> whole parameters, buffers and moments (collective
        over the model group)."""
        if not self.sharded:
            return
        names = list(self._slices)
        wholes = self._gather({n: self._slices[n].detach() for n in names})
        moments = {}
        for name, s in self._slices.items():
            state = self.optimizer.state.get(s) if name in self._params \
                else None
            for k, v in (state or {}).items():
                if _shaped_like(v, s):
                    moments[(name, k)] = v
        gathered = self._gather(moments, dims={
            key: self.dims[key[0]] for key in moments})
        swap = {}
        for name in names:
            if name in self._params:
                p, s = self._params[name], self._slices[name]
                p.data = wholes[name]
                swap[s] = p
                state = self.optimizer.state.pop(s, None)
                if state:
                    self.optimizer.state[p] = {
                        k: gathered.get((name, k), v)
                        for k, v in state.items()}
            else:
                owner, attr = _owner(self.model, name)
                owner._buffers[attr] = wholes[name]
        self._swap_params(swap)
        self.sharded = False

    @contextlib.contextmanager
    def gathered(self):
        """Whole parameters, buffers and moments for the block, sliced
        again after it (collective, on the training thread)."""
        self.unshard()
        try:
            yield
        finally:
            self._shard()

    def _swap_params(self, swap):
        for group in self.optimizer.param_groups:
            group["params"] = [swap.get(p, p) for p in group["params"]]

    def parameters(self):
        """The optimizer's parameters (slices where sharded), in order."""
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def sharded_parameters(self):
        return [self._slices[n] for n in self._params]

    def replicated_parameters(self):
        sliced = {id(s) for s in self.sharded_parameters()}
        return [p for p in self.parameters() if id(p) not in sliced]

    def at_rest_bytes(self):
        """Bytes this rank holds between steps: parameters, buffers and
        optimizer state."""
        tensors = {id(t): t for t in (*self.model.parameters(),
                                      *self.model.buffers(),
                                      *self._slices.values())}
        for state in self.optimizer.state.values():
            for v in state.values():
                if torch.is_tensor(v):
                    tensors[id(v)] = v
        return sum(t.numel() * t.element_size() for t in tensors.values())

    # -- collectives -------------------------------------------------------
    def _gather(self, pieces, dims=None):
        """{key: slice} -> {key: whole}, all-gathered over the model group
        in one flat bucket a dtype; ``dims`` {key: dim} (default:
        ``self.dims``)."""
        dims = self.dims if dims is None else dims
        out = {}
        by_dtype = {}
        for key, t in pieces.items():
            by_dtype.setdefault(t.dtype, []).append(key)
        group = self.grid.model_group
        # gloo gathers host tensors only: stage a card's bucket there
        staged = dist.get_backend(group.pg) == "gloo"
        for keys in by_dtype.values():
            flat = torch.cat([pieces[k].reshape(-1) for k in keys])
            send = flat.cpu() if staged else flat
            parts = [torch.empty_like(send) for _ in range(self.M)]
            dist.all_gather(parts, send, group=group.pg)
            parts = [part.to(flat.device) for part in parts]
            offset = 0
            for k in keys:
                shape, n = pieces[k].shape, pieces[k].numel()
                out[k] = torch.cat([part[offset:offset + n].view(shape)
                                    for part in parts], dim=dims[k])
                offset += n
        return out

    # -- the step ----------------------------------------------------------
    def call(self, fn, *args, **kwargs):
        """``fn(model, *args, **kwargs)`` on whole tensors gathered now;
        the whole parameters that take gradients are kept for
        ``reduce_gradients``."""
        whole = self._gather({n: s.detach() for n, s in self._slices.items()})
        for name, s in self._slices.items():
            if name in self._params and s.requires_grad:
                whole[name].requires_grad_(True)
        self._whole = whole
        return torch.func.functional_call(
            _Bound(self.model, fn),
            {f"model.{n}": t for n, t in whole.items()}, args, kwargs)

    def reduce_gradients(self):
        """Each rank's chunk of each sharded gradient, then the batch
        group's sum of every gradient, then the replicated ones from the
        model group's first rank."""
        for name in self._params:
            g = self._whole[name].grad
            self._slices[name].grad = None if g is None \
                else self._chunk(g, name)
        self._whole = None
        sync_gradients(self.parameters(), self.grid.batch_group)
        broadcast_gradients(self.replicated_parameters(),
                            self.grid.model_group)


def _shaped_like(v, p):
    return torch.is_tensor(v) and v.dim() > 0 and v.shape == p.shape
