"""Quantized weight leaves and the dot that takes them (port of
flowtron_tpu/utils/weights.py).

A ``QuantizedWeight`` stands where a float weight would, in torch's
(out, in) layout (the JAX leaves are (in, out); ``infer/quantize.py`` and
``utils/convert.py`` transpose at the boundary):

- int8: ``q`` (out, in) int8 and ``s`` (out,) fp32 per-output-channel
  scales; ``a8`` marks the leaf for int8 activations (kernel K4's W8A8
  body).
- int4: ``q4`` (out, in/2) int8, two nibbles a byte: column c holds input
  c in its low nibble and input c + in/2 in its high nibble; ``s`` (out,
  n_groups) fp32 scales of the input groups.

``resolve_weight`` and ``qdot`` follow the JAX functions exactly, route
included: an ``a8`` leaf whose dot has at most 512 rows goes to K4
(``ops/qmm.py``: the kernel on CUDA tensors, its plain version on CPU
tensors); every other dot dequantizes with bf16 scales and multiplies
with fp32 accumulation.

A ``ShardedWeight`` is a serving mesh's column-sharded leaf (the
engine's ``mesh_shape``): the (out, in) weight, float or quantized, split
along out (JAX's last axis) into one slice a device of a model group.
``qdot`` multiplies each slice on its own device, with K4 for an ``a8``
slice there, and concatenates the outputs on the device of x, the group's
first. JAX quantizes the flows before it places them
(flowtron_tpu/serve/engine.py:76-81, :275), so its rule shards the int8
and int4 payloads as it would the float leaf; ``shard_flows`` does the
same.
"""

import torch
import torch.nn.functional as F
from torch import nn

from flowtron_tpu_torch.ops.qmm import quantized_matmul

QMM_MAX_ROWS = 512      # flowtron_tpu/utils/weights.py:_qmm_eligible


class QuantizedWeight(nn.Module):
    """A quantized weight leaf; ``q``/``q4`` and ``s`` are buffers, so the
    leaf moves with its model (``.to(device)``)."""

    def __init__(self, s, q=None, q4=None, a8=False):
        super().__init__()
        if (q is None) == (q4 is None):
            raise ValueError("give exactly one of q (int8) and q4 (int4)")
        if q is not None:
            self.register_buffer("q", q)
        else:
            self.register_buffer("q4", q4)
        self.register_buffer("s", s)
        self.a8 = bool(a8)

    @property
    def int4(self):
        return "q4" in self._buffers

    @property
    def shape(self):
        """The (out, in) shape of the float weight this leaf stands for."""
        if self.int4:
            return (self.q4.shape[0], 2 * self.q4.shape[1])
        return tuple(self.q.shape)


def resolve_weight(w, dtype=None):
    """The (out, in) float weight of a leaf, cast to ``dtype`` (default
    bf16), with the numbers the JAX package's ``resolve_weight``
    (flowtron_tpu/utils/weights.py:18-35) gives inside its compiled
    inference programs. The JAX code multiplies the integers by their
    scales rounded to bf16, in bf16. Compiled by XLA, the int8 product
    stays fp32 (XLA's default excess precision drops the bf16 rounding
    before the cast to fp32); the int4 product, reshaped between the
    multiply and the cast, is rounded to bf16. Int4 is a sign-extending
    nibble unpack, low half of the inputs then high half, times the group
    scales. A tensor comes back as it is."""
    if not isinstance(w, QuantizedWeight):
        return w
    s = w.s.to(torch.bfloat16).float()
    if w.int4:
        qi = w.q4.to(torch.int32)
        lo = ((qi & 0xF) ^ 8) - 8                    # sign-extended nibbles
        hi = qi >> 4
        full = torch.cat([lo, hi], dim=1).float()     # (out, in)
        n_out, n_groups = s.shape
        out = (full.reshape(n_out, n_groups, -1) * s[:, :, None]) \
            .reshape(n_out, -1).to(torch.bfloat16)
    else:
        out = w.q.float() * s[:, None]
    return out.to(dtype or torch.bfloat16)


class ShardedWeight(nn.Module):
    """An (out, in) weight (or a conv's (out, in, k)) split along dim 0:
    ``parts[j]``, a tensor or a ``QuantizedWeight``, on ``devices[j]``.
    The parts are not registered, so ``.to()`` of a model leaves them where
    they were placed. Indexing that keeps dim 0 whole applies to every
    part (``w[:, :, 0]`` of a 1x1 conv)."""

    def __init__(self, parts, devices):
        super().__init__()
        self.parts, self.devices = list(parts), list(devices)

    @property
    def shape(self):
        rest = tuple(self.parts[0].shape[1:])
        return (sum(p.shape[0] for p in self.parts),) + rest

    @property
    def dtype(self):
        return self.parts[0].dtype

    def __getitem__(self, index):
        if not (isinstance(index, tuple) and index[0] == slice(None)):
            raise IndexError("a ShardedWeight is indexed with dim 0 whole")
        return ShardedWeight([p[index] for p in self.parts], self.devices)


def _split_leaf(w, devices):
    """A tensor or ``QuantizedWeight`` -> its len(devices) slices along dim
    0, slice j on devices[j]."""
    n = len(devices)
    if isinstance(w, QuantizedWeight):
        qs = (w.q4 if w.int4 else w.q).chunk(n, 0)
        return [QuantizedWeight(s.contiguous(), a8=w.a8,
                                **{"q4" if w.int4 else "q": q.contiguous()})
                .to(d) for s, q, d in zip(w.s.chunk(n, 0), qs, devices)]
    return [t.detach().contiguous().to(d)
            for t, d in zip(w.chunk(n, 0), devices)]


@torch.no_grad()
def shard_flows(model, devices):
    """In place: every weight of ``model``'s flows that JAX's
    ``param_shardings`` shards over a ``model`` axis of len(devices)
    (parallel/mesh.py:jax_split_dim, on the float leaf's shape, which a
    quantized leaf keeps) becomes a ``ShardedWeight`` over ``devices``;
    every other leaf stays where it is. Each flow is marked ``on_mesh``,
    which keeps it off kernel K1 (models/ar_step.py:in_k1_subset), one
    device or many. Returns the sharded names."""
    from flowtron_tpu_torch.parallel.mesh import jax_split_dim
    for flow in model.flows:
        getattr(flow, "ar_step", flow).on_mesh = True
    leaves = [(n, m) for n, m in model.named_modules()
              if isinstance(m, QuantizedWeight)]
    leaves += list(model.named_parameters())
    done = []
    for name, w in leaves:
        if not name.startswith("flows.") or \
                jax_split_dim(name, w.shape, len(devices)) != 0:
            continue
        set_weight(model, name, ShardedWeight(_split_leaf(w, devices),
                                              devices))
        done.append(name)
    return done


def _part_dot(x, w, out_dtype):
    if isinstance(w, QuantizedWeight):
        return qdot(x, w, out_dtype)
    dt = torch.promote_types(x.dtype, w.dtype)   # as ``layers.linear``
    out = F.linear(x.to(dt), w.to(dt))
    return out if out_dtype is None else out.to(out_dtype)


def qdot(x, w, out_dtype=None):
    """``x @ w.T`` for a float, quantized or sharded (out, in) weight ``w``.

    A float weight is a plain matmul, as before quantization existed. A
    quantized one goes to K4 when it carries ``a8`` and the dot has at
    most 512 rows (all leading dims of x multiplied); otherwise it is
    ``resolve_weight`` and a matmul with fp32 accumulation. A sharded one
    is each slice's product on its device, concatenated on x's. The
    result is ``out_dtype`` (default x's dtype)."""
    if isinstance(w, ShardedWeight):
        outs = [_part_dot(x.to(d), p, out_dtype)
                for p, d in zip(w.parts, w.devices)]
        return torch.cat([o.to(x.device) for o in outs], dim=-1)
    if not isinstance(w, QuantizedWeight):
        out = x @ w.t()
        return out if out_dtype is None else out.to(out_dtype)
    out_dtype = out_dtype or x.dtype
    lead, k = x.shape[:-1], x.shape[-1]
    if w.a8 and x.numel() // max(k, 1) <= QMM_MAX_ROWS:
        out = quantized_matmul(x.reshape(-1, k).contiguous(), w.q, w.s,
                               a8=True)
        return out.reshape(*lead, out.shape[-1]).to(out_dtype)
    wd = resolve_weight(w, x.dtype)
    return F.linear(x.float(), wd.float()).to(out_dtype)


@torch.no_grad()
def to_bf16(module):
    """The JAX serving engine's ``--bf16`` cast rule
    (flowtron_tpu/serve/engine.py:90-101, :112-117), in place: every fp32
    parameter and buffer of ``module`` goes to bf16, except inside a
    ``QuantizedWeight``, whose int payload and fp32 scales stay as they
    are (``module.to(torch.bfloat16)`` would cast the scales too). The
    modules' kernel packs are dropped, so they pack anew. Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, QuantizedWeight):
            continue
        for name, p in m._parameters.items():
            if p is not None and p.dtype == torch.float32:
                m._parameters[name] = nn.Parameter(
                    p.to(torch.bfloat16), requires_grad=p.requires_grad)
        for name, b in m._buffers.items():
            if b is not None and b.dtype == torch.float32:
                m._buffers[name] = b.to(torch.bfloat16)
        if getattr(m, "_packed", None) is not None:
            m._packed = None
    return module


def is_quantized(module):
    """Whether any weight of ``module`` is a ``QuantizedWeight``."""
    return any(isinstance(m, QuantizedWeight) for m in module.modules())


def set_weight(model, name, leaf):
    """Put ``leaf`` (a ``QuantizedWeight``) where the parameter ``name``
    (a dotted state_dict name) was."""
    parent_name, _, attr = name.rpartition(".")
    parent = model.get_submodule(parent_name)
    if attr in parent._parameters:
        del parent._parameters[attr]
    setattr(parent, attr, leaf)
