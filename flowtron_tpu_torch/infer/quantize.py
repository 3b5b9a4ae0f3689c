"""Quantized copies of a model's flows for inference (port of
flowtron_tpu/infer/quantize.py).

Modes: ``"w8"`` int8 weights with per-output-channel scales, ``"w8a8"``
the same leaves marked for int8 activations (kernel K4), ``"w4"`` packed
int4 weights with scales per group of 128 inputs. Only the flows' large
matrices are quantized, as in the JAX package: the ``lstm`` and
``attention_lstm`` input and recurrent weights, the attention's query,
key and value, and the dense layers, each when it has at least
``min_elems`` elements. Embeddings, the text encoder, biases, the gate,
the attention's ``v`` and the coupling head stay fp32.

The quantizers run the JAX package's numpy code on the (in, out)
transpose of each weight, so ``q``, ``q4`` and ``s`` are bit for bit the
JAX leaves, transposed to torch's (out, in) layout.
"""

import copy

import numpy as np
import torch

from flowtron_tpu_torch.utils.weights import QuantizedWeight, set_weight

MODES = ("w8", "w8a8", "w4")


def _jax_layout(w):
    """A torch (out, in) weight as the JAX package's (in, out) numpy."""
    return np.ascontiguousarray(w.detach().cpu().float().numpy().T)


def _torch_layout(a, device):
    return torch.from_numpy(np.ascontiguousarray(a.T)).to(device)


def _quantize_matrix(w, a8=False):
    """(out, in) float weight -> int8 ``QuantizedWeight`` (q (out, in),
    s (out,)): flowtron_tpu/infer/quantize.py:_quantize_matrix."""
    wj = _jax_layout(w)
    scale = np.abs(wj).max(axis=0) / 127.0
    scale = np.where(scale == 0, 1.0, scale)
    q = np.clip(np.round(wj / scale[None, :]), -127, 127).astype(np.int8)
    return QuantizedWeight(
        torch.from_numpy(scale.astype(np.float32)).to(w.device),
        q=_torch_layout(q, w.device), a8=a8)


def _quantize_matrix_int4(w, group=128):
    """(out, in) float weight -> int4 ``QuantizedWeight`` (q4 (out, in/2),
    s (out, n_groups)): flowtron_tpu/infer/quantize.py:_quantize_matrix_int4,
    its MSE-optimal clip search included. The search runs in float64 (a
    float32 array times numpy's float64 ``alpha``), and only the chosen
    scales are cast to fp32."""
    wj = _jax_layout(w)
    n_in, n_out = wj.shape
    if n_in % 2:
        raise ValueError(f"int4 packing needs an even input dim, got {n_in}")
    g = group if n_in % group == 0 else n_in
    n_groups = n_in // g
    wg = wj.reshape(n_groups, g, n_out)
    amax = np.abs(wg).max(axis=1)                  # (n_groups, out)
    amax = np.where(amax == 0, 1.0, amax)
    best_err = np.full_like(amax, np.inf)
    scale = amax / 7.0
    for alpha in np.linspace(0.55, 1.0, 10):
        s = amax * (alpha / 7.0)
        q = np.clip(np.round(wg / s[:, None, :]), -7, 7)
        err = ((q * s[:, None, :] - wg) ** 2).sum(axis=1)
        better = err < best_err
        best_err = np.where(better, err, best_err)
        scale = np.where(better, s, scale)
    q = np.clip(np.round(wg / scale[:, None, :]), -7, 7)
    q = q.astype(np.int32).reshape(n_in, n_out)
    lo = q[: n_in // 2] & 0xF
    hi = (q[n_in // 2:] & 0xF) << 4
    q4 = (lo | hi).astype(np.int8)                 # (in/2, out)
    return QuantizedWeight(_torch_layout(scale.astype(np.float32), w.device),
                           q4=_torch_layout(q4, w.device))


def _maybe_quantize(w, min_elems, a8, bits):
    if w.dim() == 2 and w.numel() >= min_elems:
        return _quantize_matrix_int4(w) if bits == 4 else \
            _quantize_matrix(w, a8=a8)
    return None


def quantizable_weights(model):
    """State-dict names of the weights the JAX package's quantizer visits
    (flowtron_tpu/infer/quantize.py:96-123), in its order."""
    names = []
    for i, flow in enumerate(model.flows):
        pre = f"flows.{i}" if i % 2 == 0 else f"flows.{i}.ar_step"
        step = getattr(flow, "ar_step", flow)
        for lstm in ("lstm", "attention_lstm"):
            for k in range(getattr(step, lstm).num_layers):
                names += [f"{pre}.{lstm}.weight_ih_l{k}",
                          f"{pre}.{lstm}.weight_hh_l{k}"]
        names += [f"{pre}.attention_layer.{n}.linear_layer.weight"
                  for n in ("query", "key", "value")]
        names += [f"{pre}.dense_layer.layers.{k}.linear_layer.weight"
                  for k in range(len(step.dense_layer.layers))]
    return names


@torch.no_grad()
def quantize_flows_for_inference(model, min_elems=65536, mode="w8"):
    """A copy of ``model`` whose flows' large matrices are
    ``QuantizedWeight`` leaves (for inference only; do not train on it).
    ``model`` itself is not changed."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; expected one of {MODES}")
    out = copy.deepcopy(model)
    params = dict(out.named_parameters())
    for name in quantizable_weights(out):
        leaf = _maybe_quantize(params[name], min_elems, mode == "w8a8",
                               4 if mode == "w4" else 8)
        if leaf is not None:
            set_weight(out, name, leaf)
    return out


def weight_shape(w):
    """The (out, in) shape of a float or quantized weight."""
    return tuple(w.shape)
