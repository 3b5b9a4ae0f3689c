"""Weight bridge between the JAX package's parameter pytrees (as numpy
arrays) and the port's state_dicts, both ways.

``flowtron_state_dict_from_jax`` writes the reference names and layouts
that ``flowtron_tpu.train.checkpoints.export_torch_state_dict`` writes
(linear and LSTM weights transposed to torch's (out, in), 1x1 convs as
(out, in, 1)), so ``Flowtron.load_state_dict(..., strict=True)`` takes
it; ``flowtron_jax_from_state_dict`` is its inverse (the semantics of
``import_torch_state_dict``), filling a numpy pytree of the JAX layout.
``radam_state_from_jax`` maps a JAX ``RAdamState`` (numpy leaves) onto
the port's parameter names, so the two optimizers' moments can be
compared and a JAX checkpoint's moments loaded. ``flatten_jax`` gives a
pytree's flat keys as the JAX package's checkpoints name them, and
``flowtron_jax_keys`` the key of each state_dict name. ``jax_layout``
names the layout kind of a state_dict name, as ``_flowtron_entries``
assigns it, without a JAX pytree.
``waveglow_from_jax`` writes the published WaveGlow checkpoint names
(``upsample.*``, ``convinv.{f}.conv.weight``, ``WN.{f}.*``).
``quantized_model_from_jax`` carries a pytree that the JAX package's
``quantize_flows_for_inference`` made (int8 ``q``/``s`` leaves with or
without the ``a8`` marker, int4 ``q4``/``s``) into a copy of a port model.
Nothing here imports jax.
"""

import copy
import re

import numpy as np
import torch

from flowtron_tpu_torch.utils.weights import QuantizedWeight, set_weight


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# per kind: JAX array -> torch layout, and back
_LAYOUT = {
    "same": (lambda a: a, lambda a: a),
    "transpose": (lambda a: a.T, lambda a: a.T),
    "conv1x1": (lambda a: a.T[:, :, None], lambda a: a[:, :, 0].T),
}


def _lstm_entries(prefix, lstm):
    for k, layer in enumerate(lstm["layers"]):
        dirs = [("", layer["fwd"]), ("_reverse", layer["bwd"])] \
            if "fwd" in layer else [("", layer)]
        for suffix, p in dirs:
            yield f"{prefix}.weight_ih_l{k}{suffix}", p, "w_ih", "transpose"
            yield f"{prefix}.weight_hh_l{k}{suffix}", p, "w_hh", "transpose"
            yield f"{prefix}.bias_ih_l{k}{suffix}", p, "b_ih", "same"
            yield f"{prefix}.bias_hh_l{k}{suffix}", p, "b_hh", "same"


def _linear_entries(name, p):
    yield f"{name}.weight", p, "w", "transpose"
    if "b" in p:
        yield f"{name}.bias", p, "b", "same"


def _encoder_entries(prefix, enc):
    for i, conv in enumerate(enc["convolutions"]):
        pre = f"{prefix}.convolutions.{i}"
        yield f"{pre}.0.conv.weight", conv["conv"], "w", "same"
        yield f"{pre}.0.conv.bias", conv["conv"], "b", "same"
        yield f"{pre}.1.weight", conv["norm"], "weight", "same"
        yield f"{pre}.1.bias", conv["norm"], "bias", "same"
    yield from _lstm_entries(f"{prefix}.lstm", enc["lstm"])


# the reference registers each conditioning conv twice, as an attribute
# and inside ``conv_layers`` (reference:flowtron.py:138-148), so its
# state_dict holds both names (flowtron_tpu/train/checkpoints.py:117-131)
_ATTN_COND_NAMES = (("conv_hidden", "location_conv_hidden"),
                    ("conv_out", "location_conv_out"),
                    ("conv_hidden", "conv_layers.0"),
                    ("conv_out", "conv_layers.2"))


def _flowtron_entries(p):
    """Yield (state_dict name, JAX sub-dict, key in it, layout kind) for
    every parameter and buffer of a JAX ``flowtron_init`` pytree, in the
    names ``export_torch_state_dict`` writes."""
    yield "speaker_embedding.weight", p["speaker_embedding"], "table", "same"
    yield "embedding.weight", p["embedding"], "table", "same"
    yield from _encoder_entries("encoder", p["encoder"])
    if "mel_encoder" in p:
        yield from _encoder_entries("mel_encoder", p["mel_encoder"])
    if "gaussian_mixture" in p:
        gm = p["gaussian_mixture"]
        yield from _linear_entries("gaussian_mixture.prob_layer.linear_layer",
                                   gm["prob_layer"])
        if "mean" in gm:                  # the fixed-gaussian buffers
            yield "gaussian_mixture.mean", gm, "mean", "same"
            yield "gaussian_mixture.log_var", gm, "log_var", "same"
        else:
            for name in ("mean_layer", "log_var_layer"):
                yield from _linear_entries(
                    f"gaussian_mixture.{name}.linear_layer", gm[name])
    for i, flow in enumerate(p["flows"]):
        pre = f"flows.{i}" if i % 2 == 0 else f"flows.{i}.ar_step"
        yield f"{pre}.conv.weight", flow["conv"], "w", "conv1x1"
        yield f"{pre}.conv.bias", flow["conv"], "b", "same"
        yield from _lstm_entries(f"{pre}.lstm", flow["lstm"])
        yield from _lstm_entries(f"{pre}.attention_lstm",
                                 flow["attention_lstm"])
        for name in ("query", "key", "value", "v"):
            yield from _linear_entries(
                f"{pre}.attention_layer.{name}.linear_layer",
                flow["attention_layer"][name])
        for k, layer in enumerate(flow["dense_layer"]["layers"]):
            yield from _linear_entries(
                f"{pre}.dense_layer.layers.{k}.linear_layer", layer)
        if "gate_layer" in flow:
            yield from _linear_entries(f"{pre}.gate_layer.linear_layer",
                                       flow["gate_layer"])
        if "attn_cond_layer" in flow:
            for ours, theirs in _ATTN_COND_NAMES:
                conv = flow["attn_cond_layer"][ours]
                name = f"{pre}.attn_cond_layer.{theirs}.conv"
                yield f"{name}.weight", conv, "w", "same"
                yield f"{name}.bias", conv, "b", "same"


_TRANSPOSED = re.compile(r"(\.weight_(ih|hh)_l\d+(_reverse)?"
                         r"|\.linear_layer\.weight)$")
_CONV1X1 = re.compile(r"^flows\.\d+(\.ar_step)?\.conv\.weight$")


def jax_layout(name):
    """The layout kind ("same", "transpose" or "conv1x1") that
    ``_flowtron_entries`` gives the Flowtron state_dict name ``name``:
    LSTM and linear weights are transposed, the flows' 1x1 head convs are
    2-D in JAX, every other leaf keeps its shape."""
    if _CONV1X1.match(name):
        return "conv1x1"
    return "transpose" if _TRANSPOSED.search(name) else "same"


def flowtron_state_dict_from_jax(np_params):
    """JAX ``flowtron_init`` params (numpy leaves) -> reference state_dict.
    A leaf that holds no array (optax's ``MaskedNode`` where a moment tree
    has a frozen parameter) has no entry."""
    return {name: _t(_LAYOUT[kind][0](np.asarray(sub[key])))
            for name, sub, key, kind in _flowtron_entries(np_params)
            if hasattr(sub[key], "shape")}


def flatten_jax(tree, prefix=""):
    """A JAX pytree's flat keys, as flowtron_tpu/train/checkpoints.py:
    _flatten writes them (``flows.0.lstm.layers.0.w_ih``) -> leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flatten_jax(v, f"{prefix}{k}."))
    return out


def unflatten_jax(flat, template, prefix=""):
    """``flatten_jax``'s inverse, in the structure of ``template``."""
    if isinstance(template, dict):
        return {k: unflatten_jax(flat, v, f"{prefix}{k}.")
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_jax(flat, v, f"{prefix}{i}.")
                              for i, v in enumerate(template))
    return flat[prefix[:-1]]


def flowtron_jax_keys(np_params):
    """{state_dict name: the JAX flat key of its leaf}; the reference's
    alias names share one leaf, so one key."""
    key_of = {id(v): k for k, v in flatten_jax(np_params).items()}
    return {name: key_of[id(sub[key])]
            for name, sub, key, _ in _flowtron_entries(np_params)}


def _quantized_leaf(leaf, device):
    """A JAX quantized leaf (numpy (in, out) arrays) -> a
    ``QuantizedWeight`` in torch's (out, in) layout."""
    def t(a):
        return torch.from_numpy(np.array(np.asarray(a).T)).to(device)
    if "q" in leaf:
        return QuantizedWeight(t(leaf["s"]), q=t(leaf["q"]),
                               a8="a8" in leaf)
    return QuantizedWeight(t(leaf["s"]), q4=t(leaf["q4"]))


def quantized_model_from_jax(model, np_params):
    """A copy of ``model`` holding the weights of a JAX params pytree
    (numpy leaves) whose flows ``quantize_flows_for_inference`` quantized:
    each quantized leaf becomes a ``QuantizedWeight``, every other
    parameter is loaded as ``flowtron_state_dict_from_jax`` writes it."""
    out = copy.deepcopy(model)
    device = next(out.parameters()).device
    state, quantized = {}, []
    for name, sub, key, kind in _flowtron_entries(np_params):
        if isinstance(sub[key], dict):
            set_weight(out, name, _quantized_leaf(sub[key], device))
            quantized.append(name)
        else:
            state[name] = _t(_LAYOUT[kind][0](np.asarray(sub[key])))
    missing, unexpected = out.load_state_dict(state, strict=False)
    loose = [k for k in missing if k.rpartition(".")[0] not in quantized]
    if loose or unexpected:
        raise KeyError(f"state mismatch: missing {loose}, unexpected "
                       f"{unexpected}")
    return out


def flowtron_jax_from_state_dict(state_dict, like):
    """Reference state_dict -> a numpy pytree of the JAX layout, with the
    structure of ``like`` (a JAX ``flowtron_init`` pytree or a numpy copy
    of one, which is not modified). Every parameter must be present."""
    out = _copy_tree(like)
    for name, sub, key, kind in _flowtron_entries(out):
        value = state_dict[name].detach().cpu().float().numpy()
        sub[key] = np.ascontiguousarray(_LAYOUT[kind][1](value))
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_tree(v) for v in tree)
    return np.asarray(tree)


def radam_state_from_jax(np_state):
    """A JAX ``RAdamState`` (count, exp_avg, exp_avg_sq with numpy leaves,
    the moments shaped like the params) -> ``{"step": int, "exp_avg":
    {name: tensor}, "exp_avg_sq": {name: tensor}}`` in the port's names
    and layouts; a frozen (``MaskedNode``) leaf has no entry."""
    return {"step": int(np.asarray(np_state.count)),
            "exp_avg": flowtron_state_dict_from_jax(np_state.exp_avg),
            "exp_avg_sq": flowtron_state_dict_from_jax(np_state.exp_avg_sq)}


def radam_state_by_name(model, optimizer):
    """The port's optimizer state in the shape ``radam_state_from_jax``
    gives, for the parameters that have state."""
    out = {"step": None, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in model.named_parameters():
        state = optimizer.state.get(p)
        if not state:
            continue
        out["step"] = int(state["step"])
        out["exp_avg"][name] = state["exp_avg"].detach().cpu()
        out["exp_avg_sq"][name] = state["exp_avg_sq"].detach().cpu()
    return out


def waveglow_from_jax(np_params, config):
    """JAX ``waveglow_init`` params (numpy leaves) -> WaveGlow state_dict
    in the published checkpoint's names."""
    p = np_params
    out = {"upsample.weight": _t(p["upsample"]["w"]),
           "upsample.bias": _t(p["upsample"]["b"])}
    for f in range(config["n_flows"]):
        out[f"convinv.{f}.conv.weight"] = _t(
            np.asarray(p["convinv"][f]["w"])[:, :, None])
        wn = p["wn"][f]
        for ours, theirs in (("start", "start"), ("end", "end"),
                             ("cond", "cond_layer")):
            out[f"WN.{f}.{theirs}.weight"] = _t(wn[ours]["w"])
            out[f"WN.{f}.{theirs}.bias"] = _t(wn[ours]["b"])
        for kind in ("in_layers", "res_skip_layers"):
            for k in range(config["n_layers"]):
                out[f"WN.{f}.{kind}.{k}.weight"] = _t(wn[kind][k]["w"])
                out[f"WN.{f}.{kind}.{k}.bias"] = _t(wn[kind][k]["b"])
    return out
