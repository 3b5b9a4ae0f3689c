"""Weight bridge: the JAX package's parameter pytrees (as numpy arrays) ->
the port's state_dicts.

``flowtron_state_dict_from_jax`` writes the reference names and layouts
that ``flowtron_tpu.train.checkpoints.export_torch_state_dict`` writes
(linear and LSTM weights transposed to torch's (out, in), 1x1 convs as
(out, in, 1)), so ``Flowtron.load_state_dict(..., strict=True)`` takes
it. ``waveglow_from_jax`` writes the published WaveGlow checkpoint names
(``upsample.*``, ``convinv.{f}.conv.weight``, ``WN.{f}.*``). Pure numpy in,
torch tensors out: nothing here imports jax.
"""

import numpy as np
import torch


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _lstm(out, prefix, lstm):
    for k, layer in enumerate(lstm["layers"]):
        dirs = [("", layer["fwd"]), ("_reverse", layer["bwd"])] \
            if "fwd" in layer else [("", layer)]
        for suffix, p in dirs:
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh")):
                out[f"{prefix}.{theirs}_l{k}{suffix}"] = _t(
                    np.asarray(p[ours]).T)
            out[f"{prefix}.bias_ih_l{k}{suffix}"] = _t(p["b_ih"])
            out[f"{prefix}.bias_hh_l{k}{suffix}"] = _t(p["b_hh"])


def _linear(out, name, p):
    out[f"{name}.weight"] = _t(np.asarray(p["w"]).T)
    if "b" in p:
        out[f"{name}.bias"] = _t(p["b"])


def flowtron_state_dict_from_jax(np_params):
    """JAX ``flowtron_init`` params (numpy leaves) -> reference state_dict."""
    p = np_params
    out = {"speaker_embedding.weight": _t(p["speaker_embedding"]["table"]),
           "embedding.weight": _t(p["embedding"]["table"])}
    for i, conv in enumerate(p["encoder"]["convolutions"]):
        pre = f"encoder.convolutions.{i}"
        out[f"{pre}.0.conv.weight"] = _t(conv["conv"]["w"])
        out[f"{pre}.0.conv.bias"] = _t(conv["conv"]["b"])
        out[f"{pre}.1.weight"] = _t(conv["norm"]["weight"])
        out[f"{pre}.1.bias"] = _t(conv["norm"]["bias"])
    _lstm(out, "encoder.lstm", p["encoder"]["lstm"])
    if "mel_encoder" in p or "gaussian_mixture" in p:
        raise NotImplementedError(
            "the Gaussian-mixture head and mel encoder are not ported yet; "
            "see ROADMAP.md Queue 1, 'GM head + MelEncoder'")
    for i, flow in enumerate(p["flows"]):
        if "attn_cond_layer" in flow:
            raise NotImplementedError(
                "cumulative attention is not ported yet; see ROADMAP.md "
                "Queue 1, 'Attention: cumulative-attention layer'")
        pre = f"flows.{i}" if i % 2 == 0 else f"flows.{i}.ar_step"
        out[f"{pre}.conv.weight"] = _t(
            np.asarray(flow["conv"]["w"]).T[:, :, None])
        out[f"{pre}.conv.bias"] = _t(flow["conv"]["b"])
        _lstm(out, f"{pre}.lstm", flow["lstm"])
        _lstm(out, f"{pre}.attention_lstm", flow["attention_lstm"])
        for name in ("query", "key", "value", "v"):
            _linear(out, f"{pre}.attention_layer.{name}.linear_layer",
                    flow["attention_layer"][name])
        for k, layer in enumerate(flow["dense_layer"]["layers"]):
            _linear(out, f"{pre}.dense_layer.layers.{k}.linear_layer", layer)
        if "gate_layer" in flow:
            _linear(out, f"{pre}.gate_layer.linear_layer",
                    flow["gate_layer"])
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
