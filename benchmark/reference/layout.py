"""The published checkpoint layouts: every tensor's name, shape and how the
benchmark draws it.

Names and shapes are those of NVIDIA/flowtron's ``Flowtron`` state_dict
(``flowtron.py``) and NVIDIA/waveglow's ``WaveGlow`` state_dict with its
weight_norm pairs folded into plain weights (``glow.py``). The program
loads these files through its own loaders; the reference reads the same
tensors by these names.

Draws (``init``):
- ``uniform``: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default for
  its layers (for WaveGlow's upsampling transposed conv, the fan-in an
  output sample actually sums); ``normal``: N(0, 1), torch's embedding init;
- ``head``: 0.05 N(0, 1), for the zero-initialised coupling heads (the
  flows' ``conv`` and WaveGlow's ``end``): at zero a flow is the identity
  and the layers before the head never reach the output;
- ``gate_off``: -20, the gate's bias: random weights would end every
  utterance within its first frames, so the gate is biased off and every
  request carries its full ``n_frames`` (the gate still runs);
- ``ones`` / ``zeros``; ``orthogonal``: a random rotation (det +1), the
  invertible 1x1 convolutions.
"""


def flowtron_layout(mc):
    """[(name, shape, init, fan_in)] of a Flowtron model_config (no
    Gaussian-mixture head, no cumulative attention)."""
    if int(mc.get("n_components", 0)) > 1 or mc.get("use_cumm_attention"):
        raise ValueError("the benchmark's layout covers the plain flows")
    H, A = mc["n_hidden"], mc["n_attn_channels"]
    S, E, M = mc["n_speaker_dim"], mc["n_text_dim"], mc["n_mel_channels"]
    out = [("speaker_embedding.weight", (mc["n_speakers"], S), "normal", 1),
           ("embedding.weight", (mc["n_text"], E), "normal", 1)]
    for i in range(3):
        p = f"encoder.convolutions.{i}"
        out += [(f"{p}.0.conv.weight", (E, E, 5), "uniform", 5 * E),
                (f"{p}.0.conv.bias", (E,), "uniform", 5 * E),
                (f"{p}.1.weight", (E,), "ones", 1),
                (f"{p}.1.bias", (E,), "zeros", 1)]
    for sfx in ("", "_reverse"):
        out += [(f"encoder.lstm.weight_ih_l0{sfx}", (2 * E, E), "uniform",
                 E // 2),
                (f"encoder.lstm.weight_hh_l0{sfx}", (2 * E, E // 2),
                 "uniform", E // 2),
                (f"encoder.lstm.bias_ih_l0{sfx}", (2 * E,), "uniform",
                 E // 2),
                (f"encoder.lstm.bias_hh_l0{sfx}", (2 * E,), "uniform",
                 E // 2)]
    D = E + S
    for f in range(mc["n_flows"]):
        p = f"flows.{f}" + (".ar_step" if f % 2 else "")
        out += [(f"{p}.conv.weight", (2 * M, H, 1), "head", 1),
                (f"{p}.conv.bias", (2 * M,), "zeros", 1)]
        for k in range(mc["n_lstm_layers"]):
            n_in = H + A if k == 0 else H
            out += [(f"{p}.lstm.weight_ih_l{k}", (4 * H, n_in), "uniform", H),
                    (f"{p}.lstm.weight_hh_l{k}", (4 * H, H), "uniform", H),
                    (f"{p}.lstm.bias_ih_l{k}", (4 * H,), "uniform", H),
                    (f"{p}.lstm.bias_hh_l{k}", (4 * H,), "uniform", H)]
        out += [(f"{p}.attention_lstm.weight_ih_l0", (4 * H, M), "uniform", H),
                (f"{p}.attention_lstm.weight_hh_l0", (4 * H, H), "uniform", H),
                (f"{p}.attention_lstm.bias_ih_l0", (4 * H,), "uniform", H),
                (f"{p}.attention_lstm.bias_hh_l0", (4 * H,), "uniform", H)]
        a = f"{p}.attention_layer"
        out += [(f"{a}.query.linear_layer.weight", (A, H), "uniform", H),
                (f"{a}.key.linear_layer.weight", (A, D), "uniform", D),
                (f"{a}.value.linear_layer.weight", (A, D), "uniform", D),
                (f"{a}.v.linear_layer.weight", (1, A), "uniform", A)]
        for k in range(2):
            d = f"{p}.dense_layer.layers.{k}.linear_layer"
            out += [(f"{d}.weight", (H, H), "uniform", H),
                    (f"{d}.bias", (H,), "uniform", H)]
        if f == mc["n_flows"] - 1 and mc.get("use_gate_layer", True):
            g = f"{p}.gate_layer.linear_layer"
            out += [(f"{g}.weight", (1, H + A), "uniform", H + A),
                    (f"{g}.bias", (1,), "gate_off", 1)]
    return out


def n_remaining(wc):
    """Audio channels left at the innermost flow after the early outputs."""
    n = wc["n_group"]
    for f in range(wc["n_flows"]):
        if f % wc["n_early_every"] == 0 and f > 0:
            n -= wc["n_early_size"]
    return n


def waveglow_layout(wc):
    """[(name, shape, init, fan_in)] of a waveglow_config."""
    M, G, C, L = (wc["n_mel_channels"], wc["n_group"], wc["n_channels"],
                  wc["n_layers"])
    K = wc["kernel_size"]
    # each upsampled sample sums M channels x 1024 / 256 taps: that is the
    # fan-in drawn here (torch's default counts all 1024 taps, which
    # leaves the conditioning at ~6% of the mel's scale and the audio
    # nearly blind to the mel)
    out = [("upsample.weight", (M, M, 1024), "uniform", M * 4),
           ("upsample.bias", (M,), "uniform", M * 4)]
    n_rem = G
    for f in range(wc["n_flows"]):
        if f % wc["n_early_every"] == 0 and f > 0:
            n_rem -= wc["n_early_size"]
        half = n_rem // 2
        out.append((f"convinv.{f}.conv.weight", (n_rem, n_rem, 1),
                    "orthogonal", n_rem))
        p = f"WN.{f}"
        out += [(f"{p}.start.weight", (C, half, 1), "uniform", half),
                (f"{p}.start.bias", (C,), "uniform", half),
                (f"{p}.end.weight", (2 * half, C, 1), "head", 1),
                (f"{p}.end.bias", (2 * half,), "zeros", 1),
                (f"{p}.cond_layer.weight", (2 * C * L, M * G, 1), "uniform",
                 M * G),
                (f"{p}.cond_layer.bias", (2 * C * L,), "uniform", M * G)]
        for k in range(L):
            n_rs = 2 * C if k < L - 1 else C
            out += [(f"{p}.in_layers.{k}.weight", (2 * C, C, K), "uniform",
                     C * K),
                    (f"{p}.in_layers.{k}.bias", (2 * C,), "uniform", C * K),
                    (f"{p}.res_skip_layers.{k}.weight", (n_rs, C, 1),
                     "uniform", C),
                    (f"{p}.res_skip_layers.{k}.bias", (n_rs,), "uniform", C)]
    return out
