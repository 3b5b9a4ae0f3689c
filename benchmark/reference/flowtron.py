"""Plain PyTorch inference of Flowtron (Valle et al. 2020, arXiv:2005.05957;
NVIDIA/flowtron ``flowtron.py``: ``Encoder.infer``, ``AR_Step.infer``,
``AR_Back_Step.infer``), on a published state dict, with no kernel, cache
or batching trick. Imports nothing of the program.

Inference inverts the flows in reverse order, frame by frame:
out_t = (z_t - b_t) exp(-log_s_t), (log_s, b) from the previous output
through the attention LSTM, additive attention over the text, the
decoder LSTMs, the tanh dense stack and the coupling head. A backward
flow runs on the time-reversed input. The gate (on the last flow) ends an
utterance at its first frame above the threshold, inclusive; frames past
it are silenced before vocoding.

``rounding`` (the control only) computes the flows in a lower
precision: both operands of every product (``_mm``) and every stored
activation (the LSTM states, the attention's scores, weights and
context, the coupling head's output, each frame) are rounded, as
``waveglow.fp8`` does; sums accumulate in fp32.

Departures from the published code, each the served program's defined
behaviour: a batch carries a key mask (padded text positions get no
attention), a backward flow reverses time within each row's valid frames
(padding stays last, reversed among itself), and the gate does not stop
the loop: every frame is computed and the valid length is kept beside it.
"""

import math

import torch
import torch.nn.functional as F

MASK_VALUE = -1e30
SILENCE = math.log(1e-5)     # the log-mel floor a silenced frame takes


def _mm(x, w, rounding=None):
    """x @ w.T, both rounded first where ``rounding`` is given."""
    if rounding is not None:
        x, w = rounding(x), rounding(w)
    return x @ w.t()


def _keep(x):
    return x


def _lstm_cell(x_proj, h, c, w_hh, rounding=None):
    r = rounding or _keep
    gates = r(x_proj + _mm(h, w_hh, rounding))
    i, f, g, o = gates.chunk(4, dim=-1)
    c = r(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g))
    return r(torch.sigmoid(o) * torch.tanh(c)), c


def _lstm_dir(sd, p, sfx, x, rounding=None):
    """One LSTM direction over (T, in) from zero state -> (T, H)."""
    w_ih, w_hh = sd[f"{p}.weight_ih_l0{sfx}"], sd[f"{p}.weight_hh_l0{sfx}"]
    xs = _mm(x, w_ih, rounding) + sd[f"{p}.bias_ih_l0{sfx}"] \
        + sd[f"{p}.bias_hh_l0{sfx}"]
    h = c = x.new_zeros(1, w_hh.shape[1])
    ys = []
    for t in range(x.shape[0]):
        h, c = _lstm_cell(xs[t:t + 1], h, c, w_hh, rounding)
        ys.append(h)
    return torch.cat(ys)


def encode(sd, ids, speaker, rounding=None):
    """One request's text: ids (n,) and its speaker index -> (n, 640), the
    encoder's outputs with the speaker vector beside each position."""
    x = sd["embedding.weight"][ids].t()[None]                   # (1, E, n)
    for i in range(3):
        p = f"encoder.convolutions.{i}"
        w = sd[f"{p}.0.conv.weight"]
        if rounding is not None:
            x, w = rounding(x), rounding(w)
        y = F.conv1d(x, w, sd[f"{p}.0.conv.bias"], padding=2)
        mean = y.mean(-1, keepdim=True)
        var = y.var(-1, keepdim=True, unbiased=False)
        y = (y - mean) / torch.sqrt(var + 1e-5)
        y = y * sd[f"{p}.1.weight"][None, :, None] \
            + sd[f"{p}.1.bias"][None, :, None]
        x = torch.relu(y)
    x = x[0].t()                                                # (n, E)
    fwd = _lstm_dir(sd, "encoder.lstm", "", x, rounding)
    bwd = _lstm_dir(sd, "encoder.lstm", "_reverse", x.flip(0),
                    rounding).flip(0)
    spk = sd["speaker_embedding.weight"][speaker]
    return torch.cat([fwd, bwd, spk[None].expand(x.shape[0], -1)], 1)


def _flip_within(z, n_valid):
    """(N, B, M) reversed in time within each row's n_valid frames; the
    frames past it reversed among themselves."""
    N = z.shape[0]
    t = torch.arange(N, device=z.device)[:, None]
    nv = n_valid[None, :]
    idx = torch.where(t < nv, nv - 1 - t, N - 1 - t + nv).clamp(0, N - 1)
    return torch.gather(z, 0, idx[:, :, None].expand_as(z))


def _flow_infer(sd, p, z, text, key_mask, gated, temperature=1.0,
                rounding=None):
    """Invert one flow (prefix ``p``) over z (N, B, M) with the text
    (B, Tk, D) and key mask (B, Tk). Returns (out (N, B, M), gate (N, B)
    or None)."""
    N, B, M = z.shape
    k_proj = _mm(text, sd[f"{p}.attention_layer.key.linear_layer.weight"],
                 rounding)
    vals = _mm(text, sd[f"{p}.attention_layer.value.linear_layer.weight"],
               rounding)
    w_q = sd[f"{p}.attention_layer.query.linear_layer.weight"]
    v_w = sd[f"{p}.attention_layer.v.linear_layer.weight"][0]
    a = f"{p}.attention_lstm"
    w_ih_a, w_hh_a = sd[f"{a}.weight_ih_l0"], sd[f"{a}.weight_hh_l0"]
    b_a = sd[f"{a}.bias_ih_l0"] + sd[f"{a}.bias_hh_l0"]
    H = w_hh_a.shape[1]
    layers = []
    k = 0
    while f"{p}.lstm.weight_ih_l{k}" in sd:
        layers.append((sd[f"{p}.lstm.weight_ih_l{k}"],
                       sd[f"{p}.lstm.weight_hh_l{k}"],
                       sd[f"{p}.lstm.bias_ih_l{k}"]
                       + sd[f"{p}.lstm.bias_hh_l{k}"]))
        k += 1
    dense = [(sd[f"{p}.dense_layer.layers.{j}.linear_layer.weight"],
              sd[f"{p}.dense_layer.layers.{j}.linear_layer.bias"])
             for j in range(2)]
    w_head = sd[f"{p}.conv.weight"][:, :, 0]
    b_head = sd[f"{p}.conv.bias"]
    if gated:
        w_g = sd[f"{p}.gate_layer.linear_layer.weight"]
        b_g = sd[f"{p}.gate_layer.linear_layer.bias"]
    r = rounding or _keep
    h_att = c_att = z.new_zeros(B, H)
    hs = [z.new_zeros(B, H) for _ in layers]
    cs = [z.new_zeros(B, H) for _ in layers]
    prev = z.new_zeros(B, M)
    outs, gates = [], []
    for t in range(N):
        h_att, c_att = _lstm_cell(_mm(prev, w_ih_a, rounding) + b_a, h_att,
                                  c_att, w_hh_a, rounding)
        q = _mm(h_att, w_q, rounding)
        scores = r(torch.tanh(r(q[:, None, :] + k_proj)) @ v_w) / temperature
        scores = scores.masked_fill(~key_mask, MASK_VALUE)
        w = r(torch.softmax(scores, dim=-1))
        context = r(torch.einsum("bk,bkd->bd", w, vals))
        x = torch.cat([h_att, context], dim=-1)
        if gated:
            gates.append(torch.sigmoid(_mm(x, w_g, rounding) + b_g)[:, 0])
        for j, (w_ih, w_hh, b) in enumerate(layers):
            hs[j], cs[j] = _lstm_cell(_mm(x, w_ih, rounding) + b, hs[j],
                                      cs[j], w_hh, rounding)
            x = hs[j]
        for w_d, b_d in dense:
            x = torch.tanh(_mm(x, w_d, rounding) + b_d)
        out2 = r(_mm(x, w_head, rounding) + b_head)
        prev = r((z[t] - out2[:, M:]) * torch.exp(-out2[:, :M]))
        outs.append(prev)
    return torch.stack(outs), torch.stack(gates) if gated else None


def infer(sd, mc, texts, residual, gate_threshold=0.5, rounding=None):
    """texts: [(n_i, D) encoder outputs]; residual (B, M, N) latents
    (sigma applied). Returns (mel (B, M, N) with frames past each row's
    end silenced, n_valid (B,))."""
    B, M, N = residual.shape
    Tk = max(t.shape[0] for t in texts)
    text = residual.new_zeros(B, Tk, texts[0].shape[1])
    key_mask = torch.zeros(B, Tk, dtype=torch.bool, device=residual.device)
    for b, t in enumerate(texts):
        text[b, :t.shape[0]] = t
        key_mask[b, :t.shape[0]] = True
    z = residual.permute(2, 0, 1)
    n_valid = torch.full((B,), N, dtype=torch.int64, device=residual.device)
    n_flows = mc["n_flows"]
    for i in reversed(range(n_flows)):
        gated = i == n_flows - 1 and mc.get("use_gate_layer", True)
        back = i % 2 == 1
        p = f"flows.{i}" + (".ar_step" if back else "")
        if back:
            z = _flip_within(z, n_valid)
        z, gates = _flow_infer(sd, p, z, text, key_mask, gated,
                               rounding=rounding)
        if gated:
            hit = gates > gate_threshold
            first = hit.to(torch.int64).argmax(dim=0)
            n_valid = torch.minimum(
                n_valid, torch.where(hit.any(dim=0), first + 1, N))
        if back:
            z = _flip_within(z, n_valid)
    mel = z.permute(1, 2, 0)
    n_valid = n_valid.clamp(min=1)
    valid = torch.arange(N, device=mel.device)[None, :] < n_valid[:, None]
    return torch.where(valid[:, None, :], mel, SILENCE), n_valid
