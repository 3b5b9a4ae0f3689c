"""K1: one flow's whole inverse AR scan in one host call (port of
flowtron_tpu/ops/decoder_pallas.py: ``pack_flow_weights`` and
``fused_flow_infer``).

On CUDA tensors ``fused_flow_infer`` launches the hand-written kernel
sequence of ``csrc/decoder.cu`` (its note says what bounds it and how the
design answers); on CPU tensors it runs ``fused_flow_infer_reference``,
the plain PyTorch version of the same math on the same packed weights.

Supported subset, as on the TPU: no attention prior, no cumulative or
external attention, unquantized weights, scalar temperature; fp32 only.

Early exit (``early_exit=True``): once every stream has finished — its
gate fired above ``gate_threshold`` or its frame index reached
``n_valid_in`` — every later frame does no work and writes mel = 0,
attn = 0, gate = 1. Frames up to each stream's finish equal the
``early_exit=False`` run. The TPU kernel decides this per 16-frame chunk;
here it is decided per frame.
"""

import ctypes

import torch
import torch.nn.functional as F

from flowtron_tpu_torch.ops import _build

MASK_VALUE = -1e9


def _pad4(n):
    return (n + 3) // 4 * 4


def _pad_cols(w, n):
    return F.pad(w, (0, n - w.shape[-1]))


def _pack_lstm(w_ih, w_hh, b_ih, b_hh):
    """(4H, K) + (4H, H) torch-layout LSTM weights -> (4H, P(K) + P(H)) with
    row 4u + g = gate g of unit u, and the pre-summed bias interleaved
    the same way."""
    H = w_hh.shape[1]
    w = torch.cat([_pad_cols(w_ih, _pad4(w_ih.shape[1])),
                   _pad_cols(w_hh, _pad4(H))], dim=1)
    w = w.reshape(4, H, -1).transpose(0, 1).reshape(4 * H, -1)
    b = (b_ih + b_hh).reshape(4, H).t().reshape(-1)
    return w.contiguous(), b.contiguous()


@torch.no_grad()
def pack_flow_weights(flow):
    """Flatten one ``ARStep`` module into the kernel's packed fp32 layout
    (documented at ``fused_flow_infer_f32`` in csrc/decoder.cu).

    Rows are padded to a multiple of 4 floats so every row starts 16-byte
    aligned; the result is new storage, never a view.
    """
    H = flow.lstm.hidden_size
    att = flow.attention_layer
    head_w = flow.conv.weight[:, :, 0]                    # (2M, H)
    M = head_w.shape[0] // 2
    att_w, att_b = _pack_lstm(*flow.attention_lstm.layer_weights(0))

    def rows(w):                                          # (out, P(in))
        return _pad_cols(w, _pad4(w.shape[1])).contiguous()

    out = {
        "att_w": att_w, "att_b": att_b,
        "q_w": rows(att.query.linear_layer.weight),
        "q_b": torch.zeros(att.query.linear_layer.weight.shape[0],
                           device=head_w.device),
        "v_w": att.v.linear_layer.weight[0].clone(),
        "lstm": [_pack_lstm(*flow.lstm.layer_weights(k))
                 for k in range(flow.lstm.num_layers)],
        "dense": [(rows(lin.linear_layer.weight),
                   lin.linear_layer.bias.clone())
                  for lin in flow.dense_layer.layers],
        # (2M, H) -> rows (2m, 2m+1) = (log_s_m, b_m)
        "head_w": rows(head_w.reshape(2, M, H).transpose(0, 1)
                       .reshape(2 * M, H)),
        "head_b": flow.conv.bias.reshape(2, M).t().reshape(-1).contiguous(),
    }
    if hasattr(flow, "gate_layer"):
        out["gate_w"] = flow.gate_layer.linear_layer.weight[0].clone()
        out["gate_b"] = flow.gate_layer.linear_layer.bias.clone()
    return out


def _dims(w):
    H = w["att_w"].shape[0] // 4
    M = w["head_b"].shape[0] // 2
    D = w["q_w"].shape[0]
    return M, H, D


def fused_flow_infer_reference(weights, residual, k_proj, vals, key_mask,
                               temperature, early_exit=False,
                               gate_threshold=1e6, n_valid_in=None):
    """Plain PyTorch version of ``fused_flow_infer`` (same arguments, same
    packed weights, same outputs)."""
    w = weights
    N, B, _ = residual.shape
    M, H, D = _dims(w)
    Tk = k_proj.shape[1]
    dev = residual.device
    if n_valid_in is None:
        n_valid_in = torch.full((B,), N, dtype=torch.int32, device=dev)

    def cell(wt, bias, x, h, c):
        xin = torch.cat([_pad_cols(x, _pad4(x.shape[-1])),
                         _pad_cols(h, _pad4(H))], dim=-1)
        g = (xin @ wt.t() + bias).view(B, H, 4)
        c = torch.sigmoid(g[..., 1]) * c \
            + torch.sigmoid(g[..., 0]) * torch.tanh(g[..., 2])
        return torch.sigmoid(g[..., 3]) * torch.tanh(c), c

    def matvec(wt, bias, x):
        return _pad_cols(x, wt.shape[1]) @ wt.t() + bias

    mel = residual.new_zeros(N, B, M)
    attn = residual.new_zeros(N, B, Tk)
    gates = residual.new_zeros(N, B)
    zeros = residual.new_zeros(B, H)
    h_att, c_att = zeros, zeros
    hs = [zeros] * len(w["lstm"])
    cs = [zeros] * len(w["lstm"])
    prev = residual.new_zeros(B, M)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(N):
        h_att, c_att = cell(w["att_w"], w["att_b"], prev, h_att, c_att)
        q = matvec(w["q_w"], w["q_b"], h_att)
        scores = torch.tanh(q[:, None, :] + k_proj) @ w["v_w"]
        scores = scores / temperature
        scores = torch.where(key_mask > 0.5, scores, MASK_VALUE)
        e = torch.exp(scores - scores.max(dim=-1, keepdim=True).values)
        a = e / e.sum(dim=-1, keepdim=True)
        ctx = torch.einsum("bk,bkd->bd", a, vals)
        x = torch.cat([h_att, ctx], dim=-1)
        gate = torch.sigmoid(x @ w["gate_w"] + w["gate_b"]) \
            if "gate_w" in w else residual.new_zeros(B)
        for k, (lw, lb) in enumerate(w["lstm"]):
            hs[k], cs[k] = cell(lw, lb, x, hs[k], cs[k])
            x = hs[k]
        for dw, db in w["dense"]:
            x = torch.tanh(matvec(dw, db, x))
        out2 = matvec(w["head_w"], w["head_b"], x).view(B, M, 2)
        prev = (residual[t] - out2[..., 1]) * torch.exp(-out2[..., 0])
        mel[t], attn[t], gates[t] = prev, a, gate
        if early_exit:
            done |= (gate > gate_threshold) | (t + 1 >= n_valid_in)
            if bool(done.all()):
                gates[t + 1:] = 1.0
                break
    return mel, attn, gates


def _lib():
    lib = _build.load_library("decoder")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        pp = ctypes.POINTER(ctypes.c_void_p)
        lib.fused_flow_infer_f32.argtypes = (
            [p] * 10 + [pp, pp, i, pp, pp, i] + [p] * 9
            + [i] * 6 + [f, f, i, p])
        lib.fused_flow_infer_f32.restype = ctypes.c_int
        lib.decoder_workspace_floats.argtypes = [i, i, i, i]
        lib.decoder_workspace_floats.restype = ctypes.c_longlong
        lib.decoder_workspace_ints.argtypes = [i]
        lib.decoder_workspace_ints.restype = i
        lib.decoder_error_string.argtypes = [i]
        lib.decoder_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def fused_flow_infer(weights, residual, k_proj, vals, key_mask, temperature,
                     early_exit=False, gate_threshold=1e6, n_valid_in=None):
    """Run one flow's full inverse scan.

    Args:
      weights: dict from ``pack_flow_weights``.
      residual: (N, B, M) latents. k_proj / vals: (B, Tk, D) from
        ``attention_precompute``. key_mask: (B, Tk) float, 1 = valid.
      temperature: scalar. gate_threshold / n_valid_in ((B,) ints or None
        for N): only consulted when ``early_exit``.

    Returns (mel (N, B, M), attn (N, B, Tk), gates (N, B)), float32.
    On CPU tensors this is ``fused_flow_infer_reference``; on CUDA tensors
    it launches csrc/decoder.cu or raises.
    """
    if residual.device.type == "cpu":
        return fused_flow_infer_reference(
            weights, residual, k_proj, vals, key_mask, temperature,
            early_exit, gate_threshold, n_valid_in)
    if residual.device.type != "cuda":
        raise ValueError(f"no kernel for device {residual.device}")
    dev = residual.device
    N, B, M = residual.shape
    M_w, H, D = _dims(weights)
    Tk = k_proj.shape[1]
    if M_w != M:
        raise ValueError(f"residual has {M} mel channels, weights {M_w}")
    Hp = _pad4(H)
    _build.check_tensor("residual", residual, (N, B, M), dev)
    _build.check_tensor("k_proj", k_proj, (B, Tk, D), dev)
    _build.check_tensor("vals", vals, (B, Tk, D), dev)
    _build.check_tensor("key_mask", key_mask, (B, Tk), dev)
    expect = {
        "att_w": (4 * H, _pad4(M) + Hp), "att_b": (4 * H,),
        "q_w": (D, Hp), "q_b": (D,), "v_w": (D,),
        "head_w": (2 * M, Hp), "head_b": (2 * M,),
    }
    has_gate = "gate_w" in weights
    if has_gate:
        expect.update(gate_w=(H + D,), gate_b=(1,))
    for k, shape in expect.items():
        _build.check_tensor(k, weights[k], shape, dev)
    for k, (lw, lb) in enumerate(weights["lstm"]):
        kx = H + D if k == 0 else H
        _build.check_tensor(f"lstm[{k}].w", lw, (4 * H, _pad4(kx) + Hp),
                            dev)
        _build.check_tensor(f"lstm[{k}].b", lb, (4 * H,), dev)
    for k, (dw, db) in enumerate(weights["dense"]):
        _build.check_tensor(f"dense[{k}].w", dw, (H, Hp), dev)
        _build.check_tensor(f"dense[{k}].b", db, (H,), dev)
    if n_valid_in is None:
        nvin = torch.full((B,), N, dtype=torch.int32, device=dev)
    else:
        nvin = n_valid_in.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(nvin.shape) != (B,):
            raise ValueError(f"n_valid_in has shape {tuple(nvin.shape)}")

    lib = _lib()
    n_layers, n_dense = len(weights["lstm"]), len(weights["dense"])
    mel = torch.empty(N, B, M, device=dev)
    attn = torch.empty(N, B, Tk, device=dev)
    gates = torch.empty(N, B, device=dev)
    work = torch.empty(lib.decoder_workspace_floats(B, H, D, n_layers),
                       device=dev)
    iwork = torch.empty(lib.decoder_workspace_ints(B), dtype=torch.int32,
                        device=dev)

    def ptrs(ts):
        return (ctypes.c_void_p * max(1, len(ts)))(*[t.data_ptr() for t in ts])

    gate_w = weights["gate_w"].data_ptr() if has_gate else None
    gate_b = weights["gate_b"].data_ptr() if has_gate else None
    err = lib.fused_flow_infer_f32(
        residual.data_ptr(), k_proj.data_ptr(), vals.data_ptr(),
        key_mask.data_ptr(), nvin.data_ptr(),
        weights["att_w"].data_ptr(), weights["att_b"].data_ptr(),
        weights["q_w"].data_ptr(), weights["q_b"].data_ptr(),
        weights["v_w"].data_ptr(),
        ptrs([lw for lw, _ in weights["lstm"]]),
        ptrs([lb for _, lb in weights["lstm"]]), n_layers,
        ptrs([dw for dw, _ in weights["dense"]]),
        ptrs([db for _, db in weights["dense"]]), n_dense,
        weights["head_w"].data_ptr(), weights["head_b"].data_ptr(),
        gate_w, gate_b, mel.data_ptr(), attn.data_ptr(), gates.data_ptr(),
        work.data_ptr(), iwork.data_ptr(), N, B, M, H, D, Tk,
        float(temperature), float(gate_threshold), int(bool(early_exit)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("fused_flow_infer_f32 failed: "
                           + lib.decoder_error_string(err).decode())
    fused_flow_infer.launches += 1
    return mel, attn, gates


fused_flow_infer.launches = 0
