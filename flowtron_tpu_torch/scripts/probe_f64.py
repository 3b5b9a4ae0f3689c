"""How far P4's and P5's kernels and their plain versions each lie from a
float64 evaluation of the same recurrence: every dot input rounded where
the scripts round it (bf16, or W8A8's int8 values), the sums, scales,
activations and blends in float64. Seeded inputs at the scripts' shapes.

    python -m flowtron_tpu_torch.scripts.probe_f64 [--steps S]

P4 (both chains at B = 1, 8 and 12, S steps, and B = 12 at 3 steps as the
card test runs it): the kernel (``resident_scan``) and the plain version
(``resident_scan_reference``) against float64, state and gates, each
relative to the float64 value's largest magnitude. Then the kernel's
chain dot by dot: one-dot launches from the kernel's own fp32 input
reproduce its scan (``per_dot_reproduces_scan``), so each of its dots
can be held against a float64 dot on the same input (``kernel_dot_f64``;
the plain version's dots likewise, ``plain_dot_f64``) and against the
plain dot on the same input (``kernel_dot_plain``), free of what
earlier dots carried. ``roundings`` counts the dot inputs (bf16 or int8
values) that two chains round to different values, kernel against plain
and plain against float64; ``first_kernel_vs_plain_at`` is the first
(step, dot) where the kernel's and the plain chain's differ.
``rows_independent``: at B = 12 the kernel's rows 0-7 and 8-11 equal
launches of those rows alone, bit for bit.

P5 (each variant at B = 1 and 8, S steps): the kernel (``fused_cost``) and
the plain version against float64 over the mel, the largest
kernel-vs-plain difference step by step, and the bf16 roundings in which
the plain recurrence and the float64 one differ
(``roundings_plain_vs_f64``; the kernel's hidden state stays on the card,
so its own are not seen).

Prints the card's name and power limit, then one JSON line a case.
Needs CUDA.
"""

import argparse
import json
import subprocess

import torch

from flowtron_tpu_torch.ops.fused_cost import VARIANTS, fused_cost, \
    fused_cost_reference
from flowtron_tpu_torch.ops.resident import EPS, INV_127, blend, \
    consume_gates, quantize_rows, resident_scan, resident_scan_reference
from flowtron_tpu_torch.scripts import exp_fused_cost as p5
from flowtron_tpu_torch.scripts import exp_fused_int8 as p4


def rel(a, ref):
    """max |a - ref| over max |ref|, in float64."""
    ref = ref.double()
    return float((a.double() - ref).abs().max() / ref.abs().max())


def _round_input(body, h):
    """A chain dot's rounded input: bf16 values, or W8A8's int8 values
    (sx rounded once to fp32 as the plain version quantizes, or in
    float64 for a float64 h)."""
    if body == "bf16":
        return h.to(torch.bfloat16).double()
    if h.dtype == torch.float64:
        return torch.round(h / (h.abs().amax(dim=1, keepdim=True) * INV_127
                                + EPS))
    return quantize_rows(h)[0].double()


def dot_f64(body, h, w, scale, width):
    """One chain dot and its gates in float64 on the input h: the bf16 or
    int8 rounding of h, then everything in float64."""
    h = h.double()
    if body == "bf16":
        y = h.to(torch.bfloat16).double() @ w.double()
    else:
        sx = h.abs().amax(dim=1, keepdim=True) * INV_127 + EPS
        y = (torch.round(h / sx) @ w.double()) * sx \
            * scale.reshape(1, -1).double()
    return consume_gates(y, width)


def chain_f64(body, x0, ws, scales, steps):
    """The whole chain in float64: (state, last gates)."""
    state = x0.double()
    S = state.shape[1]
    for _ in range(steps):
        h = state
        for i, w in enumerate(ws):
            g, h = dot_f64(body, h[:, :w.shape[0]], w,
                           None if scales is None else scales[i], S)
        state = blend(state, h)
    return state, g


def one_dot(fn, body, h, w, scale):
    """The last gates of a one-dot, one-step scan of fn from input h."""
    return fn(body, h, [w], None if scale is None else [scale], steps=1)[1]


def p4_case(body, B, steps, dev):
    x0, ws, scales = p4.to_device(body, p4.make_inputs(body, B), dev)
    S = x0.shape[1]
    k_state, k_g = resident_scan(body, x0, ws, scales, steps=steps)
    r_state, r_g = resident_scan_reference(body, x0, ws, scales, steps=steps)
    d_state, d_g = chain_f64(body, x0, ws, scales, steps)
    out = dict(probe="P4", body=body, B=B, steps=steps,
               kernel_f64=dict(state=rel(k_state, d_state),
                               gates=rel(k_g, d_g)),
               plain_f64=dict(state=rel(r_state, d_state),
                              gates=rel(r_g, d_g)),
               kernel_plain=dict(state=rel(k_state, r_state),
                                 gates=rel(k_g, r_g)))
    # the kernel's, the plain version's and the float64 chains dot by dot,
    # each from its own input
    states = {"kernel": x0.float(), "plain": x0.float(), "f64": x0.double()}
    fns = {"kernel": resident_scan, "plain": resident_scan_reference}
    worst = {"kernel": 0.0, "plain": 0.0, "kernel_plain": 0.0}
    flips = {"kernel_vs_plain": 0, "plain_vs_f64": 0}
    first = None
    for t in range(steps):
        h = dict(states)
        for i, w in enumerate(ws):
            sc = None if scales is None else scales[i]
            K = w.shape[0]
            ins = {k: v[:, :K].contiguous() for k, v in h.items()}
            q = {k: _round_input(body, v) for k, v in ins.items()}
            n = int((q["kernel"] != q["plain"]).sum())
            if n and first is None:
                first = [t, i]
            flips["kernel_vs_plain"] += n
            flips["plain_vs_f64"] += int((q["plain"] != q["f64"]).sum())
            for k in fns:
                g = one_dot(fns[k], body, ins[k], w, sc)
                g64, _ = dot_f64(body, ins[k], w, sc, S)
                worst[k] = max(worst[k], rel(g, g64))
                if k == "kernel":
                    worst["kernel_plain"] = max(worst["kernel_plain"], rel(
                        g, one_dot(resident_scan_reference, body, ins[k], w,
                                   sc)))
                h[k] = g.repeat(1, -(-S // g.shape[1]))[:, :S]
            h["f64"] = dot_f64(body, ins["f64"], w, sc, S)[1]
        for k in states:
            states[k] = blend(states[k], h[k])
    out.update(per_dot_reproduces_scan=bool(torch.equal(states["kernel"],
                                                        k_state)),
               kernel_dot_f64=worst["kernel"], plain_dot_f64=worst["plain"],
               kernel_dot_plain=worst["kernel_plain"],
               roundings=flips, first_kernel_vs_plain_at=first)
    if B > 8:
        parts = [resident_scan(body, x0[a:b].contiguous(), ws, scales,
                               steps=steps) for a, b in ((0, 8), (8, B))]
        out["rows_independent"] = bool(
            torch.equal(torch.cat([p[0] for p in parts]), k_state)
            and torch.equal(torch.cat([p[1] for p in parts]), k_g))
    return out


def p5_chain(variant, z, kv, ws, dtype, rounded):
    """fused_cost_reference's recurrence at ``dtype`` (float32: the plain
    version, float64: every sum and activation in float64), each bf16
    rounding's result appended to ``rounded``; returns the mel."""
    def rb(t):
        r = t.to(torch.bfloat16).to(dtype)
        rounded.append(r)
        return r

    N, B, M = z.shape
    w = [x.to(dtype) for x in ws]
    zt = z.to(dtype)
    prev = torch.zeros(B, M, device=z.device, dtype=dtype)
    mel = []
    if variant == "attn":
        kvf = kv.to(dtype)
        for t in range(N):
            q = rb(prev) @ w[0]
            scores = torch.tanh(rb(rb(q)[:, None, :] + kvf)).sum(-1)
            scores = scores - scores.amax(-1, keepdim=True)
            e = torch.exp(scores)
            attn = e / e.sum(-1, keepdim=True)
            ctx = rb((rb(attn)[:, :, None] * kvf).sum(1))
            prev = ctx[:, :M] + zt[t]
            mel.append(prev)
        return torch.stack(mel)
    H = w[1].shape[0]
    h = torch.zeros(B, H, device=z.device, dtype=dtype)
    h2 = torch.zeros(B, H, device=z.device, dtype=dtype)
    for t in range(N):
        if variant == "dots":
            a = (rb(prev) @ w[0])[:, :H] + (rb(h) @ w[1])[:, :H]
            h = torch.tanh(a)
            h2 = torch.tanh((rb(h) @ w[2])[:, :H])
            out = rb(h2) @ w[3]
        else:
            g1 = rb(prev) @ w[0] + rb(h) @ w[1]
            i, f, g, o = g1.split(H, dim=1)
            c = torch.sigmoid(f) * h + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            g2 = rb(h) @ w[2] + rb(h2) @ w[3]
            h2 = torch.sigmoid(g2[:, :H]) * torch.tanh(g2[:, H:2 * H])
            out = rb(h2) @ w[4]
        prev = out[:, :M] + zt[t]
        mel.append(prev)
    return torch.stack(mel)


def p5_case(variant, B, steps, dev):
    ws, z, kv = p5.to_device(p5.make_inputs(variant, B, steps), dev)
    k_mel = fused_cost(variant, z, kv, ws)
    r_mel = fused_cost_reference(variant, z, kv, ws)
    r32, r64 = [], []
    p_mel = p5_chain(variant, z, kv, ws, torch.float32, r32)
    d_mel = p5_chain(variant, z, kv, ws, torch.float64, r64)
    diff = (k_mel.double() - r_mel.double()).abs().amax(dim=(1, 2))
    return dict(probe="P5", variant=variant, B=B, steps=steps,
                kernel_f64=rel(k_mel, d_mel), plain_f64=rel(r_mel, d_mel),
                kernel_plain=rel(k_mel, r_mel),
                kernel_plain_abs_by_step=diff.tolist(),
                copy_is_the_plain_version=bool(torch.equal(p_mel, r_mel)),
                roundings_plain_vs_f64=int(sum(
                    int((a.double() != b).sum()) for a, b in zip(r32, r64))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_f64 needs CUDA")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    for body in ("bf16", "w8a8"):
        for B, steps in ((1, args.steps), (8, args.steps), (12, 3),
                         (12, args.steps)):
            print(json.dumps(p4_case(body, B, steps, dev)), flush=True)
    for variant in VARIANTS:
        for B in (1, 8):
            print(json.dumps(p5_case(variant, B, args.steps, dev)),
                  flush=True)


if __name__ == "__main__":
    main()
