"""P4, port of scripts/exp_fused_int8.py: the decoder's big-dot chain
(1664x4096 -> 3 x 1024x4096) run as a scan with the weights kept on chip
(csrc/resident.cu), in bf16 and in W8A8 (int8 weights with per-column
scales, each step's activations quantized per row).

    python -m flowtron_tpu_torch.scripts.exp_fused_int8 [B] [STEPS]

One flow's chain is 38.8 MB in bf16, more than the ~30 MB of shared
memory of an H100's SMs: the kernel keeps the dots that fit (in order) and
reads the rest from global memory every step; ``resident_scan.last_resident``
says which. In int8 (19.4 MB) all of it stays. ``library_step`` is the
streamed yardstick: the same chain through cuBLAS bf16 products, a step at
a time from CUDA graphs.
"""

import sys

import numpy as np
import torch

from flowtron_tpu_torch.ops.resident import consume_gates, \
    pack_resident_weights, resident_scan
from flowtron_tpu_torch.scripts import _probe
from flowtron_tpu_torch.utils.device import resolve_device

B, STEPS = 1, 2000
SHAPES = [(1664, 4096), (1024, 4096), (1024, 4096), (1024, 4096)]


def make_inputs(body, B=B, shapes=SHAPES):
    """The inputs of the script's ``make_bf16`` or ``make_w8a8``, each from
    its own ``default_rng(0)``, as numpy arrays: (x0, weights, scales).
    bf16: fp32 weights * 0.02 and x0 that go in as bf16, scales None.
    w8a8: int8 weights of per-column scales (1, N) fp32, x0 fp32."""
    rng = np.random.default_rng(0)
    if body == "bf16":
        ws = [rng.standard_normal(s).astype(np.float32) * 0.02
              for s in shapes]
        x0 = rng.standard_normal((B, shapes[0][0])).astype(np.float32)
        return x0, ws, None
    ws, scales = [], []
    for s in shapes:
        w = rng.standard_normal(s).astype(np.float32) * 0.02
        sc = np.abs(w).max(axis=0) / 127.0 + 1e-12
        ws.append(np.round(w / sc).astype(np.int8))
        scales.append(sc.astype(np.float32)[None])
    x0 = rng.standard_normal((B, shapes[0][0])).astype(np.float32)
    return x0, ws, scales


def to_device(body, inputs, device):
    x0, ws, scales = inputs
    if body == "bf16":
        return (_probe.tensor(x0, device, torch.bfloat16),
                [_probe.tensor(w, device, torch.bfloat16) for w in ws], None)
    return (_probe.tensor(x0, device),
            [_probe.tensor(w, device) for w in ws],
            [_probe.tensor(s, device) for s in scales])


def library_step(ws, scales=None):
    """One step of the chain with the weights streamed: cuBLAS bf16
    products on the card (the W8A8 weights dequantized to bf16 once), the
    gates and the state update in PyTorch."""
    if scales is not None:
        ws = [(w.float() * s.reshape(1, -1)).to(torch.bfloat16)
              for w, s in zip(ws, scales)]

    def step(state):
        h = state
        for w in ws:
            _, h = consume_gates((h[:, :w.shape[0]].to(torch.bfloat16) @ w)
                                 .float(), state.shape[1])
        return 0.999 * state + 0.001 * h
    return step


def main(argv=None, device=None, B=B, shapes=SHAPES):
    """Prints the script's lines; returns {body: (us a step, (state,
    last gates))}."""
    argv = sys.argv[1:] if argv is None else argv
    B, steps = _probe.parse_args(argv, [B, STEPS])
    dev = resolve_device(device)
    print(f"B={B} STEPS={steps} backend={dev.type}")
    results = {}
    for body, label in (("bf16", "bf16 resident dots"),
                        ("w8a8", "w8a8 resident dots")):
        x0, ws, scales = to_device(body, make_inputs(body, B, shapes), dev)
        packed = (pack_resident_weights(body, ws, scales)
                  if dev.type == "cuda" else None)
        us, out = _probe.time_per_step(
            lambda: resident_scan(body, x0, ws, scales, steps, packed),
            steps)
        results[body] = (us, out)
        print(f"{label} : {us:7.2f} us/step", flush=True)
    return results


if __name__ == "__main__":
    main()
