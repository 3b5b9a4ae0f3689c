"""P1, port of scripts/exp_w4_kernel_bisect.py: the five int4
dequant-matmul bodies k1-k5 (ops/w4.py, csrc/w4.cu), each run once and
summed, then k3 and k5 timed in a STEPS-long scan
``carry = 0.999 * carry + 0.001 * y[:, :IN]`` (bf16), a loop of kernel
launches. The loop runs eagerly, not from a CUDA graph, so the kernel's
launch counter counts every launch; the Python step takes about as long
as the kernel, so the printed time holds some host time (chip_smoke.py
also times the kernel's scan from CUDA graphs).

    python -m flowtron_tpu_torch.scripts.exp_w4_kernel_bisect [B] [STEPS]

The TPU script asked which op Mosaic rejected; here every body builds, so
each prints ``OK <sum>``. Its k4 ("+repeat-scale") scales row r by
s[r % NG], not s[r // G] (ops/w4.py), so its sum differs from k3's. The
script's TN (the TPU's column tile) has no counterpart here.
"""

import sys

import numpy as np
import torch

from flowtron_tpu_torch.ops.w4 import w4_matmul
from flowtron_tpu_torch.scripts import _probe
from flowtron_tpu_torch.utils.device import resolve_device

IN, OUT, B = 1664, 4096, 64
NG = 13                 # group scales: G = IN // NG = 128 rows
STEPS = 2000
TRY = [("k1 shifts+dot-half", "k1"), ("k2 +concat", "k2"),
       ("k3 +reshape3d-scale", "k3"), ("k4 +repeat-scale", "k4"),
       ("k5 per-group dots", "k5")]
SCANS = [("k3 reshape3d", "k3"), ("k5 per-group", "k5")]


def make_inputs(B=B, IN=IN, OUT=OUT, NG=NG):
    """The script's ``build`` inputs, in its order: x (B, IN) (bf16 on the
    way in), q4 (IN/2, OUT) int8, s (NG, OUT) fp32, as numpy arrays."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, IN)).astype(np.float32)
    q4 = rng.integers(-128, 128, (IN // 2, OUT)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (NG, OUT)).astype(np.float32)
    return x, q4, s


def to_device(inputs, device):
    x, q4, s = inputs
    return (_probe.tensor(x, device, torch.bfloat16),
            _probe.tensor(q4, device), _probe.tensor(s, device))


def scan_step(body, q, s):
    """One step of the script's ``time_in_scan`` body."""
    def step(carry):
        y = w4_matmul(carry, q, s, body)
        return _probe.bf16_carry(carry, y[:, :carry.shape[1]])
    return step


def main(argv=None, device=None, B=B, IN=IN, OUT=OUT, NG=NG):
    """Prints the script's lines; returns {body: (sum, output)} for the
    single calls and {"<body> scan": (us a step, final carry)}."""
    argv = sys.argv[1:] if argv is None else argv
    B, steps = _probe.parse_args(argv, [B, STEPS])
    dev = resolve_device(device)
    x, q, s = to_device(make_inputs(B, IN, OUT, NG), dev)
    results = {}
    for name, body in TRY:
        out = w4_matmul(x, q, s, body)
        total = float(out.float().sum())
        results[body] = (total, out)
        print(f"{name}: OK {total:.3f}", flush=True)
    for name, body in SCANS:
        us, carry = _probe.time_per_step(
            _probe.scan(scan_step(body, q, s), x, steps, graph=False), steps)
        results[f"{body} scan"] = (us, carry)
        print(f"{name} scan: {us:7.2f} us/step", flush=True)
    return results


if __name__ == "__main__":
    main()
