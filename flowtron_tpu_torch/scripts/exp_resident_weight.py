"""P3, port of scripts/exp_resident_weight.py: a scan whose weight stays
on chip across steps (csrc/resident.cu, body "p3": each SM keeps its 32
columns of the bf16 (1664, 4096) weight in shared memory for all steps),
against the plain scan that streams the weight every step (a cuBLAS bf16
product a step, replayed from CUDA graphs).

    python -m flowtron_tpu_torch.scripts.exp_resident_weight [B] [STEPS]

Both scans: y = carry @ w (fp32 sums); the plain one updates the bf16
carry op by op, ``0.999 * carry + 0.001 * bf16(y[:, :IN])``, the
resident one in fp32 with one rounding, as the script's two halves do.
"""

import sys

import numpy as np
import torch

from flowtron_tpu_torch.ops.resident import pack_resident_weights, \
    resident_scan
from flowtron_tpu_torch.scripts import _probe
from flowtron_tpu_torch.utils.device import resolve_device

IN, OUT, STEPS = 1664, 4096, 2000
B = 64


def make_inputs(B=B, IN=IN, OUT=OUT):
    """The script's inputs, in its order: w (IN, OUT), x (B, IN), both
    fp32 numpy arrays that go in as bf16."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((IN, OUT)).astype(np.float32)
    x = rng.standard_normal((B, IN)).astype(np.float32)
    return w, x


def xla_step(w):
    """One step of the script's ``xla_scan`` (the weight streamed)."""
    def step(carry):
        y = carry @ w                      # bf16 out of fp32 sums
        return _probe.bf16_carry(carry, y[:, :carry.shape[1]])
    return step


def main(argv=None, device=None, B=B, IN=IN, OUT=OUT):
    """Prints the script's two lines; returns {"xla": (us a step, final
    carry), "pallas": (us a step, (state, last product))}."""
    argv = sys.argv[1:] if argv is None else argv
    B, steps = _probe.parse_args(argv, [B, STEPS])
    dev = resolve_device(device)
    w, x = make_inputs(B, IN, OUT)
    w = _probe.tensor(w, dev, torch.bfloat16)
    x = _probe.tensor(x, dev, torch.bfloat16)
    results = {}
    us, out = _probe.time_per_step(_probe.scan(xla_step(w), x, steps), steps)
    results["xla"] = (us, out)
    print(f"XLA scan (streamed)      : {us:7.2f} us/step", flush=True)
    packed = pack_resident_weights("p3", [w]) if dev.type == "cuda" else None
    us, out = _probe.time_per_step(
        lambda: resident_scan("p3", x, [w], steps=steps, packed=packed),
        steps)
    results["pallas"] = (us, out)
    print(f"Pallas scan (resident W) : {us:7.2f} us/step", flush=True)
    return results


if __name__ == "__main__":
    main()
