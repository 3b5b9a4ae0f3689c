"""P5, port of scripts/exp_fused_cost.py: attribute K1's per-step cost by
timing stripped variants at flagship dims: the 4 big dots alone, two LSTM
cells and the output dot, and the attention alone (csrc/fused_cost.cu,
K1's launch structure stripped down).

    python -m flowtron_tpu_torch.scripts.exp_fused_cost [B] [N]

Unlike the script, importing this module runs nothing.
"""

import sys

import numpy as np
import torch

from flowtron_tpu_torch.ops.fused_cost import fused_cost, pack_weights, \
    weight_shapes
from flowtron_tpu_torch.scripts import _probe
from flowtron_tpu_torch.utils.device import resolve_device

B = 1
N, M, H, D, Tk = 400, 80, 1024, 640, 128
RUNS = [("4 dots (26M params)", "dots"), ("2 LSTM cells + out dot", "lstm"),
        ("attention only", "attn")]


def make_inputs(variant, B=B, N=N, M=M, H=H, D=D, Tk=Tk):
    """The script's ``run`` inputs for one variant, in its order, as
    numpy arrays: weights (fp32 * 0.02, bf16 on the way in), z (N, B, M)
    fp32, kv (B, Tk, D) (bf16 on the way in)."""
    rng = np.random.default_rng(0)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.02
          for s in weight_shapes(variant, M, H, D)]
    z = rng.standard_normal((N, B, M)).astype(np.float32)
    kv = rng.standard_normal((B, Tk, D)).astype(np.float32)
    return ws, z, kv


def to_device(inputs, device):
    ws, z, kv = inputs
    return ([_probe.tensor(w, device, torch.bfloat16) for w in ws],
            _probe.tensor(z, device),
            _probe.tensor(kv, device, torch.bfloat16))


def main(argv=None, device=None, B=B, N=N, M=M, H=H, D=D, Tk=Tk):
    """Prints the script's three lines; returns {variant: (us a step,
    mel)}."""
    argv = sys.argv[1:] if argv is None else argv
    B, N = _probe.parse_args(argv, [B, N])
    dev = resolve_device(device)
    results = {}
    for name, variant in RUNS:
        ws, z, kv = to_device(make_inputs(variant, B, N, M, H, D, Tk), dev)
        packed = pack_weights(variant, ws) if dev.type == "cuda" else None
        us, mel = _probe.time_per_step(
            lambda: fused_cost(variant, z, kv, ws, packed), N)
        results[variant] = (us, mel)
        print(f"{name:32s}: {us:7.2f} us/step", flush=True)
    return results


if __name__ == "__main__":
    main()
