"""Split K4's device time by kernel with torch.profiler: the W8A8 body's
quantize launch and its product (or the weight-only product alone), on
seeded random inputs, fp32 x or bf16 x (``--bf16``), at one (M, K, N).

    python -m flowtron_tpu_torch.scripts.k4_split [M K N] [--w8] [--bf16]
        [--calls C]

Defaults: the flagship decoder's widest per-frame dot at the serving
engine's batch, (8, 1664, 4096), W8A8, fp32 x, 200 eager calls after 20
of warm-up. Prints the card's name and power limit, then one JSON line per
kernel (calls, device microseconds per call, share of the kernels' device
time) and one for the total. Needs CUDA.
"""

import argparse
import json
import subprocess
from collections import defaultdict

import torch

from flowtron_tpu_torch.infer.quantize import _quantize_matrix
from flowtron_tpu_torch.ops.qmm import quantized_matmul


def kernel_times(fn, calls):
    """{kernel name: [launches, device us]} of ``calls`` calls of fn()."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.name][0] += 1
            out[evt.name][1] += evt.time_range.elapsed_us()
    return dict(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int, default=[8, 1664, 4096],
                    help="M K N")
    ap.add_argument("--w8", action="store_true",
                    help="the weight-only body (default W8A8)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 x (the bodies of the --bf16 server)")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    if len(args.shape) != 3:
        ap.error("give M K N")
    if not torch.cuda.is_available():
        raise SystemExit("k4_split needs CUDA")
    M, K, N = args.shape
    a8 = not args.w8
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    g = torch.Generator().manual_seed(14)
    leaf = _quantize_matrix(0.05 * torch.randn(N, K, generator=g), a8=a8)
    q, s = leaf.q.to(dev), leaf.s.to(dev)
    x = torch.randn(M, K, generator=g).to(
        dev, torch.bfloat16 if args.bf16 else torch.float32)

    def call():
        return quantized_matmul(x, q, s, a8=a8)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    times = kernel_times(call, args.calls)
    total = sum(us for _, us in times.values())
    for name, (n, us) in sorted(times.items(), key=lambda kv: -kv[1][1]):
        print(json.dumps({"kernel": name[:120], "launches": n,
                          "us_per_call": us / args.calls,
                          "share": us / total}), flush=True)
    print(json.dumps({"body": "w8a8" if a8 else "w8", "M": M, "K": K, "N": N,
                      "x": str(x.dtype).split(".")[-1], "calls": args.calls,
                      "device_us_per_call": total / args.calls}), flush=True)


if __name__ == "__main__":
    main()
