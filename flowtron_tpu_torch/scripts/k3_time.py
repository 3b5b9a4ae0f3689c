"""Time kernel K3's forward and backward on the card, in CUDA graphs and
as eager calls, at one shape, for the port in this checkout or in another
one: the way to hold two versions of the kernels against each other on
one card.

    python flowtron_tpu_torch/scripts/k3_time.py [B Tq Tk D] [--bf16]
        [--root DIR] [--rounds R]

Defaults: the first training batch of chip_smoke.py's corpus at the
flagship width, 6 x 320 x 64 x 640, fp32, from this checkout. ``--root``
imports ``flowtron_tpu_torch`` from another checkout's root (for example
an unpacked ``git archive`` of another commit), whose kernels are then
built there; run the script as a file for that, not with ``-m``. Prints
the card's name and power limit, then one JSON line: for forward and
backward the median and every run of the device ms per call in CUDA
graphs (10 calls a graph, the two graphs replayed in turns, as
chip_smoke.py's ``graph_times``) and of an eager call (CUDA events
around 20 calls, so the host's launch time counts), and the forward's
largest error against the plain version. Needs CUDA.
"""

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys

import torch


def event_ms(fn, reps):
    """Device ms per call of ``reps`` calls of fn(), by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_of(fn, reps):
    """fn() called ``reps`` times, captured in one CUDA graph after a
    warm-up call on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    return g


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shape", nargs="*", type=int, default=[6, 320, 64, 640],
                    help="B Tq Tk D")
    ap.add_argument("--bf16", action="store_true", help="bf16 inputs")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
                    help="the checkout whose port is timed")
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    if len(args.shape) != 4:
        ap.error("give B Tq Tk D")
    if not torch.cuda.is_available():
        raise SystemExit("k3_time needs CUDA")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    k3 = importlib.import_module("flowtron_tpu_torch.ops.attention")
    if not os.path.abspath(k3.__file__).startswith(root + os.sep):
        raise SystemExit(f"flowtron_tpu_torch came from {k3.__file__}, not "
                         f"{root}: run this script as a file")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0], flush=True)
    B, Tq, Tk, D = args.shape
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    dev = torch.device("cuda", 0)
    g = torch.Generator().manual_seed(13)
    q = (0.5 * torch.randn(B, Tq, D, generator=g)).to(dev, dtype)
    k = (0.5 * torch.randn(B, Tk, D, generator=g)).to(dev, dtype)
    v = (0.1 * torch.randn(D, generator=g)).to(dev, dtype)
    ds = torch.randn(B, Tq, Tk, generator=g).to(dev, dtype)
    calls = {"fwd": lambda: k3.attention_scores_fwd(q, k, v, 1.0),
             "bwd": lambda: k3.attention_scores_bwd(q, k, v, ds, 1.0)}
    with torch.no_grad():
        err = float((calls["fwd"]().float() - k3.attention_scores_reference(
            q.float(), k.float(), v.float())).abs().max())
        graphs = {name: graph_of(fn, 10) for name, fn in calls.items()}
        runs = {f"{name}_{how}": [] for name in calls
                for how in ("graph", "eager")}
        for _ in range(args.rounds):
            for name in ("fwd", "bwd", "bwd", "fwd"):
                runs[f"{name}_graph"].append(
                    event_ms(graphs[name].replay, 1) / 10)
            for name in ("fwd", "bwd", "bwd", "fwd"):
                runs[f"{name}_eager"].append(event_ms(calls[name], 20))
    out = {"root": root, "B": B, "Tq": Tq, "Tk": Tk, "D": D,
           "dtype": str(dtype)[6:], "fwd_max_abs_err": err}
    for key, r in runs.items():
        out[f"{key}_ms"] = statistics.median(r)
        out[f"{key}_runs_ms"] = r
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
