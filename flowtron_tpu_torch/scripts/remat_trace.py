"""Where ``remat``'s extra time goes on the card: ``config.json`` in fp32
trained through ``cli.train_main`` with and without ``remat``, in the
order plain, remat, remat, plain, 16 steps each with ``profile_dir`` set
(steps 10-14 traced), on chip_smoke.py's synthetic corpus (66 coded-tone
utterances, seed 0, 6 held out) read from the top again after its 60
training lines (96 lines, 16 steps at B=6).

    python -m flowtron_tpu_torch.scripts.remat_trace [--runs plain,remat,...]

For each run: the median ms/step over steps 1-9 and 15 (not traced), the
peak memory, every step's loss, and from the Chrome trace a breakdown a
traced step: the window, the device's busy ms and idle share, kernel
launches, the device ms of cuDNN's LSTM kernels, kernel K3 (forward and
backward), GEMMs, elementwise and reduction kernels and the rest; the
host's ms in the CUDA runtime calls by name (launches, copies,
synchronisations), and the count and ms of the CPU ops that show where
a recompute or a host synchronisation happens. Prints the card's name
and power limit, then one JSON line a run and one that holds each remat
run's losses against the plain runs'. Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import tempfile
from collections import defaultdict

import torch

STEPS = 16
TRACED = range(10, 15)
CPU_OPS = ("aten::_cudnn_rnn", "aten::_cudnn_rnn_backward",
           "aten::_cudnn_rnn_flatten_weight", "aten::_local_scalar_dense",
           "aten::_pack_padded_sequence", "aten::copy_", "aten::item")


def kernel_class(name):
    low = name.lower()
    if "scores_fwd_kernel" in name or "scores_bwd_kernel" in name:
        return "k3"
    if "rnn" in low or "lstm" in low:
        return "cudnn_lstm"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm"
    if "reduce" in low:
        return "reduce"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    return "other"


def trace_breakdown(path, n_steps):
    """Per traced step: the window, device busy ms, idle share, launches
    and device ms by kernel class; host ms in CUDA runtime calls by name;
    the count and ms of the CPU ops in ``CPU_OPS``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if "ts" in e and e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    span = max(e["ts"] + e["dur"] for e in events) \
        - min(e["ts"] for e in events)
    busy = sum(e["dur"] for e in kernels)
    by_class = defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e["name"])] += e["dur"]
    runtime = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "cuda_runtime":
            runtime[e["name"]][0] += 1
            runtime[e["name"]][1] += e["dur"]
    ops = {n: [0, 0.0] for n in CPU_OPS}
    for e in events:
        if e.get("cat") == "cpu_op" and e["name"] in ops:
            ops[e["name"]][0] += 1
            ops[e["name"]][1] += e["dur"]
    top = sorted(runtime.items(), key=lambda kv: -kv[1][1])[:6]
    return {
        "window_ms_per_step": span / 1e3 / n_steps,
        "device_busy_ms_per_step": busy / 1e3 / n_steps,
        "device_idle_share": 1 - busy / span,
        "kernels_per_step": len(kernels) / n_steps,
        "device_ms_per_step_by_class": {
            k: v / 1e3 / n_steps for k, v in sorted(by_class.items())},
        "host_runtime_per_step": {
            n: {"calls": c / n_steps, "ms": d / 1e3 / n_steps}
            for n, (c, d) in top},
        "cpu_ops_per_step": {
            n: {"calls": c / n_steps, "ms": d / 1e3 / n_steps}
            for n, (c, d) in ops.items() if c},
    }


def train_run(tmp, tag, corpus, remat):
    from flowtron_tpu_torch.cli import train_main

    train_fl, val_fl = corpus
    out_dir, prof = (os.path.join(tmp, f"{tag}_{n}")
                     for n in ("out", "trace"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_main(["-c", "config.json", "-p",
                f"data_config.training_files={train_fl}",
                f"data_config.validation_files={val_fl}",
                f"train_config.output_directory={out_dir}",
                "train_config.epochs=1",
                f"train_config.iters_per_checkpoint={STEPS}",
                "train_config.with_tensorboard=False",
                "train_config.fp16_run=False",
                f"train_config.remat={remat}",
                f"train_config.profile_dir={prof}"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    assert len(steps) == STEPS, len(steps)
    timed = [1e3 * r["step_s"] for r in steps[1:]
             if r["iteration"] not in TRACED]
    return {"run": tag, "remat": remat,
            "ms_per_step_median": statistics.median(timed),
            "step_ms": [1e3 * r["step_s"] for r in steps],
            "peak_memory_allocated_bytes": peak,
            "losses": [r["loss"] for r in steps],
            "trace": trace_breakdown(os.path.join(prof, "trace.json"),
                                     len(TRACED))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", default="plain,remat,remat,plain")
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs CUDA"
    from flowtron_tpu_torch.data.synth import make_aligned_corpus

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    torch.manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        train_fl, val_fl = make_aligned_corpus(
            os.path.join(tmp, "corpus"), n_utterances=66, seed=0,
            val_count=6)
        with open(train_fl) as f:
            lines = f.read().splitlines()
        long_fl = os.path.join(tmp, "train16.txt")
        with open(long_fl, "w") as f:
            f.write("\n".join((lines * 2)[:6 * STEPS]) + "\n")
        results = []
        for i, kind in enumerate(args.runs.split(",")):
            r = train_run(tmp, f"{i}_{kind}", (long_fl, val_fl),
                          kind == "remat")
            print(json.dumps({k: v for k, v in r.items()
                              if k != "losses"}), flush=True)
            results.append(r)
    plain = [r for r in results if not r["remat"]]
    for r in (r for r in results if r["remat"]):
        print(json.dumps({"run": r["run"], "loss_rel_err_vs_plain": [
            max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                    p["losses"]))
            for p in plain]}), flush=True)


if __name__ == "__main__":
    main()
