"""Where a WaveGlow training step's time goes on the card: the vocoder
trainer's step (``scripts/train_waveglow.py:make_step``) on
``configs/config_waveglow.json`` at full width (12 flows, 8 layers, 256
channels), B=4, 16000-sample segments drawn by the trainer's sampler from
chip_smoke.py's synthetic corpus (66 coded-tone utterances, seed 0), for
each policy in turn (bf16 as ``fp16_run``, then fp32 with TF32 off):
STEPS steps on batches drawn before the first, steps 6-10 traced by
``torch.profiler`` (CPU and CUDA).

    python -m flowtron_tpu_torch.scripts.waveglow_trace [--policies bf16,fp32]

For each run: the median ms a step over the untraced steps after the
first, the peak memory, and from the Chrome trace a breakdown a traced
step (``remat_trace.trace_breakdown``: the window, the device's busy ms
and idle share, launches, device ms by kernel class, the host's CUDA
runtime calls) with the kernels that take the most device time. Prints
the card's name and power limit, then one JSON line a run. Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import tempfile
from collections import defaultdict

import numpy as np
import torch

from flowtron_tpu_torch.scripts.remat_trace import trace_breakdown

STEPS = 14
TRACED = range(6, 11)
WG_CONFIG = "configs/config_waveglow.json"


def top_kernels(path, n_steps, n=10):
    """The ``n`` kernels with the most device time: ms a step, launches a
    step."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "kernel" and e.get("ph") == "X":
            by_name[e["name"]][0] += 1
            by_name[e["name"]][1] += e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"name": name[:120], "launches": c / n_steps,
             "ms": d / 1e3 / n_steps} for name, (c, d) in top]


def run(policy, config, train_fl, tmp):
    from flowtron_tpu_torch.audio.stft import MelSpectrogram
    from flowtron_tpu_torch.scripts.train_waveglow import (
        make_step, sample_batch, training_files)
    from flowtron_tpu_torch.vocoder.waveglow import waveglow_init

    tc, dc, wc = (config["train_config"], config["data_config"],
                  config["waveglow_config"])
    dev = torch.device("cuda", 0)
    seed = int(tc["seed"])
    model, cfg = waveglow_init(seed, device=dev, **wc)
    optimizer = torch.optim.Adam(model.parameters(),
                                 lr=float(tc["learning_rate"]),
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_step(model, cfg, optimizer, float(tc["sigma"]),
                     torch.bfloat16 if policy == "bf16" else None)
    hop = dc["hop_length"]
    seg = dc["segment_length"] // hop * hop
    ms = MelSpectrogram(dc["filter_length"], hop, dc["win_length"],
                        wc["n_mel_channels"], dc["sampling_rate"],
                        dc["mel_fmin"], dc["mel_fmax"])
    rng = np.random.default_rng(seed)
    files = training_files(train_fl)
    batches = [tuple(torch.from_numpy(a).to(dev) for a in sample_batch(
        rng, files, int(tc["batch_size"]), seg, dc, ms.mel_numpy))
        for _ in range(STEPS)]
    trace = os.path.join(tmp, f"{policy}.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, prof = [], [], None
    for i, (mel, audio) in enumerate(batches):
        if i == TRACED.start:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(float(step(mel, audio)))
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        if i == TRACED.stop - 1:
            prof.stop()
            prof.export_chrome_trace(trace)
    timed = [t for i, t in enumerate(step_ms)
             if i > 0 and i not in TRACED]
    return {"policy": policy, "B": int(tc["batch_size"]), "segment": seg,
            "ms_per_step_median": statistics.median(timed),
            "step_ms": step_ms, "losses": losses,
            "peak_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "trace": trace_breakdown(trace, len(TRACED)),
            "top_kernels": top_kernels(trace, len(TRACED))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--policies", default="bf16,fp32")
    args = ap.parse_args()
    assert torch.cuda.is_available(), "needs CUDA"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from flowtron_tpu_torch.data.synth import make_aligned_corpus

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    with open(WG_CONFIG) as f:
        config = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        train_fl, _ = make_aligned_corpus(os.path.join(tmp, "corpus"),
                                          n_utterances=66, seed=0,
                                          val_count=6)
        for policy in args.policies.split(","):
            print(json.dumps(run(policy, config, train_fl, tmp)),
                  flush=True)


if __name__ == "__main__":
    main()
