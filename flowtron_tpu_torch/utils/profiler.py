"""The ``torch.profiler`` capture shared by the trainer's ``profile_dir``
window (train/loop.py) and the server's ``POST /profile`` (serve/http.py):
CPU activity, plus CUDA activity (CUPTI, the whole process's launches) on
the card, written as a Chrome trace ``trace.json``."""

import os

import torch


def start_profiler(device):
    """Start and return a profiler recording CPU and, when ``device`` is a
    card, CUDA activity."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof, out_dir):
    """Stop ``prof`` and write ``{out_dir}/trace.json``; returns its path."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path
