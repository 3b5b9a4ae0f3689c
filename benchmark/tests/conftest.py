"""Shared fixtures of the benchmark's own tests (CPU, tiny widths):

    python -m pytest benchmark/tests -q          # here, ~2 min
    python -m pytest benchmark/tests -q -m cuda  # on the card

Decides whether there is a card inside a fixture, never at import."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cpu(monkeypatch):
    """The port on the CPU, run from the repo's root (the configurations'
    filelists and dictionary are relative to it)."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    monkeypatch.chdir(ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures the card)")


def tiny(name):
    """A cell's configuration and workload at toy widths, 8 frames, a few
    callers and a short check: (config, cell)."""
    from benchmark.run import load_cell

    _b, _e, cell, config = load_cell(name)
    config, cell = copy.deepcopy(config), copy.deepcopy(cell)
    config["model_config"].update(n_hidden=32, n_attn_channels=16,
                                  n_text_dim=16, n_speaker_dim=8)
    config["waveglow_config"].update(n_channels=16, n_layers=2, n_flows=6)
    flags = cell["server_flags"]
    flags[flags.index("--n-frames") + 1] = "8"
    cell["traffic"]["clients"] = 4
    cell["check"]["requests"] = 3
    return config, cell
