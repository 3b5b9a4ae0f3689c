"""Whole runs of the harness at toy widths on the CPU (the look for a card
skipped): correct when the program is sound, not correct when the timed
path is broken underneath or a lower precision stands in its place."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import ROOT, tiny


def run(name, config, cell, seed=2 ** 31 + 7):
    from benchmark.run import execute

    result, lines, r = execute(name, seed, 2.0, 0, "cpu", config, cell)
    return result, lines, r


def test_a_sound_run_is_correct(cpu):
    config, cell = tiny("ljs-fp32.closed16")
    result, lines, r = run("ljs-fp32.closed16", config, cell)
    assert result["correct"], lines
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"requests_per_s", "setup_s"}
    assert result["metrics"]["requests_per_s"]["value"] > 0
    assert result["failed"] == 0 and result["attempted"] > 0
    assert lines[-1].startswith("check ")
    assert r.checks["mel_rel_rms"]["value"] < 1e-5


def altered_answer(monkeypatch):
    """Answers altered where they are produced: every row's PCM reversed
    in time (every answer, so that any sample holds one)."""
    from flowtron_tpu_torch.serve.engine import SynthesisEngine

    original = SynthesisEngine._vocode_norm

    def broken(self, mel, *args, **kwargs):
        return original(self, mel, *args, **kwargs).flip(1)

    monkeypatch.setattr(SynthesisEngine, "_vocode_norm", broken)


def half_batch(monkeypatch):
    """Half of the batch left out: the rows past the first half take the
    first row's mel."""
    from flowtron_tpu_torch.serve.engine import SynthesisEngine

    original = SynthesisEngine._synth_mel

    def broken(self, *args, **kwargs):
        mel, n_valid = original(self, *args, **kwargs)
        half = (mel.shape[0] + 1) // 2
        mel = mel.clone()
        mel[half:] = mel[:1]
        return mel, n_valid

    monkeypatch.setattr(SynthesisEngine, "_synth_mel", broken)


def one_peak(monkeypatch):
    """Peak normalisation over the whole batch: one peak for every row, in
    place of each row's own."""
    from flowtron_tpu_torch.serve import engine

    original = engine.SynthesisEngine._vocode_norm
    amax = torch.Tensor.amax

    def broken(self, *args, **kwargs):
        def one(t, dim=None, keepdim=False):
            return amax(t).reshape(1, 1) if dim == 1 and keepdim \
                else amax(t, dim=dim, keepdim=keepdim)
        monkeypatch.setattr(torch.Tensor, "amax", one)
        try:
            return original(self, *args, **kwargs)
        finally:
            monkeypatch.setattr(torch.Tensor, "amax", amax)

    monkeypatch.setattr(engine.SynthesisEngine, "_vocode_norm", broken)


@pytest.mark.parametrize("fault", [altered_answer, half_batch, one_peak])
def test_a_broken_timed_path_is_not_correct(cpu, monkeypatch, fault):
    fault(monkeypatch)
    config, cell = tiny("ljs-fp32.closed16")
    cell["check"]["requests"] = 6
    result, lines, _r = run("ljs-fp32.closed16", config, cell)
    assert not result["correct"], lines


def test_the_controls_and_the_planted_fault_are_not_correct(cpu):
    """The reference in fp8 in the bf16 program's place, and with one peak
    for a block of rows, each fail the cell's limits; the program path is
    run too (on the card, at the cell's size, it fails them as well:
    PERF.md)."""
    from benchmark import control

    config, cell = tiny("libritts-bf16.closed16")
    out = control.readings("libritts-bf16.closed16", 9, 2.0, "cpu", config,
                           cell)
    assert out["program_path"]["flags"] == ["--quantize", "w8a8"]
    assert out["sample"] == cell["check"]["requests"]
    assert not out["fp8"]["correct"], out
    assert not out["one_peak"]["correct"], out
    assert out["one_peak"]["readings"]["pcm_peak_gap"] > 0


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card, tmp_path):
    """A short run of each cell on the card: a result line, correct."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = [w["name"] for w in json.load(f)["workloads"]]
    for name in cells:
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", name,
             "--seed", "2147483659", "--seconds", "5", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name, seconds", [("ljs-fp32.closed16", 8.0),
                                           ("libritts-bf16.closed16", 12.0)])
def test_the_controls_are_not_correct_on_the_card(card, name, seconds):
    """At the cell's size, a check of 4 answers: the program as the cell
    runs it, or its own lower path where the cell names one (w8a8), and
    the reference in the lower precision (TF32 has no effect on the CPU)
    and with one peak."""
    from benchmark import control
    from benchmark.run import load_cell

    _b, _e, cell, _config = load_cell(name)
    cell["check"]["requests"] = 4
    out = control.readings(name, 2147483661, seconds, cell=cell)
    assert out["sample"] == 4
    program = out.get("program_path", out.get("program"))
    assert program["correct"] == ("program" in out), out
    for label in ("fp8" if "program_path" in out else "tf32", "one_peak"):
        assert not out[label]["correct"], out
    assert torch.cuda.is_available()
