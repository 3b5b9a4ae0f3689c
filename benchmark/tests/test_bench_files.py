"""BENCHMARK.json and the files it names: every cell, configuration,
traffic kind and metric is found by its name."""

import importlib.util
import json
import os
import re

from benchmark.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_file_keeps_the_contract():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert b["command"][1].startswith("benchmark/")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_every_cell_finds_its_files():
    from benchmark import endtoend
    from benchmark.traffic import kind

    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for c in configs.values():
        assert c["file"].startswith("benchmark/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["source"] == c["source"]
    for w in b["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        with open(os.path.join(BENCH, "workloads", f"{w['name']}.json")) as f:
            cell = json.load(f)
        assert cell["config"] == w["config"]
        traffic = kind(cell["traffic"]["kind"])
        assert hasattr(traffic, "schedule") and hasattr(traffic, "drive")
        assert os.path.exists(os.path.join(BENCH, "texts",
                                           f"{cell['corpus']}.txt"))
        assert set(cell["check"]["limits"]) <= {
            "mel_rel_rms", "pcm_rel_rms", "pcm_rms_lsb", "pcm_peak_gap",
            "length_mismatch"}
        assert {"mel_rel_rms", "pcm_peak_gap", "length_mismatch"} <= set(
            cell["check"]["limits"])
    for name in e2e:
        assert name in endtoend.METRICS
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        path = os.path.join(BENCH, "metrics", f"{m['name']}.py")
        spec = importlib.util.spec_from_file_location("reader", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        assert callable(module.read)
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            # the metric's cells report the end-to-end metric it moves
            assert cell in cells
            assert cell in moved.get("workloads", cells)


def test_configurations_are_the_repo_configs():
    """The published configurations as the repo holds them; the one key
    changed (``reduced``: data_config) is p_arpabet."""
    pairs = {"flowtron-ljs.wg256.fp32": "config.json",
             "flowtron-libritts.wg256.bf16": "configs/config_libritts.json"}
    with open(os.path.join(ROOT, "configs", "config_waveglow.json")) as f:
        wg = json.load(f)["waveglow_config"]
    for name, src in pairs.items():
        with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
            ours = json.load(f)
        with open(os.path.join(ROOT, src)) as f:
            theirs = json.load(f)
        assert ours["waveglow_config"] == wg
        for section, values in theirs.items():
            if section == "data_config":
                assert ours[section] == dict(values, p_arpabet=0.0)
            else:
                assert ours[section] == values


def test_layout_is_the_port_state_dict(cpu):
    """The published layouts the benchmark draws are the names and shapes
    the port's modules load."""
    from benchmark.reference.layout import flowtron_layout, waveglow_layout
    from benchmark.tests.conftest import tiny
    from flowtron_tpu_torch.models.flowtron import Flowtron
    from flowtron_tpu_torch.vocoder.waveglow import WaveGlow

    config, _cell = tiny("libritts-bf16.closed16")
    mc, wc = config["model_config"], config["waveglow_config"]
    keys = ("n_speakers", "n_speaker_dim", "n_text", "n_text_dim", "n_flows",
            "n_mel_channels", "n_hidden", "n_attn_channels", "n_lstm_layers",
            "use_gate_layer")
    port = {k: tuple(v.shape) for k, v in Flowtron(
        **{k: mc[k] for k in keys}).state_dict().items()}
    assert port == {n: s for n, s, _i, _f in flowtron_layout(mc)}
    port = {k: tuple(v.shape) for k, v in WaveGlow(**wc).state_dict().items()}
    assert port == {n: s for n, s, _i, _f in waveglow_layout(wc)}
