"""The plain reference against the port's CPU path at toy widths (the
test imports both; the reference imports nothing of the program)."""

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.tests.conftest import ROOT, tiny


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for dirpath, _d, files in os.walk(ref):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else \
                    [node.module or ""] if isinstance(node, ast.ImportFrom) \
                    else []
                for m in mods:
                    top = m.split(".")[0]
                    assert top not in ("jax", "flowtron_tpu",
                                       "flowtron_tpu_torch"), (name, m)


def test_text_ids_are_the_servers(cpu):
    from benchmark.reference.frontend import TextIds, speaker_table
    from flowtron_tpu_torch.data.frontend import TextFrontend
    from benchmark.run import load_cell

    _b, _e, _cell, config = load_cell("libritts-bf16.closed16")
    dc = config["data_config"]
    ours, port = TextIds(dc), TextFrontend.from_config(dc)
    with open(os.path.join(ROOT, "benchmark", "texts", "libritts.txt")) as f:
        lines = [next(f) for _ in range(200)]
    for line in lines:
        sid, text = line.rstrip("\n").split("|", 1)
        ids = ours.ids(text)
        assert np.array_equal(ids, port.get_text(text))
        assert 1 <= len(ids) <= 128
    assert speaker_table(dc["training_files"]) == port.speaker_ids


def test_flows_and_vocoder_match_the_port(cpu):
    """Same weights (made from a seed, loaded by the port's loaders), same
    text, latents from the served rule: mel and PCM within fp32 rounding
    of the port's plain (CPU) path, in a padded batch of two."""
    from benchmark.check import reference_answers
    from flowtron_tpu_torch.serve.engine import SynthesisEngine

    config, _cell = tiny("ljs-fp32.closed16")
    files = weights.MemoryFiles()
    try:
        ft, wg = weights.model_weights(config, 11, torch.device("cpu"))
        import json
        cfg = os.path.join(files.dir, "config.json")
        with open(cfg, "w") as f:
            json.dump({k: config[k] for k in ("train_config", "data_config",
                                              "dist_config", "model_config")},
                      f)
        from flowtron_tpu_torch.config import load_config
        eng = SynthesisEngine(load_config(cfg),
                              files.save("flowtron", ft),
                              files.save("waveglow", wg,
                                         config["waveglow_config"]),
                              n_frames=8, device="cpu")
    finally:
        files.close()
    bodies = [{"text": "Printing, in the only sense with which we are at "
                       "present concerned.", "speaker_id": 0, "seed": 5,
               "sigma": 0.5},
              {"text": "A short one.", "speaker_id": 0, "seed": 6,
               "sigma": 0.5}]
    try:
        got = [eng.submit(b["text"], b["speaker_id"], b["sigma"],
                          b["seed"])[0] for b in bodies]
    finally:
        eng.shutdown()
    want = reference_answers(config, bodies, 11, 8, "cpu")
    for g, (_mel, w) in zip(got, want):
        assert len(g) == len(w)
        assert np.abs(g.astype(np.int64) - w.astype(np.int64)).max() <= 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weights_follow_the_seed(dtype):
    config, _cell = tiny("ljs-fp32.closed16")
    a = weights.model_weights(config, 3, torch.device("cpu"))
    b = weights.model_weights(config, 3, torch.device("cpu"))
    c = weights.model_weights(config, 4, torch.device("cpu"))
    dt = getattr(torch, dtype)
    for x, y, z in zip(a, b, c):
        assert all(torch.equal(x[k].to(dt), y[k].to(dt)) for k in x)
        assert any(not torch.equal(x[k], z[k]) for k in x
                   if x[k].numel() > 1 and x[k].std() > 0)
    gate = [k for k in a[0] if k.endswith("gate_layer.linear_layer.bias")]
    assert gate and float(a[0][gate[0]]) == -20.0
