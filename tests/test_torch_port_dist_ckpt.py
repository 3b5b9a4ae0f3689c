"""Checkpoint directories on the CPU: the JAX package's sharded and orbax
directories read by the port (train/sharded_ckpt.py, train/orbax_ckpt.py,
train/checkpoints.py:jax_payload), the port's own
``torch.distributed.checkpoint`` directory (train/dist_ckpt.py) on one
rank and two, ``AsyncSaver``, and the ``.pt`` branch of
``load_model_for_inference`` against JAX's.

- One JAX state (perturbed params on the JAX tests' (4, 2) data x model
  mesh, so the sharded format splits leaves into regions; three masked
  updates) with RAdam, with Adam, and with RAdam and ``finetune_layers``
  frozen, written by the JAX package as a pickle, a sharded directory and
  an orbax directory: the port loads all three into model and optimizer
  state_dicts that are bitwise equal.
- A bf16 leaf; an incomplete sharded directory and an unmarked orbax one
  raise; without ``tensorstore`` an orbax directory raises naming it;
  ``warmstart`` with ``include_layers`` and ``ignore_layers`` on JAX's
  flat keys, as from the pickle.
- The port's directory: saved and resumed bitwise on one rank,
  warm-started with a speaker table of another size dropped (two ranks
  write it in tests/test_torch_port_ddp.py).
- ``AsyncSaver``: ``wait()`` and its error; ``train()`` writing
  ``checkpoint_format: orbax`` (the port's directory) and a resume with
  ``sharded_checkpoints: true`` that carries on the uninterrupted loss
  curve.
- ``.pt`` for inference: an unknown key ignored, a missing key and a
  speaker table of another size keeping their init, as JAX's loader; mel
  within 1e-4 of JAX's on the same latents, the same loaded names; any
  other shape mismatch raises in both."""

import json
import os
import sys

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.infer.sampling import (  # noqa: E402
    load_model_for_inference as jax_load_model_for_inference,
)
from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.parallel.mesh import make_mesh, place_params  # noqa: E402
from flowtron_tpu.train.checkpoints import (  # noqa: E402
    import_torch_state_dict, save_checkpoint as jax_save_checkpoint,
    trainable_mask,
)
from flowtron_tpu.train.radam import (  # noqa: E402
    build_optimizer as jax_build_optimizer, masked_optimizer,
)

from flowtron_tpu_torch.infer import sampling  # noqa: E402
from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.train import dist_ckpt  # noqa: E402
from flowtron_tpu_torch.train.checkpoints import (  # noqa: E402
    AsyncSaver, checkpoint_kind, jax_leaf_order, load_checkpoint, warmstart,
)
from flowtron_tpu_torch.train.radam import (  # noqa: E402
    build_optimizer, trainable_parameters,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)

from tests.test_torch_port_ddp import (  # noqa: E402
    _config, _train_overrides,
)
from tests.test_torch_port_train import DIMS, perturbed_jax_params  # noqa: E402

LR, WD, CLIP = 5e-3, 1e-6, 1.0
STEPS = 3
CASES = {"radam": ("RAdam", ()), "adam": ("Adam", ()),
         "radam_frozen": ("RAdam", ["flows.1", "speaker_embedding"])}
FORMATS = ("pickle", "sharded", "orbax")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread here: the suite runs several workers a core's
    worth of them, and the ranks and engines of these tests beside them;
    torch's default of a thread a core slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(seed, finetune=(), algo="RAdam", **kw):
    model, _ = flowtron_init(seed, n_flows=2, use_gate_layer=True,
                             **dict(DIMS, **kw))
    params = [p for _, p in trainable_parameters(model, finetune)]
    return model, build_optimizer(params, algo, LR, WD)


@pytest.fixture(scope="module", params=list(CASES))
def jax_dirs(request, tmp_path_factory):
    """The JAX state after STEPS masked updates from seeded gradients,
    written in each format by the JAX package's save_checkpoint."""
    algo, finetune = CASES[request.param]
    mesh = make_mesh((4, 2), ("data", "model"))
    params, _ = perturbed_jax_params()
    params = place_params(params, mesh)
    opt = masked_optimizer(jax_build_optimizer(algo, LR, WD, CLIP),
                           trainable_mask(params, finetune))
    state = jax.jit(opt.init)(params)

    @jax.jit
    def update(g, state, p):
        u, state = opt.update(g, state, p)
        return optax.apply_updates(p, u), state

    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        g = jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
            x.shape).astype(np.float32)), params)
        params, state = update(g, state, params)
    root = tmp_path_factory.mktemp(request.param)
    for fmt in FORMATS:
        jax_save_checkpoint(str(root / fmt), params, state, STEPS, LR,
                            {"case": request.param}, fmt=fmt)
    return dict(root=root, algo=algo, finetune=finetune, params=params)


def _loaded(jax_dirs, fmt, **kw):
    model, opt = _port(5, jax_dirs["finetune"], jax_dirs["algo"])
    it = load_checkpoint(str(jax_dirs["root"] / fmt), model, opt, **kw)
    return it, model, opt


def test_sharded_and_orbax_load_as_the_pickle(jax_dirs):
    """Model and optimizer state_dicts bitwise equal over the three
    formats; the params are JAX's; a sharded leaf spans regions."""
    index = json.loads((jax_dirs["root"] / "sharded" / "index.json")
                       .read_text())
    assert any(len(m.get("shards", ())) > 1 for m in index["arrays"].values())
    assert [checkpoint_kind(str(jax_dirs["root"] / f)) for f in FORMATS] == \
        ["jax_pickle", "jax_sharded", "orbax"]
    ref_it, ref_model, ref_opt = _loaded(jax_dirs, "pickle")
    ref_opt_sd = ref_opt.state_dict()
    assert ref_it == STEPS and ref_opt_sd["state"]
    theirs = flowtron_state_dict_from_jax(_np(jax_dirs["params"]))
    for name, value in ref_model.state_dict().items():
        assert torch.equal(value, theirs[name]), name
    for fmt in FORMATS[1:]:
        it, model, opt = _loaded(jax_dirs, fmt)
        assert it == STEPS
        for name, value in model.state_dict().items():
            assert torch.equal(value, ref_model.state_dict()[name]), \
                (fmt, name)
        sd = opt.state_dict()
        assert sd["state"].keys() == ref_opt_sd["state"].keys()
        for i, s in sd["state"].items():
            for k, v in s.items():
                r = ref_opt_sd["state"][i][k]
                assert (torch.equal(v, r) if torch.is_tensor(v)
                        else v == r), (fmt, i, k)


def test_optimizer_leaf_count_mismatch_raises(jax_dirs):
    """A port optimizer over other parameters than JAX's mask needs
    another number of leaves: refused, not loaded out of order."""
    other = [] if jax_dirs["finetune"] else ["encoder"]
    for fmt in FORMATS[1:]:
        model, opt = _port(5, other, jax_dirs["algo"])
        with pytest.raises(ValueError, match="optimizer state mismatch"):
            load_checkpoint(str(jax_dirs["root"] / fmt), model, opt)


def test_jax_leaf_order():
    keys = ["flows.10.w", "flows.2.w", "b.z", "a.1", "a.0", "flows.2.b"]
    assert jax_leaf_order(keys) == ["a.0", "a.1", "b.z", "flows.2.b",
                                    "flows.2.w", "flows.10.w"]


def test_warmstart_and_ignore_layers_on_directories(jax_dirs):
    """include_layers and ignore_layers on JAX's flat keys give what they
    give from the pickle."""
    include = ["embedding", "flows.0"]
    ignore = ["embedding.table", "flows.0.conv.w"]
    ref = {}
    for fmt in FORMATS:
        model, _ = _port(9)
        names = warmstart(str(jax_dirs["root"] / fmt), model, include)
        assert names and all(n.startswith(("embedding", "flows.0",
                                           "speaker_embedding"))
                             for n in names)
        _, model2, opt2 = _loaded(jax_dirs, fmt, ignore_layers=ignore)
        assert not opt2.state
        out = (names, model.state_dict(), model2.state_dict())
        if fmt == "pickle":
            ref = out
            continue
        assert out[0] == ref[0]
        for a, b in ((out[1], ref[1]), (out[2], ref[2])):
            for name, value in a.items():
                assert torch.equal(value, b[name]), (fmt, name)


def test_bf16_leaf_and_incomplete_directories(tmp_path, monkeypatch):
    params, _ = perturbed_jax_params(seed=3)
    params["embedding"]["table"] = params["embedding"]["table"].astype(
        jnp.bfloat16)
    expect = np.asarray(params["embedding"]["table"].astype(jnp.float32))
    for fmt in ("sharded", "orbax"):
        path = str(tmp_path / fmt)
        jax_save_checkpoint(path, params, None, 1, LR, None, fmt=fmt)
        model, _ = _port(1)
        assert load_checkpoint(path, model) == 1
        np.testing.assert_array_equal(model.embedding.weight.detach().numpy(),
                                      expect)
    # a shard missing: uncovered elements raise
    index = json.loads((tmp_path / "sharded" / "index.json").read_text())
    os.remove(tmp_path / "sharded" /
              index["arrays"]["embedding.table"]["shards"][0]["file"])
    with pytest.raises(ValueError, match="uncovered"):
        load_checkpoint(str(tmp_path / "sharded"), _port(1)[0])
    # no tensorstore: an orbax directory names it
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "tensorstore", None)
        with pytest.raises(RuntimeError, match="tensorstore"):
            load_checkpoint(str(tmp_path / "orbax"), _port(1)[0])
    # without its meta.json (written last) an orbax save is no checkpoint
    os.remove(tmp_path / "orbax" / "meta.json")
    with pytest.raises(ValueError, match="not a checkpoint directory"):
        load_checkpoint(str(tmp_path / "orbax"), _port(1)[0])


# --------------------------------------------------------------------------
# the port's directory
# --------------------------------------------------------------------------

def _assert_same(model, opt, ref_model, ref_opt_state):
    for name, value in model.state_dict().items():
        assert torch.equal(value, ref_model[name]), name
    state = opt.state_dict()["state"]
    assert state.keys() == ref_opt_state.keys()
    for i, s in state.items():
        for k, v in s.items():
            r = ref_opt_state[i][k]
            assert (torch.equal(v, r) if torch.is_tensor(v) else v == r), \
                (i, k)


@pytest.mark.parametrize("algo", ["RAdam", "Adam"])
def test_dcp_save_and_resume_one_rank(tmp_path, algo):
    model, opt = _port(2, algo=algo)
    g = torch.Generator().manual_seed(3)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    path = str(tmp_path / "model_4")
    saver = AsyncSaver()
    saver.save(path, model, opt, 4, LR, {"c": 1}, fmt="sharded")
    saver.wait()
    assert checkpoint_kind(path) == "dcp"
    assert sorted(os.listdir(tmp_path)) == ["model_4"]   # .tmp swapped in
    fresh, fresh_opt = _port(7, algo=algo)
    assert load_checkpoint(path, fresh, fresh_opt) == 4
    _assert_same(fresh, fresh_opt, model.state_dict(),
                 opt.state_dict()["state"])
    assert dist_ckpt.read_marker(path)["optimizer"] == algo
    # warmstart from it into a model with another speaker table
    other, _ = _port(8, n_speakers=3)
    names = warmstart(path, other, ["speaker", "encoder", "embedding"])
    assert "speaker_embedding.weight" not in names and names
    for n in names:
        assert torch.equal(other.state_dict()[n], model.state_dict()[n]), n


def test_async_saver_waits_and_reports_errors(tmp_path):
    model, opt = _port(1)
    saver = AsyncSaver()
    saver.save(str(tmp_path / "m.pt"), model, opt, 2, LR, None)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():               # the snapshot was taken already
        for p in model.parameters():
            p.add_(1.0)
    saver.wait()
    saved = torch.load(tmp_path / "m.pt", weights_only=True)["model"]
    for name, value in saved.items():
        assert torch.equal(value, before[name]), name
    (tmp_path / "file").write_text("")
    saver.save(str(tmp_path / "file" / "m.pt"), model, opt, 3, LR, None)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        saver.wait()
    saver.wait()                        # the error is reported once


def _losses(out_dir):
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return {r["iteration"]: r["loss"] for r in map(json.loads, f)
                if "loss" in r}


def test_async_directory_resume_continues_the_loss_curve(tmp_path,
                                                         monkeypatch, capsys):
    """train() with checkpoint_format orbax (the port's directory, said so
    once), one batch an epoch over 4 epochs, checkpoints at iterations 0
    and 2; then a resume from model_2 with sharded_checkpoints true: its
    iteration 3 loss is the uninterrupted run's."""
    from flowtron_tpu_torch.data.synth import make_aligned_corpus
    from flowtron_tpu_torch.train.loop import train
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    corpus = make_aligned_corpus(str(tmp_path / "corpus"), n_utterances=6,
                                 seed=2, val_count=2)
    out = str(tmp_path / "run")
    config = _config(_train_overrides(
        *corpus, out, **{"train_config.epochs": 4,
                         "train_config.checkpoint_format": "orbax"}))
    train(config)
    assert "writes its own torch.distributed.checkpoint" in \
        capsys.readouterr().out
    assert sorted(d for d in os.listdir(out) if d.startswith("model_")) \
        == ["model_0", "model_2"]
    losses = _losses(out)
    assert sorted(losses) == [0, 1, 2, 3]

    resumed = str(tmp_path / "resumed")
    config = _config(_train_overrides(
        *corpus, resumed, **{"train_config.epochs": 4,
                             "train_config.sharded_checkpoints": True,
                             "train_config.checkpoint_path":
                             os.path.join(out, "model_2")}))
    _, _, iteration = train(config)
    assert iteration == 4
    again = _losses(resumed)
    assert sorted(again) == [3]
    assert abs(again[3] - losses[3]) <= 1e-5 * abs(losses[3])


# --------------------------------------------------------------------------
# .pt for inference, as JAX's loader
# --------------------------------------------------------------------------

def test_pt_inference_load_follows_jax_rules(tmp_path, monkeypatch):
    dims = dict(DIMS, n_speakers=2)
    config = {"model_config": dict(dims, n_flows=2, use_gate_layer=True)}
    init, cfg = jax_init(jax.random.PRNGKey(0), **config["model_config"])
    trained, _ = perturbed_jax_params(seed=6)
    sd = flowtron_state_dict_from_jax(_np(trained))
    sd["speaker_embedding.weight"] = torch.randn(3, dims["n_speaker_dim"])
    sd["some_module.unknown"] = torch.zeros(2)
    del sd["encoder.convolutions.0.1.weight"]         # keeps its init
    path = str(tmp_path / "ref.pt")
    torch.save({"state_dict": sd}, path)

    # the port's model starts from JAX's init, so "keeps its init" agrees
    def from_jax_init(seed, **kw):
        model, static = flowtron_init(seed, **kw)
        model.load_state_dict(flowtron_state_dict_from_jax(_np(init)))
        return model, static
    monkeypatch.setattr(sampling, "flowtron_init", from_jax_init)
    model, tcfg = sampling.load_model_for_inference(config, path)
    params, jcfg = jax_load_model_for_inference(config, path)
    probe, _ = from_jax_init(0, **config["model_config"])
    ours = set(warmstart(path, probe))
    _, theirs = import_torch_state_dict(
        jax_init(jax.random.PRNGKey(0), **config["model_config"])[0],
        {k: v.numpy() for k, v in sd.items()})
    assert ours == set(theirs)
    assert "speaker_embedding.weight" not in ours
    for name in ("speaker_embedding.weight",
                 "encoder.convolutions.0.1.weight"):
        assert torch.equal(model.state_dict()[name],
                           flowtron_state_dict_from_jax(_np(init))[name])

    rng = np.random.default_rng(1)
    residual = (rng.standard_normal((1, dims["n_mel_channels"], 12))
                * 0.5).astype(np.float32)
    text = rng.integers(1, 185, (1, 6))
    mel_j, _, _ = jax_flowtron_infer(params, jcfg, jnp.asarray(residual),
                                     jnp.asarray([1]), jnp.asarray(text),
                                     gate_threshold=1e6)
    with torch.no_grad():
        mel, _, _ = sampling.flowtron_infer(
            model, tcfg, torch.from_numpy(residual), torch.tensor([1]),
            torch.from_numpy(text), gate_threshold=1e6)
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=1e-4)

    sd["embedding.weight"] = torch.zeros(7, dims["n_text_dim"])
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match="shape"):
        sampling.load_model_for_inference(config, path)
    with pytest.raises(ValueError, match="shape"):
        jax_load_model_for_inference(config, path)
