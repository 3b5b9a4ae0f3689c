"""The port's ``model`` axis against the JAX package's (parallel/mesh.py,
parallel/tensor_parallel.py, the trainers' global batch, the serving
mesh), on the CPU: gloo ranks started by
``flowtron_tpu_torch/parallel/launch.py``, JAX on the conftest's 8 host
devices.

- ``param_shardings`` equals JAX's leaf for leaf on the (2, 4), (4, 2)
  and (2, 2, 2) meshes;
- the grid's coordinates and groups equal JAX's device order, the
  multi-slice layout of configs/config_multislice.json at world 16
  through ``create_hybrid_device_mesh``;
- the global batch is ``batch_size`` x world, as JAX's ``batch_size`` x
  n_dev: steps an epoch and the first loss of ``train()`` on two ranks
  against JAX's ``train()`` on two devices;
- a (1, 2) data x model step on two ranks against JAX's
  ``make_train_step`` on a (1, 2) mesh (losses 1e-5, gradients and
  parameters 1e-4 of each tensor's largest) and against one process, the
  slices and at-rest bytes, replicated leaves bitwise alike, a ``.pt``
  and a directory across layouts;
- ``flowtron-torch-train`` on config_multislice.json's layout at world 4
  against one process;
- a (2, 4) serving engine (``devices=[cpu] * 8``) against JAX's engine on
  its (2, 4) mesh, with and without a vocoder, in bf16 and quantized,
  JAX's three warnings, ``--mesh 2,4`` through the CLI.

Ranks and one-process port runs go without dropout
(tests/torch_ddp_ranks.py:no_dropout), JAX's with ``dropout_key=None``."""

import json
import os
import pickle
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from scipy.io import wavfile

torch = pytest.importorskip("torch")

from jax.experimental import mesh_utils  # noqa: E402

from flowtron_tpu.config import load_config as jax_load_config  # noqa: E402
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.parallel.mesh import (  # noqa: E402
    data_sharded, make_mesh, param_shardings as jax_param_shardings,
    place_params,
)
from flowtron_tpu.serve import SynthesisEngine as JaxEngine  # noqa: E402
from flowtron_tpu.train import loop as jax_loop  # noqa: E402
from flowtron_tpu.train.checkpoints import (  # noqa: E402
    save_checkpoint as jax_save_checkpoint, trainable_mask,
)
from flowtron_tpu.train.loss import flowtron_loss as jax_loss  # noqa: E402
from flowtron_tpu.train.radam import (  # noqa: E402
    build_optimizer as jax_build_optimizer, masked_optimizer, radam,
)
from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa

from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_infer, flowtron_init,
)
from flowtron_tpu_torch.parallel.launch import launch  # noqa: E402
from flowtron_tpu_torch.parallel.mesh import (  # noqa: E402
    Grid, grid_groups, param_shardings, rank_coords,
)
from flowtron_tpu_torch.serve import SynthesisEngine  # noqa: E402
from flowtron_tpu_torch.serve import engine as serve_engine  # noqa: E402
from flowtron_tpu_torch.serve.cli import build_server  # noqa: E402
from flowtron_tpu_torch.train import dist_ckpt, loop  # noqa: E402
from flowtron_tpu_torch.train.checkpoints import load_checkpoint  # noqa
from flowtron_tpu_torch.train.radam import (  # noqa: E402
    build_optimizer, trainable_parameters,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flatten_jax, flowtron_jax_keys, flowtron_state_dict_from_jax,
    radam_state_by_name,
)
from flowtron_tpu_torch.utils.weights import ShardedWeight  # noqa: E402

from tests.test_torch_port_ddp import (  # noqa: E402
    CPU_ENV, CTC_W, RANKS, TRAIN_CFG, _config, _global_batch,
    _train_overrides,
)
from tests.test_torch_port_train import (  # noqa: E402
    DIMS, perturbed_jax_params, port_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_12 = {"mesh_shape": [1, 2], "mesh_axis_names": ["data", "model"]}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _launches(*calls):
    """``launch`` each (target, world, kwargs) at once; results in
    order."""
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(launch, f"{RANKS}:{target}", world, kwargs,
                               env=CPU_ENV) for target, world, kwargs in calls]
        return [f.result() for f in futures]


def _close(got, ref, name, tol=1e-4, floor=1e-6):
    scale = max(float(ref.abs().max()), floor)
    assert float((got - ref).abs().max()) <= tol * scale, name


# --------------------------------------------------------------------------
# the layout: param_shardings, coordinates, groups
# --------------------------------------------------------------------------

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("dcn", "data", "model"))]


@pytest.mark.parametrize("shape,names", MESHES)
def test_param_shardings_match_jax(shape, names):
    """Leaf for leaf, the default model and a learned Gaussian-mixture
    one: a leaf is sharded here exactly where JAX's spec is P(None,
    'model'), along the port's dim that holds JAX's last axis."""
    mesh = make_mesh(shape, names)
    for kw in ({}, {"n_components": 2, "fixed_gaussian": False}):
        like = jax.eval_shape(lambda k: jax_init(
            k, n_flows=2, use_gate_layer=True, **DIMS, **kw)[0],
            jax.random.PRNGKey(0))
        specs = flatten_jax(jax_param_shardings(like, mesh))
        model, _ = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS,
                                 **kw)
        keys = flowtron_jax_keys(like)
        ours = param_shardings(model, dict(zip(names, shape)))
        leaves = flatten_jax(like)
        sd = model.state_dict()
        assert set(ours) == {n for n in keys if n in sd
                             and not n.split(".")[-3:-2] == ["conv_layers"]}
        n_sharded = 0
        for name, dim in ours.items():
            spec = specs[keys[name]].spec
            jax_sharded = tuple(spec) == (None, "model")
            assert jax_sharded == (dim is not None), (name, spec, dim)
            if dim is not None:
                n_sharded += 1
                jax_shape = leaves[keys[name]].shape
                # JAX's last axis is the port's dim ``dim``
                assert sd[name].shape[dim] == jax_shape[-1], name
        assert n_sharded > 20


def _fake_devices(n, per_granule):
    class Dev:
        platform = device_kind = "cpu"

        def __init__(self, i):
            self.id, self.process_index = i, i // per_granule
    return [Dev(i) for i in range(n)]


@pytest.mark.parametrize("dist,world,jax_mesh", [
    (dict(mesh_shape=[2, 4], mesh_axis_names=["data", "model"]), 8,
     lambda: make_mesh((2, 4), ("data", "model")).devices),
    (dict(mesh_shape=[4, 2], mesh_axis_names=["data", "model"]), 8,
     lambda: make_mesh((4, 2), ("data", "model")).devices),
    (dict(mesh_shape=[2, 2, 2], mesh_axis_names=["dcn", "data", "model"]), 8,
     lambda: make_mesh((2, 2, 2), ("dcn", "data", "model")).devices),
    (None, 16, lambda: mesh_utils.create_hybrid_device_mesh(
        (1, 4, 2), (2, 1, 1), devices=_fake_devices(16, 8),
        process_is_granule=True)),
    (dict(mesh_shape=[2, 2], mesh_axis_names=["data", "model"],
          dcn_mesh_shape=[2, 2]), 16,
     lambda: mesh_utils.create_hybrid_device_mesh(
         (2, 2), (2, 2), devices=_fake_devices(16, 4),
         process_is_granule=True)),
])
def test_process_grid_coords_and_groups(dist, world, jax_mesh):
    """Rank r sits where JAX's mesh puts device r (``None``: the
    multi-slice config, hybrid over two granules); the model groups are
    the mesh's rows along ``model``, the batch groups its columns, in
    row-major order over the batch axes; ``Grid`` of every rank agrees."""
    if dist is None:
        with open(os.path.join(ROOT, "configs", "config_multislice.json")) \
                as f:
            dist = json.load(f)["dist_config"]
    ids = np.vectorize(lambda d: d.id)(jax_mesh())
    names = dist["mesh_axis_names"]
    for r in range(world):
        c = rank_coords(dist, world, r)
        assert ids[tuple(c[n] for n in names)] == r
    rows = ids.reshape(-1, ids.shape[-1])        # model is the last axis
    model_groups, batch_groups = grid_groups(dist, world)
    assert model_groups == rows.tolist()
    assert batch_groups == rows.T.tolist()
    for r in range(world):
        g = Grid(dist, world, r)
        assert r in g.model_group.ranks and r in g.batch_group.ranks
        assert g.model_group.ranks == model_groups[g.batch_index]
        assert g.batch_group.ranks == batch_groups[g.model_index]
    assert g.model_size == ids.shape[-1] and g.n_batch == rows.shape[0]


# --------------------------------------------------------------------------
# fault 1: the global batch
# --------------------------------------------------------------------------

class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from flowtron_tpu_torch.data.synth import make_aligned_corpus
    tmp = tmp_path_factory.mktemp("tp_corpus")
    return make_aligned_corpus(str(tmp / "corpus"), n_utterances=16,
                               seed=4, val_count=4)


def test_global_batch_matches_jax(corpus, tmp_path, monkeypatch):
    """``batch_size`` 2 on two ranks trains JAX's global batch of 2 x 2 on
    two devices: the same steps an epoch (3 of 12 utterances) and the
    first loss within 1e-5, both from JAX's initial weights (the port
    warm-starts from them) and without dropout."""
    over = _train_overrides(*corpus, str(tmp_path / "port"),
                            **{"train_config.batch_size": 2})
    config = _config(over)
    seed = int(config["train_config"]["seed"])
    params, _ = jax_init(jax.random.split(jax.random.PRNGKey(seed))[0],
                         **config["model_config"])
    init = str(tmp_path / "init.pt")
    torch.save({"model": flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params))}, init)
    config["train_config"].update(warmstart_checkpoint_path=init,
                                  include_layers=[])       # every layer
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(launch, f"{RANKS}:train_rank", 2,
                        dict(config=config), env=CPU_ENV)

    seen = {}
    prepare, make_step = jax_loop.prepare_dataloaders, jax_loop.make_train_step

    def recording_loaders(data_config, batch_size, **kw):
        train_loader, val_loader = prepare(data_config, batch_size, **kw)
        seen["steps"], seen["batch"] = len(train_loader), batch_size
        return train_loader, val_loader

    def first_step(*args):
        real = make_step(*args)

        def step(p, s, batch, key, ctc, prior):
            out = real(p, s, batch, None, ctc, prior)
            seen["loss"] = float(out[2]["loss"])
            raise _Stop
        return step
    monkeypatch.setattr(jax_loop, "prepare_dataloaders", recording_loaders)
    monkeypatch.setattr(jax_loop, "make_train_step", first_step)
    jconfig = json.loads(json.dumps(config))
    jconfig["dist_config"] = {"mesh_shape": [2]}
    jconfig["train_config"]["output_directory"] = str(tmp_path / "jax")
    jconfig["train_config"].pop("warmstart_checkpoint_path")
    with pytest.raises(_Stop):
        jax_loop.train(jconfig)
    try:
        log = ranks.result()[0]["log"]
    finally:
        pool.shutdown()
    steps = [r for r in log if "loss" in r]
    assert seen["batch"] == 4 and seen["steps"] == 3
    assert len(steps) == seen["steps"]
    assert abs(steps[0]["loss"] - seen["loss"]) <= 1e-5 * abs(seen["loss"])


# --------------------------------------------------------------------------
# a (1, 2) data x model step: JAX, one process, two ranks
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """3 steps of one B=4 batch each: JAX's make_train_step on a (1, 2)
    mesh (and its first gradients), the port's one process, and the
    port's two ranks of a (1, 2) grid (started first, beside JAX's
    compile), which also write and read checkpoints."""
    tmp = tmp_path_factory.mktemp("tp_step")
    params, cfg = perturbed_jax_params()
    np_params = jax.tree.map(np.asarray, params)
    batches = [_global_batch(s) for s in range(3)]
    model, tcfg = port_model(np_params)
    state0 = {k: v.clone() for k, v in model.state_dict().items()}

    # the port's one process, and its directory for the ranks to resume
    ps = [p for _, p in trainable_parameters(model)]
    opt = build_optimizer(ps, "RAdam", TRAIN_CFG["learning_rate"],
                          TRAIN_CFG["weight_decay"])
    step = loop.make_train_step(model, tcfg, opt, ps, TRAIN_CFG)
    one = [{k: float(v) for k, v in step(
        loop.to_device(b, torch.device("cpu")), None, torch.tensor(CTC_W),
        torch.tensor(1.0)).items()} for b in batches]
    one_bytes = sum(t.numel() * t.element_size() for t in (
        *model.parameters(), *model.buffers()))
    one_bytes += sum(v.numel() * v.element_size() for s in opt.state.values()
                     for v in s.values() if torch.is_tensor(v))
    one_dir = str(tmp / "one")
    dist_ckpt.write(one_dir, dist_ckpt.snapshot(model, opt), 3, 1e-3)
    out_dir = str(tmp / "ranks")
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(launch, f"{RANKS}:tp_step_rank", 2, dict(
        state=state0, dims=DIMS, batches=[batches], train_cfg=TRAIN_CFG,
        ctc_weight=CTC_W, dist_config=TP_12, out_dir=out_dir,
        one_dir=one_dir), env=CPU_ENV)

    mesh = make_mesh((1, 2), ("data", "model"))
    jp = place_params(params, mesh)
    jopt = masked_optimizer(jax_build_optimizer(
        "RAdam", TRAIN_CFG["learning_rate"], TRAIN_CFG["weight_decay"],
        TRAIN_CFG["grad_clip_val"]), trainable_mask(jp))
    jstate = jax.jit(jopt.init)(jp)
    shard = data_sharded(mesh)
    first = {k: jax.device_put(v, shard) for k, v in batches[0].items()}

    def loss_fn(p, b):
        from flowtron_tpu.models import flowtron_forward
        out = flowtron_forward(p, cfg, b["mel"], b["speaker_ids"], b["text"],
                               b["in_lens"], b["out_lens"],
                               attn_prior=b["attn_prior"], train=True)
        nll, gate, ctc = jax_loss(out, b["gate_target"], b["in_lens"],
                                  b["out_lens"], sigma=1.0,
                                  use_ctc_loss=True, blank_logprob=-8)
        return nll + gate + CTC_W * ctc
    jgrads = flowtron_state_dict_from_jax(jax.tree.map(
        np.asarray, jax.jit(jax.grad(loss_fn))(jp, first)))
    jstep = jax_loop.make_train_step(cfg, mesh, jopt, TRAIN_CFG)
    losses = []
    for b in batches:
        jp, jstate, m = jstep(jp, jstate, {k: jax.device_put(v, shard)
                                            for k, v in b.items()},
                              None, jnp.asarray(CTC_W), jnp.asarray(1.0))
        losses.append(float(m["loss"]))
    jfinal = flowtron_state_dict_from_jax(jax.tree.map(np.asarray, jp))
    try:
        two = ranks.result()
    finally:
        pool.shutdown()
    return dict(jax_losses=losses, jax_grads=jgrads, jax_final=jfinal,
                one=one, one_state=model.state_dict(), one_opt=opt,
                one_model=model, one_bytes=one_bytes, one_dir=one_dir,
                out_dir=out_dir, two=two, state0=state0)


def test_tp_step_matches_jax(tp_runs):
    r = tp_runs
    for rank_run in r["two"]:
        for ours, theirs in zip(rank_run["metrics"], r["jax_losses"]):
            assert abs(ours["loss"] - theirs) <= 1e-5 * abs(theirs)
    for name, ref in r["jax_grads"].items():
        # the floor: a conv bias before an instance norm has no gradient,
        # so both packages hold rounding noise of ~1e-9 there
        _close(r["two"][0]["grads"][name], ref, name, floor=1e-4)
    for name, ref in r["jax_final"].items():
        _close(r["two"][0]["state"][name], ref, name)


def test_tp_ranks_match_one_process(tp_runs):
    """The ranks against the port's one process: losses 1e-5 a step, the
    final parameters 1e-4 of each tensor's largest; each rank holds only
    its chunk of every leaf JAX shards (along JAX's last axis), so its
    at-rest bytes are one process's less (M - 1) / M of the sharded
    leaves'; the replicated leaves, and the whole states, are bitwise
    alike on both ranks."""
    r = tp_runs
    two = r["two"]
    for ours, theirs in zip(two[0]["metrics"], r["one"]):
        assert abs(ours["loss"] - theirs["loss"]) <= 1e-5 * abs(theirs["loss"])
        assert abs(ours["grad_norm"] - theirs["grad_norm"]) \
            <= 1e-5 * theirs["grad_norm"]
    for name, ref in r["one_state"].items():
        _close(two[0]["state"][name], ref, name)
    dims = {n: d for n, d in param_shardings(r["one_model"], 2).items()
            if d is not None}
    assert set(two[0]["slices"]) == set(dims)
    sharded = 0
    for name, d in dims.items():
        whole = list(r["one_state"][name].shape)
        whole[d] //= 2
        assert two[0]["slices"][name] == tuple(whole), name
        t = r["one_state"][name]
        sharded += t.numel() * t.element_size() * (
            3 if name in r["two"][0]["grads"] else 1)
    for rank_run in two:
        assert rank_run["at_rest"] == r["one_bytes"] - sharded // 2
    for name, a in two[0]["replicated"].items():
        assert torch.equal(a, two[1]["replicated"][name]), name
    for name, a in two[0]["state"].items():
        assert torch.equal(a, two[1]["state"][name]), name


def test_tp_checkpoints_across_layouts(tp_runs):
    """The ranks' ``.pt`` is the file one process writes: its model the
    ranks' gathered state bitwise, its optimizer state_dict laid out as
    one process's (same indices and keys), the moments within 1e-4 of one
    process's. Their directory resumes in one process bitwise, and one
    process's directory resumed by the ranks (sliced, then gathered) is
    bitwise what was saved."""
    r = tp_runs
    two = r["two"][0]
    pt = torch.load(os.path.join(r["out_dir"], "model_3.pt"),
                    weights_only=True)
    one_sd = r["one_opt"].state_dict()
    assert set(pt["model"]) == set(r["one_state"])
    for name, v in pt["model"].items():
        assert torch.equal(v, two["state"][name]), name
    assert pt["optimizer"]["param_groups"] == one_sd["param_groups"]
    assert set(pt["optimizer"]["state"]) == set(one_sd["state"])
    for i, s in pt["optimizer"]["state"].items():
        assert set(s) == set(one_sd["state"][i])
        for k in ("exp_avg", "exp_avg_sq"):
            _close(s[k], one_sd["state"][i][k], (i, k))

    model, _ = flowtron_init(5, n_flows=2, use_gate_layer=True, **DIMS)
    opt = build_optimizer(list(model.parameters()), "RAdam", 1e-3)
    assert load_checkpoint(os.path.join(r["out_dir"], "model_3"), model,
                           opt) == 3
    for name, v in model.state_dict().items():
        assert torch.equal(v, two["state"][name]), name
    moments = radam_state_by_name(model, opt)
    for k in ("exp_avg", "exp_avg_sq"):
        for name, v in moments[k].items():
            assert torch.equal(v, two["moments"][k][name]), (k, name)

    back = two["back"]
    saved = radam_state_by_name(r["one_model"], r["one_opt"])
    for name, v in r["one_state"].items():
        assert torch.equal(back["state"][name], v), name
    for k in ("exp_avg", "exp_avg_sq"):
        for name, v in saved[k].items():
            assert torch.equal(back["moments"][k][name], v), (k, name)
    assert two["back_at_rest"] == two["at_rest"]


# --------------------------------------------------------------------------
# flowtron-torch-train on the multi-slice layout, at world 4
# --------------------------------------------------------------------------

def test_multislice_train_four_ranks(corpus, tmp_path):
    """configs/config_multislice.json (dcn x data x model), its mesh cut
    to (1, 1, 2) x dcn (2, 1, 1) = world 4 with 2 batch shards, through
    ``flowtron-torch-train`` on four ranks, against one process at the
    same global batch (2 x 4): losses within 1e-5 a step and the
    validation loss, and the ranks' last ``.pt`` holds the one process's
    parameter names and optimizer layout."""
    cfg = os.path.join(ROOT, "configs", "config_multislice.json")

    def argv(out, bs, mesh):
        kv = dict(kv.split("=", 1) for kv in _train_overrides(
            *corpus, out, **{"train_config.batch_size": bs}))
        kv.update({"train_config.checkpoint_format": "pickle",
                   "data_config.cmudict_path": os.path.join(
            ROOT, "data", "cmudict_dictionary"),
            "data_config.heteronyms_path": os.path.join(
                ROOT, "data", "heteronyms")})
        if not mesh:
            kv.update({"dist_config.mesh_shape": "[-1]",
                       "dist_config.mesh_axis_names": '["data"]',
                       "dist_config.dcn_mesh_shape": "None"})
        else:
            kv["dist_config.mesh_shape"] = "[1,1,2]"
        return ["-c", cfg, "-p"] + [f"{k}={v}" for k, v in kv.items()]
    one, four = _launches(
        ("train_cli_rank", 1, dict(argv=argv(str(tmp_path / "one"), 8,
                                             False))),
        ("train_cli_rank", 4, dict(argv=argv(str(tmp_path / "four"), 2,
                                             True))))
    logs = [one[0], four[0]]
    steps = [[r for r in log if "loss" in r] for log in logs]
    assert len(steps[0]) == len(steps[1]) == 1     # 12 utterances, 8 a step
    for a, b in zip(*steps):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"])
    vals = [[r["validation"]["loss"] for r in log if "validation" in r]
            for log in logs]
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)
    pts = [torch.load(str(tmp_path / d / "model_0.pt"), weights_only=True)
           for d in ("one", "four")]
    assert set(pts[0]["model"]) == set(pts[1]["model"])
    assert pts[0]["optimizer"]["param_groups"] == \
        pts[1]["optimizer"]["param_groups"]
    for name, v in pts[0]["model"].items():
        _close(pts[1]["model"][name], v, name)


# --------------------------------------------------------------------------
# the serving mesh
# --------------------------------------------------------------------------

SMALL = dict(n_speakers=1, n_speaker_dim=4, n_text=185, n_text_dim=16,
             n_mel_channels=8, n_hidden=16, n_attn_channels=8,
             n_lstm_layers=2, mel_encoder_n_hidden=8)
N_FRAMES = 6


@pytest.fixture(scope="module")
def mesh_files(tmp_path_factory):
    """JAX's TestMeshServing setting: a JAX pickle checkpoint of a 2-flow
    model (heads perturbed, so the flows move the latents) and a JAX
    WaveGlow pickle."""
    root = tmp_path_factory.mktemp("tp_serve")
    rng = np.random.default_rng(0)
    wavfile.write(root / "u.wav", 22050,
                  (rng.standard_normal(4096) * 2000).astype(np.int16))
    (root / "fl.txt").write_text(f"{root}/u.wav|hello|0\n")
    params, _ = jax_init(jax.random.PRNGKey(0), n_flows=2,
                         use_gate_layer=True, **SMALL)
    for f in params["flows"]:
        f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            f["conv"]["w"].shape).astype(np.float32))
    ckpt = str(root / "model")
    jax_save_checkpoint(ckpt, params, radam(1e-3).init(params), 0, 1e-3)
    wgp, wgc = jax_waveglow_init(jax.random.PRNGKey(1), n_mel_channels=8,
                                 n_flows=4, n_group=8, n_early_every=2,
                                 n_early_size=2, n_layers=3, n_channels=16)
    with open(root / "wg.pkl", "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, wgp),
                     "config": wgc}, f)
    config = jax_load_config(overrides=[
        f"data_config.training_files={root}/fl.txt",
        f"data_config.validation_files={root}/fl.txt",
        "data_config.p_arpabet=0.0", "data_config.cmudict_path=",
        "data_config.heteronyms_path=", "data_config.use_attn_prior=False"])
    config["model_config"] = dict(SMALL, n_flows=2, use_gate_layer=True)
    return config, ckpt, str(root / "wg.pkl")


ENGINE = dict(max_batch=4, batch_timeout_ms=20, text_buckets=(16,),
              n_frames=N_FRAMES)


@pytest.mark.parametrize("vocoder,bf16", [(False, False), (True, False),
                                          (True, True)])
def test_mesh_engine_matches_jax(mesh_files, vocoder, bf16):
    """A (2, 4) engine on ``devices=[cpu] * 8`` against JAX's engine on its
    (2, 4) mesh, on the same latents (2 rows, one a data group): the mel
    within 1e-4 of its scale (bf16: within 1e-2, two bf16 programs) and
    n_valid identical; the flows' sharded leaves are slices on the
    group's 4 devices and K1's route is off. Then the port's mesh engine
    against its engine without a mesh on the same seeds: the D-way split
    chain bitwise alike up to one int16 step (audio) or 1e-5 (mel), and
    a request served."""
    config, ckpt, wg = mesh_files
    wg = wg if vocoder else ""
    je = JaxEngine(config, ckpt, waveglow_path=wg, mesh_shape=(2, 4),
                   bf16=bf16, **ENGINE)
    eng = SynthesisEngine(config, ckpt, wg, mesh_shape=(2, 4), bf16=bf16,
                          devices=["cpu"] * 8, device="cpu", **ENGINE)
    flat = SynthesisEngine(config, ckpt, wg, bf16=bf16, device="cpu",
                           **ENGINE)
    try:
        assert eng._batch_mult == 2 and len(eng._groups) == 2
        assert eng.fused is False
        flow = eng._groups[1].model.flows[0]
        w = flow.lstm.weight_ih_l0
        assert isinstance(w, ShardedWeight) and len(w.parts) == 4
        assert w.parts[0].shape[0] * 4 == w.shape[0]
        rng = np.random.default_rng(3)
        dt = jnp.bfloat16 if bf16 else jnp.float32
        res = (0.5 * rng.standard_normal((2, 8, N_FRAMES))).astype(
            np.float32)
        ids = np.asarray(eng.frontend.get_text("Hello mesh."))
        text = np.zeros((2, 16), np.int64)
        text[:, :len(ids)] = ids
        lens = np.full(2, len(ids))
        shard = data_sharded(make_mesh((2, 4), ("data", "model")))
        args = [jax.device_put(a, shard) for a in (
            jnp.asarray(res, dt), jnp.zeros(2, jnp.int32),
            jnp.asarray(text, jnp.int32), jnp.asarray(lens, jnp.int32))]
        jmel, _, jnv = je._synth(je.params, *args, 1.0)
        jmel = np.asarray(jmel.astype(jnp.float32))
        tdt = torch.bfloat16 if bf16 else torch.float32
        for g in range(2):
            with torch.no_grad():
                mel, _, nv = flowtron_infer(
                    eng._groups[g].model, eng.static_cfg,
                    torch.from_numpy(res[g:g + 1]).to(tdt),
                    torch.zeros(1, dtype=torch.long),
                    torch.from_numpy(text[g:g + 1]), gate_threshold=0.5,
                    in_lens=torch.from_numpy(lens[g:g + 1]), fused=False)
            assert int(nv[0]) == int(jnv[g])
            tol = 1e-2 if bf16 else 1e-4
            ref = jmel[g:g + 1]
            err = np.abs(mel.float().numpy() - ref).max()
            print(f"mesh engine vs JAX, group {g}: {err:.3g} of scale "
                  f"{np.abs(ref).max():.3g}")
            assert err <= tol * np.abs(ref).max(), g

        B = 4
        seeds = np.arange(B)
        chain = (seeds, np.full(B, 0.5, np.float32), np.zeros(B, np.int64),
                 np.repeat(text[:1], B, 0), np.full(B, len(ids)), 1.0,
                 np.full(B, N_FRAMES), np.zeros(B, np.float32))
        kind, out, nv = eng._mesh_chain(*chain)
        kind0, out0, nv0 = flat._synth_vocode(*chain)
        assert kind == kind0 and torch.equal(nv, nv0)
        diff = (out.float() - out0.float()).abs().max()
        assert float(diff) <= (1.0 if vocoder else 1e-5)
        wav, _ = eng.submit("Hello mesh.", 0)
        assert len(wav) > 0 and np.isfinite(wav.astype(np.float64)).all()
    finally:
        je.shutdown()
        eng.shutdown()
        flat.shutdown()


@pytest.fixture(scope="module")
def wide_ckpt(tmp_path_factory, mesh_files):
    """A reference ``.pt`` of the mesh model at n_hidden 128 (heads
    perturbed), so that the quantizer (65536 elements and up) takes the
    flows' LSTM weights; both packages' engines read it."""
    config, _, _ = mesh_files
    wide = dict(SMALL, n_hidden=128)
    model, _ = flowtron_init(1, n_flows=2, use_gate_layer=True, **wide)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for f in model.flows:
            head = getattr(f, "ar_step", f).conv.weight
            head.copy_(0.05 * torch.randn(head.shape, generator=g))
    ckpt = str(tmp_path_factory.mktemp("tp_wide") / "ft.pt")
    torch.save({"state_dict": model.state_dict()}, ckpt)
    return dict(config, model_config=dict(wide, n_flows=2,
                                          use_gate_layer=True)), ckpt


@pytest.mark.parametrize("quantize", ["w8", "w8a8", "w4"])
def test_quantized_mesh_engine(wide_ckpt, quantize):
    """``--quantize`` under a mesh, as the JAX engine takes it: the flows
    quantized, then sharded, so each sharded leaf is int8 or int4 slices
    with their scales. w8 and w4 against JAX's engine on its (2, 4) mesh
    (mel 1e-4 of the scale, n_valid identical); w8a8 against the port's
    engine without a mesh (1e-5): on the CPU JAX dequantizes an ``a8``
    leaf where the port runs K4's plain version (tests/
    test_torch_port_quant.py holds that route against JAX's kernel)."""
    from flowtron_tpu_torch.utils.weights import QuantizedWeight
    config, ckpt = wide_ckpt
    kw = dict(ENGINE, quantize=quantize)
    eng = SynthesisEngine(config, ckpt, mesh_shape=(2, 4),
                          devices=["cpu"] * 8, device="cpu", **kw)
    ref = JaxEngine(config, ckpt, mesh_shape=(2, 4), **kw) \
        if quantize != "w8a8" else SynthesisEngine(config, ckpt,
                                                  device="cpu", **kw)
    try:
        w = eng._groups[1].model.flows[0].lstm.weight_hh_l0
        assert isinstance(w, ShardedWeight) and len(w.parts) == 4
        assert all(isinstance(p, QuantizedWeight) for p in w.parts)
        rng = np.random.default_rng(5)
        res = (0.5 * rng.standard_normal((2, 8, N_FRAMES))).astype(
            np.float32)
        ids = np.asarray(eng.frontend.get_text("Hello mesh."))
        text = np.zeros((2, 16), np.int64)
        text[:, :len(ids)] = ids
        lens = np.full(2, len(ids))
        if quantize == "w8a8":
            with torch.no_grad():
                rmel, _, rnv = flowtron_infer(
                    ref.model, ref.static_cfg, torch.from_numpy(res),
                    torch.zeros(2, dtype=torch.long),
                    torch.from_numpy(text), gate_threshold=0.5,
                    in_lens=torch.from_numpy(lens))
            rmel, rnv, tol = rmel.numpy(), rnv.numpy(), 1e-5
        else:
            shard = data_sharded(make_mesh((2, 4), ("data", "model")))
            rmel, _, rnv = ref._synth(ref.params, *[
                jax.device_put(a, shard) for a in (
                    jnp.asarray(res), jnp.zeros(2, jnp.int32),
                    jnp.asarray(text, jnp.int32),
                    jnp.asarray(lens, jnp.int32))], 1.0)
            rmel, rnv, tol = np.asarray(rmel), np.asarray(rnv), 1e-4
        for g in range(2):
            with torch.no_grad():
                mel, _, nv = flowtron_infer(
                    eng._groups[g].model, eng.static_cfg,
                    torch.from_numpy(res[g:g + 1]),
                    torch.zeros(1, dtype=torch.long),
                    torch.from_numpy(text[g:g + 1]), gate_threshold=0.5,
                    in_lens=torch.from_numpy(lens[g:g + 1]))
            assert int(nv[0]) == int(rnv[g])
            assert np.abs(mel.numpy() - rmel[g:g + 1]).max() \
                <= tol * np.abs(rmel).max(), g
    finally:
        eng.shutdown()
        ref.shutdown()


def test_mesh_warnings_and_decisions(mesh_files, capsys):
    """JAX's three warnings and three decisions: replicas ignored,
    ``vocode_buckets`` off, ``fused`` off; too few devices raises naming
    the count, as JAX's reshape does."""
    config, ckpt, wg = mesh_files
    eng = SynthesisEngine(config, ckpt, wg, mesh_shape=(2, 1), replicas=2,
                          vocode_buckets=[2], fused=True,
                          devices=["cpu", "cpu"], device="cpu", **ENGINE)
    try:
        out = capsys.readouterr().out
        for line in ("WARNING: --replicas is incompatible with --mesh; "
                     "ignoring replicas",
                     "WARNING: --vocode-buckets is not supported with "
                     "--mesh; using the one-dispatch chain",
                     "WARNING: --fused is incompatible with --mesh "
                     "(VMEM-resident kernel vs TP-sharded weights); "
                     "disabling fused"):
            assert line in out
        assert eng._n_replicas == 1 and eng._vocode_buckets is None
        assert eng.fused is False
        assert eng.batch_buckets() == [2, 4]
    finally:
        eng.shutdown()
    with pytest.raises(ValueError, match="needs 8 devices; 1 given"):
        SynthesisEngine(config, ckpt, mesh_shape=(2, 4), device="cpu",
                        **ENGINE)


def test_mesh_through_the_cli(mesh_files, monkeypatch, tmp_path):
    """``--mesh 2,4`` through ``build_server`` with eight visible
    devices: the engine's data groups and a request over HTTP."""
    config, ckpt, wg = mesh_files
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    monkeypatch.setattr(serve_engine, "local_devices",
                        lambda device: [torch.device("cpu")] * 8)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(config))
    server, engines = build_server(
        ["-c", str(cfg), "-f", ckpt, "-w", wg, "--port", "0", "--n-frames",
         str(N_FRAMES), "--mesh", "2,4", "--max-batch", "2"],
        host="127.0.0.1")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        eng = engines["default"]
        assert len(eng._groups) == 2 and eng._batch_mult == 2
        url = f"http://127.0.0.1:{server.server_address[1]}/synthesize"
        req = urllib.request.Request(url, data=json.dumps(
            {"text": "Hello mesh."}).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
        assert body[:4] == b"RIFF" and len(body) > 44
    finally:
        server.shutdown()
        server.server_close()
        for e in engines.values():
            e.shutdown()
