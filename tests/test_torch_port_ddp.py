"""Data-parallel training of the port over ``torch.distributed`` (gloo on
the CPU, ranks started by ``flowtron_tpu_torch/parallel/launch.py``)
against the JAX package and against the port's one process:

- ``BatchIterator``'s shards equal JAX's index lists, wrap-around
  included;
- two ranks of ``make_train_step`` on the rows of a batch, split so that
  the ranks hold different frame counts and are padded apart, against
  JAX's ``make_train_step`` on the whole batch (``dropout_key=None``):
  loss 1e-5 at each of 3 steps, parameters 1e-4 of each tensor's largest
  (and at most 1e-10 apart), the ranks bitwise equal; averaging per-rank losses (DDP's default)
  would miss that bar;
- ``train()`` on two ranks against one process at the same global batch
  (losses 1e-5 a step), its validation loss against JAX's
  ``compute_validation_loss``, its checkpoint directory (written by both
  ranks) resumed in one process;
- the vocoder trainer on two ranks against one;
- ``entry.dryrun_multichip(2)``;
- the process grid and its refusals.

The ranks run without dropout (tests/torch_ddp_ranks.py:no_dropout):
their masks are drawn per rank and cannot match one process's."""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.data.collate import (  # noqa: E402
    BatchIterator as JaxBatchIterator,
)
from flowtron_tpu.models import flowtron_init as jax_init  # noqa: E402
from flowtron_tpu.parallel.mesh import data_sharded, make_mesh  # noqa: E402
from flowtron_tpu.train.checkpoints import trainable_mask  # noqa: E402
from flowtron_tpu.train.loop import (  # noqa: E402
    compute_validation_loss as jax_validation_loss,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
    prepare_dataloaders as jax_prepare_dataloaders,
)
from flowtron_tpu.train.loss import flowtron_loss as jax_loss  # noqa: E402
from flowtron_tpu.train.radam import (  # noqa: E402
    build_optimizer as jax_build_optimizer, masked_optimizer,
)

from flowtron_tpu_torch.config import load_config  # noqa: E402
from flowtron_tpu_torch.data.collate import BatchIterator  # noqa: E402
from flowtron_tpu_torch.data.synth import make_aligned_corpus  # noqa: E402
from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.parallel.launch import launch  # noqa: E402
from flowtron_tpu_torch.parallel.mesh import (  # noqa: E402
    batch_shard_size, process_grid,
)
from flowtron_tpu_torch.train.checkpoints import load_checkpoint  # noqa: E402
from flowtron_tpu_torch.train.loss import flowtron_loss  # noqa: E402
from flowtron_tpu_torch.train.radam import (  # noqa: E402
    build_optimizer, trainable_parameters,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_jax_from_state_dict, flowtron_state_dict_from_jax,
)

from tests.test_torch_port_train import (  # noqa: E402
    DIMS, _port_out, perturbed_jax_params, port_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = "tests.torch_ddp_ranks"
CPU_ENV = {"FLOWTRON_PLATFORM": "cpu", "OMP_NUM_THREADS": "1"}
TRAIN_CFG = {"sigma": 1.0, "gate_loss": True, "use_ctc_loss": True,
             "blank_logprob": -8, "learning_rate": 5e-3,
             "weight_decay": 1e-6, "grad_clip_val": 1.0,
             "optim_algo": "RAdam"}
CTC_W = 0.01
# rows 0-1 go to rank 0 (34 frames), rows 2-3 to rank 1 (15 frames)
OUT_LENS, IN_LENS = [18, 16, 9, 6], [7, 6, 4, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch on one thread here: the suite runs several workers a core's
    worth of them, and the ranks and engines of these tests beside them;
    torch's default of a thread a core slows every one of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# shards
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,world,batch", [
    (12, 2, 3), (13, 2, 3), (10, 4, 2), (7, 3, 2), (9, 1, 4), (5, 4, 1)])
def test_batch_iterator_shards_match_jax(n, world, batch):
    """Each shard's batches of indices, two epochs, shuffled and not,
    drop_last or not: the port's BatchIterator gives JAX's lists."""
    data = list(range(n))
    for shuffle, drop_last in ((True, True), (False, False)):
        for r in range(world):
            kw = dict(shuffle=shuffle, seed=5, drop_last=drop_last,
                      num_shards=world, shard_index=r)
            ours = BatchIterator(data, batch, list, **kw)
            theirs = JaxBatchIterator(data, batch, list, **kw)
            assert len(ours) == len(theirs)
            for _ in range(2):
                assert list(ours) == list(theirs)


def test_shards_together_are_the_global_batch():
    """With stride sharding the ranks' batches at step i are the
    one-process batch of world * batch at step i."""
    data = list(range(24))
    one = list(BatchIterator(data, 6, list, seed=3))
    ranks = [list(BatchIterator(data, 3, list, seed=3, num_shards=2,
                                shard_index=r)) for r in range(2)]
    for i, rows in enumerate(one):
        assert sorted(ranks[0][i] + ranks[1][i]) == sorted(rows)


# --------------------------------------------------------------------------
# the step against JAX
# --------------------------------------------------------------------------

def _global_batch(seed):
    """A B=4 batch, padded to T=18, Tk=7; numpy."""
    rng = np.random.default_rng(seed)
    B, T, Tk, M = 4, 18, 7, DIMS["n_mel_channels"]
    mel = rng.standard_normal((B, M, T)).astype(np.float32) - 2.0
    text = rng.integers(1, 185, (B, Tk))
    gate = np.zeros((B, T), np.float32)
    prior = np.zeros((B, T, Tk), np.float32)
    for b, (t, k) in enumerate(zip(OUT_LENS, IN_LENS)):
        mel[b, :, t:] = 0
        text[b, k:] = 0
        gate[b, t - 1:] = 1
        p = rng.uniform(0.05, 1.0, (t, k))
        prior[b, :t, :k] = p / p.sum(-1, keepdims=True)
    return {"mel": mel, "speaker_ids": np.asarray([0, 1, 0, 1]),
            "text": text, "in_lens": np.asarray(IN_LENS),
            "out_lens": np.asarray(OUT_LENS), "gate_target": gate,
            "attn_prior": prior}


def _rank_rows(batch, rows):
    """Rows of a global batch, padded to their own longest (a rank
    collates its shard alone)."""
    T = int(batch["out_lens"][rows].max())
    Tk = int(batch["in_lens"][rows].max())
    out = {k: v[rows] for k, v in batch.items()}
    out["mel"] = out["mel"][:, :, :T]
    out["gate_target"] = out["gate_target"][:, :T]
    out["text"] = out["text"][:, :Tk]
    out["attn_prior"] = out["attn_prior"][:, :T, :Tk]
    return out


SPLIT = (slice(0, 2), slice(2, 4))


def _launches(*calls):
    """``launch`` each (target, world, kwargs) at once (the ranks are
    processes of their own); their results in order."""
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(launch, f"{RANKS}:{target}", world, kwargs,
                               env=CPU_ENV) for target, world, kwargs in calls]
        return [f.result() for f in futures]


@pytest.fixture(scope="module")
def step_runs():
    """JAX's make_train_step on the whole batch, 3 steps, no dropout, and
    the port's two ranks from the same weights on its rows (started
    first: they run beside JAX's compile)."""
    params, cfg = perturbed_jax_params()
    np_params = jax.tree.map(np.asarray, params)   # the step donates
    batches = [_global_batch(s) for s in range(3)]
    model, _ = port_model(np_params)
    pool = ThreadPoolExecutor(1)
    ranks = pool.submit(launch, f"{RANKS}:step_rank", 2, dict(
        state=model.state_dict(), dims=DIMS,
        batches=[[_rank_rows(b, rows) for b in batches] for rows in SPLIT],
        train_cfg=TRAIN_CFG, ctc_weight=CTC_W), env=CPU_ENV)
    mesh = make_mesh((1,))
    opt = masked_optimizer(jax_build_optimizer(
        "RAdam", TRAIN_CFG["learning_rate"], TRAIN_CFG["weight_decay"],
        TRAIN_CFG["grad_clip_val"]), trainable_mask(params))
    opt_state = opt.init(params)
    step = jax_make_train_step(cfg, mesh, opt, TRAIN_CFG)
    shard = data_sharded(mesh)
    losses = []
    for batch in batches:
        params, opt_state, m = step(
            params, opt_state, {k: jax.device_put(v, shard)
                                for k, v in batch.items()},
            None, jnp.asarray(CTC_W), jnp.asarray(1.0))
        losses.append(float(m["loss"]))
    final = flowtron_state_dict_from_jax(jax.tree.map(np.asarray, params))
    try:
        two = ranks.result()
    finally:
        pool.shutdown()
    return dict(np_params=np_params, batches=batches, losses=losses,
                final=final), two


def test_two_ranks_step_matches_jax(step_runs):
    jax_run, two_ranks = step_runs
    frames = [sum(OUT_LENS[s]) for s in SPLIT]
    assert frames[0] != frames[1]
    for r in two_ranks:
        for ours, theirs in zip(r["metrics"], jax_run["losses"]):
            assert abs(ours["loss"] - theirs) <= 1e-5 * abs(theirs), \
                (ours["loss"], theirs)
    assert [m["frames"] for m in two_ranks[0]["metrics"]] == \
        [float(sum(OUT_LENS))] * 3
    for name, ref in jax_run["final"].items():
        got = two_ranks[0]["state"][name]
        # the floor: a conv bias before an instance norm has no gradient,
        # so it holds rounding noise of ~1e-12 in both packages
        scale = max(float(ref.abs().max()), 1e-6)
        assert float((got - ref).abs().max()) <= 1e-4 * scale, name
    for name, a in two_ranks[0]["state"].items():
        assert torch.equal(a, two_ranks[1]["state"][name]), name


def test_per_rank_loss_averaging_misses_the_bar(step_runs):
    """DDP's default, the mean of the ranks' own means, against JAX's
    global-batch loss on the first batch: more than 1e-5 apart when the
    ranks hold different frame counts. The port's global counts meet it
    (the sum of its ranks' losses)."""
    jax_run = step_runs[0]
    params, cfg = perturbed_jax_params()
    batch = jax_run["batches"][0]
    jax_out = jax.jit(lambda p, b: jax_loss(
        _jax_forward(p, cfg, b), b["gate_target"], b["in_lens"],
        b["out_lens"], sigma=1.0, use_ctc_loss=True, blank_logprob=-8))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    theirs = float(jax_out[0] + jax_out[1] + CTC_W * jax_out[2])
    model, tcfg = port_model(jax_run["np_params"])
    norm = torch.tensor([float(sum(OUT_LENS)), 4.0])
    averaged = summed = 0.0
    with torch.no_grad():
        for rows in SPLIT:
            b = _rank_rows(batch, rows)
            out = _port_out(model, tcfg, b, train=True)
            t = {k: torch.from_numpy(np.asarray(b[k])) for k in
                 ("gate_target", "in_lens", "out_lens")}
            kw = dict(sigma=1.0, use_ctc_loss=True, blank_logprob=-8)
            own = flowtron_loss(out, t["gate_target"], t["in_lens"],
                                t["out_lens"], **kw)
            glob = flowtron_loss(out, t["gate_target"], t["in_lens"],
                                 t["out_lens"], norm=norm, **kw)
            averaged += float(own[0] + own[1] + CTC_W * own[2]) / 2
            summed += float(glob[0] + glob[1] + CTC_W * glob[2])
    assert abs(summed - theirs) <= 1e-5 * abs(theirs)
    assert abs(averaged - theirs) > 1e-5 * abs(theirs), (averaged, theirs)


def _jax_forward(params, cfg, b):
    from flowtron_tpu.models import flowtron_forward
    return flowtron_forward(params, cfg, b["mel"], b["speaker_ids"],
                            b["text"], b["in_lens"], b["out_lens"],
                            attn_prior=b["attn_prior"], train=True)


# --------------------------------------------------------------------------
# train() on two ranks
# --------------------------------------------------------------------------

TRAIN_DIMS = dict(n_speaker_dim=4, n_text_dim=12, n_hidden=16,
                  n_attn_channels=8, mel_encoder_n_hidden=8)


def _train_overrides(train_fl, val_fl, out_dir, **extra):
    kv = {"data_config.training_files": train_fl,
          "data_config.validation_files": val_fl,
          "data_config.p_arpabet": 0.0,
          "train_config.output_directory": out_dir,
          "train_config.epochs": 1, "train_config.iters_per_checkpoint": 2,
          "train_config.with_tensorboard": False,
          "train_config.fp16_run": False,
          "train_config.batch_size": 4,
          **{f"model_config.{k}": v for k, v in TRAIN_DIMS.items()}, **extra}
    return [f"{k}={v}" for k, v in kv.items()]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_corpus")
    return make_aligned_corpus(str(tmp / "corpus"), n_utterances=16,
                               seed=4, val_count=4)


def _config(overrides):
    cwd = os.getcwd()
    os.chdir(ROOT)          # config.json's cmudict and heteronyms paths
    try:
        config = load_config("config.json", overrides)
    finally:
        os.chdir(cwd)
    for key in ("cmudict_path", "heteronyms_path"):
        config["data_config"][key] = os.path.join(
            ROOT, config["data_config"][key])
    return config


@pytest.fixture(scope="module")
def train_runs(corpus, tmp_path_factory):
    """One process and two ranks at the global batch of 4 (``batch_size``
    4 and 2: the global batch is ``batch_size`` x world): 3 steps,
    validation at iterations 0 and 2, checkpoints at 0 and 2: .pt files
    from the one process, the port's directories (``checkpoint_format:
    sharded``, both ranks writing through AsyncSaver) from the ranks."""
    tmp = tmp_path_factory.mktemp("ddp_train")
    configs = {w: _config(_train_overrides(
        *corpus, str(tmp / f"w{w}"),
        **({"train_config.checkpoint_format": "sharded",
            "train_config.batch_size": 2} if w == 2 else {})))
        for w in (1, 2)}
    runs = _launches(*(("train_rank", w, dict(config=configs[w]))
                       for w in (1, 2)))
    return {w: (configs[w], run) for w, run in zip((1, 2), runs)}


def test_train_two_ranks_match_one_process(train_runs):
    (_, one), (_, two) = train_runs[1], train_runs[2]
    steps = [[r for r in run[0]["log"] if "loss" in r] for run in (one, two)]
    assert [r["iteration"] for r in steps[1]] == [0, 1, 2]
    for a, b in zip(*steps):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(a["loss"]), (a, b)
        assert a["frames"] == b["frames"]
    vals = [[r["validation"]["loss"] for r in run[0]["log"]
             if "validation" in r] for run in (one, two)]
    np.testing.assert_allclose(vals[1], vals[0], rtol=1e-5)
    for name, a in two[0]["state"].items():
        assert torch.equal(a, two[1]["state"][name]), name


def test_two_ranks_directory_resumes_in_one_process(train_runs):
    """The ranks' last directory, model_2 (written by both ranks off the
    training thread), loads in one process: the model bitwise the ranks'
    final one, the optimizer at its step, iteration 2."""
    config, two = train_runs[2]
    out = config["train_config"]["output_directory"]
    assert sorted(f for f in os.listdir(out) if f.startswith("model_")) == \
        ["model_0", "model_2"]
    model, _ = flowtron_init(9, **config["model_config"])
    params = [p for _, p in trainable_parameters(model)]
    opt = build_optimizer(params, "RAdam", 1e-3)
    assert load_checkpoint(os.path.join(out, "model_2"), model, opt) == 2
    for name, value in model.state_dict().items():
        assert torch.equal(value, two[0]["state"][name]), name
    assert {s["step"] for s in opt.state_dict()["state"].values()} == {3}


def test_train_validation_matches_jax(train_runs):
    """The two-rank run's validation at iteration 0 (on the model after
    its first step, saved to the directory model_0) against JAX's
    compute_validation_loss over the same 4 utterances (one batch of 4;
    2 a rank)."""
    config, two = train_runs[2]
    val0 = next(r["validation"] for r in two[0]["log"]
                if r.get("iteration") == 0 and "validation" in r)
    model, _ = flowtron_init(9, **config["model_config"])
    load_checkpoint(os.path.join(config["train_config"]["output_directory"],
                                 "model_0"), model)
    sd = model.state_dict()
    jcfg = config          # the same sections and keys in both packages
    like, static = jax_init(jax.random.PRNGKey(0), **jcfg["model_config"])
    params = jax.tree.map(jnp.asarray, flowtron_jax_from_state_dict(sd, like))
    mesh = make_mesh((1,))
    eval_step = jax_make_eval_step(static, mesh, jcfg["train_config"])
    _, val_loader = jax_prepare_dataloaders(jcfg["data_config"], 4,
                                            seed=1234)
    theirs, _ = jax_validation_loss(eval_step, params, val_loader, mesh, 0.0)
    for k in ("loss", "nll", "gate", "ctc"):
        assert abs(val0[k] - theirs[k]) <= 1e-5 * max(1.0, abs(theirs[k])), \
            (k, val0[k], theirs[k])


# --------------------------------------------------------------------------
# the vocoder trainer, the dry run, the grid
# --------------------------------------------------------------------------

def test_waveglow_two_ranks_match_one(corpus, tmp_path):
    """The vocoder trainer at a global batch of 4, on one process
    (``batch_size`` 4) and on two ranks (``batch_size`` 2, 2 rows each:
    the global batch is ``batch_size`` x world): each step's loss within
    1e-5 (the parameters are not compared: Adam's first steps are +-lr
    where a gradient is rounding noise), the ranks bitwise equal, one
    checkpoint (rank 0's and the one process's, at iteration 0)."""
    def argv(batch_size):
        return ["-c", os.path.join(ROOT, "configs", "config_waveglow.json"),
                "-p", f"data_config.training_files={corpus[0]}",
                "data_config.segment_length=2048",
                f"train_config.output_directory={tmp_path}",
                f"train_config.batch_size={batch_size}",
                "train_config.epochs=1",
                "train_config.iters_per_checkpoint=1000",
                "waveglow_config.n_channels=16", "waveglow_config.n_layers=2",
                "waveglow_config.n_flows=4"]
    one, two = _launches(*(("waveglow_rank", w, dict(argv=argv(4 // w)))
                           for w in (1, 2)))
    assert len(one[0]["losses"]) == 3          # 12 files, batch 4
    np.testing.assert_allclose(two[0]["losses"], one[0]["losses"],
                               rtol=1e-5)
    assert two[0]["losses"] == two[1]["losses"]
    for name, a in two[0]["state"].items():
        assert torch.equal(a, two[1]["state"][name]), name
    assert sorted(os.listdir(tmp_path)) == ["waveglow_0.pt"]


def test_dryrun_multichip_two_ranks(capsys):
    from flowtron_tpu_torch.entry import dryrun_multichip
    stats = dryrun_multichip(2)
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("dryrun_multichip(2): mesh=(2 data), loss=")
               for ln in lines), lines
    assert any(ln.startswith("dryrun_multichip(2) infer: mel mean=")
               for ln in lines), lines
    assert stats[0]["loss"] == stats[1]["loss"]
    assert all(np.isfinite(s["loss"]) and np.isfinite(s["audio_std"])
               for s in stats)


@pytest.mark.parametrize("dist,world,grid", [
    ({"mesh_shape": [-1]}, 4, {"data": 4}),
    ({"mesh_shape": [2, -1], "mesh_axis_names": ["dcn", "data"]}, 8,
     {"dcn": 2, "data": 4}),
    ({"mesh_shape": [1, 2, 1], "mesh_axis_names": ["dcn", "data", "model"],
      "dcn_mesh_shape": [2, 1, 1]}, 4, {"dcn": 2, "data": 2, "model": 1}),
])
def test_process_grid_batch_axes(dist, world, grid):
    got = process_grid(dist, world)
    assert got == grid
    assert batch_shard_size(got) == world


def test_process_grid_refusals():
    """A `model` axis is a grid like any other now (tensor parallelism,
    tests/test_torch_port_tp.py); a grid that does not hold the world's
    ranks still raises."""
    grid = process_grid({"mesh_shape": [2, 2],
                         "mesh_axis_names": ["data", "model"]}, 4)
    assert grid == {"data": 2, "model": 2} and batch_shard_size(grid) == 2
    with pytest.raises(ValueError, match="holds 2 ranks, the run has 4"):
        process_grid({"mesh_shape": [2]}, 4)


def test_coordinator_address_rendezvous():
    """dist_config's coordinator_address / num_processes / process_id join
    two processes over TCP (gloo on the CPU): an all-reduce sums, the
    coordination barrier passes."""
    import subprocess
    import sys
    from flowtron_tpu_torch.parallel.launch import free_port
    dist = {"coordinator_address": f"127.0.0.1:{free_port()}",
            "num_processes": 2}
    code = ("import sys, torch\n"
            "from flowtron_tpu_torch.parallel import mesh\n"
            "r = int(sys.argv[1])\n"
            f"assert mesh.maybe_initialize_distributed(dict({dist!r}, "
            "process_id=r))\n"
            "t = mesh.all_reduce_sum(torch.tensor([r + 1.0]))\n"
            "mesh.coord_barrier('test')\n"
            "print('SUM', float(t), mesh.world_size(), mesh.rank(), "
            "torch.distributed.get_backend())\n"
            "mesh.destroy()\n")
    env = dict(os.environ, FLOWTRON_PLATFORM="cpu", PYTHONPATH=ROOT)
    env.pop("LOCAL_RANK", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (out, err) in enumerate(outs):
        assert procs[r].returncode == 0, err
        assert f"SUM 3.0 2 {r} gloo" in out, out
