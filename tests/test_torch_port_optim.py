"""The port's optimizer, training step and checkpoints against the JAX
package: RAdam and Adam trajectories, optax's global-norm clip, one full
step of make_train_step with finetune_layers frozen, the weight and
moment bridges of utils/convert.py, checkpoint save / resume /
warmstart, and the refusals of the unported loop features."""

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.parallel.mesh import data_sharded, make_mesh  # noqa: E402
from flowtron_tpu.train.checkpoints import trainable_mask  # noqa: E402
from flowtron_tpu.train.loop import (  # noqa: E402
    make_train_step as jax_make_train_step,
    prior_strength_schedule as jax_schedule,
)
from flowtron_tpu.train.radam import (  # noqa: E402
    build_optimizer as jax_build_optimizer, masked_optimizer, radam,
)

from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.train.checkpoints import (  # noqa: E402
    load_checkpoint, save_checkpoint, warmstart,
)
from flowtron_tpu_torch.train.loop import (  # noqa: E402
    make_train_step, prior_strength_schedule, to_device, train,
)
from flowtron_tpu_torch.train.radam import (  # noqa: E402
    RAdam, build_optimizer, clip_by_global_norm, trainable_parameters,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_jax_from_state_dict, flowtron_state_dict_from_jax,
    radam_state_by_name, radam_state_from_jax,
)

from tests.test_torch_port_train import (  # noqa: E402
    DIMS, make_batch, perturbed_jax_params, port_model,
)

TRAIN_CFG = {"sigma": 1.0, "gate_loss": True, "use_ctc_loss": True,
             "blank_logprob": -8, "learning_rate": 5e-3,
             "weight_decay": 1e-6, "grad_clip_val": 1.0,
             "optim_algo": "RAdam"}
FINETUNE = ["flows.0", "encoder"]


def _grad_sequence(n_steps, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (4, 3), "b": (5,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * (1 + 0.2 * i)
              for k, s in shapes.items()} for i in range(n_steps)]
    return p0, grads


def _run_both(jax_opt, port_cls, port_kw, n_steps, seed=0):
    """Feed the same gradients to both optimizers; returns per-step
    (JAX params, port params, JAX state, port optimizer)."""
    p0, grads = _grad_sequence(n_steps, seed)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jax_opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = port_cls(list(tp.values()), **port_kw)
    steps = []
    for g in grads:
        upd, state = jax_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        steps.append(({k: np.asarray(v) for k, v in jp.items()},
                      {k: p.detach().numpy().copy() for k, p in tp.items()},
                      state))
    return steps, tp, opt


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_radam_30_step_trajectory_matches_jax(weight_decay):
    """Across the N_sma >= 5 threshold (step 6 in fp32, both sides):
    params and both moments after every step within 1e-4."""
    lr = 1e-2
    steps, tp, opt = _run_both(radam(lr, weight_decay=weight_decay), RAdam,
                               dict(lr=lr, weight_decay=weight_decay), 30)
    for i, (jp, ours, state) in enumerate(steps):
        for k in jp:
            np.testing.assert_allclose(ours[k], jp[k], atol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
    for k, p in tp.items():
        st = opt.state[p]
        assert st["step"] == int(state.count) == 30
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(state.exp_avg[k]), atol=1e-5)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(state.exp_avg_sq[k]),
                                   atol=1e-5)


def test_radam_threshold_step_matches_jax():
    """The first rectified step: the JAX update's size changes at step 6
    (fp32 N_sma crosses 5 there, not at step 5), and so does the port's."""
    steps, _, _ = _run_both(radam(1e-2), RAdam, dict(lr=1e-2), 7)
    for i in range(1, 7):
        jd = steps[i][0]["a"] - steps[i - 1][0]["a"]
        pd = steps[i][1]["a"] - steps[i - 1][1]["a"]
        np.testing.assert_allclose(pd, jd, atol=1e-6, err_msg=f"step {i}")


def test_adam_trajectory_matches_jax():
    """Adam with torch's L2 weight decay equals the JAX package's
    add_decayed_weights + scale_by_adam chain."""
    lr, wd = 1e-2, 1e-2
    jax_opt = jax_build_optimizer("Adam", lr, wd)
    p0, grads = _grad_sequence(10, seed=1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = jax_opt.init(jp)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    opt = build_optimizer(list(tp.values()), "Adam", lr, wd)
    for g in grads:
        upd, state = jax_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    for k in jp:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-5)
    with pytest.raises(ValueError, match="Unrecognized"):
        build_optimizer(list(tp.values()), "SGD", lr)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_optax(max_norm):
    """optax's formula, (g / ||g||) * c when ||g|| >= c, else g unchanged
    (not clip_grad_norm_'s c / (||g|| + 1e-6))."""
    _, grads = _grad_sequence(1, seed=2)
    g = grads[0]
    ref, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in g.items()}, None)
    ps = [torch.zeros(v.shape, requires_grad=True) for v in g.values()]
    for p, v in zip(ps, g.values()):
        p.grad = torch.tensor(v)
    norm = clip_by_global_norm(ps, max_norm)
    assert abs(float(norm) - float(optax.global_norm(
        [jnp.asarray(v) for v in g.values()]))) < 1e-5
    for p, k in zip(ps, g):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)


def test_one_train_step_matches_jax_with_frozen_layers():
    """Grads -> optax clip -> RAdam (weight decay 1e-6) through each
    package's make_train_step, finetune_layers set: every parameter
    within 1e-5 of JAX's after the step, the moments too, and every
    frozen parameter bitwise untouched."""
    params, cfg = perturbed_jax_params()
    np_params = jax.tree.map(np.asarray, params)  # the JAX step donates
    model, tcfg = port_model(np_params)
    batch = make_batch(seed=9)
    mesh = make_mesh((1,))
    opt = masked_optimizer(
        jax_build_optimizer("RAdam", TRAIN_CFG["learning_rate"],
                            TRAIN_CFG["weight_decay"],
                            TRAIN_CFG["grad_clip_val"]),
        trainable_mask(params, FINETUNE))
    opt_state = opt.init(params)
    step = jax_make_train_step(cfg, mesh, opt, TRAIN_CFG)
    shard = data_sharded(mesh)
    new_params, opt_state, metrics = step(
        params, opt_state, {k: jax.device_put(v, shard)
                            for k, v in batch.items()},
        None, jnp.asarray(0.01), jnp.asarray(1.0))
    ref = flowtron_state_dict_from_jax(jax.tree.map(np.asarray, new_params))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    named = trainable_parameters(model, FINETUNE)
    trainable = {n for n, _ in named}
    optimizer = build_optimizer([p for _, p in named], "RAdam",
                                TRAIN_CFG["learning_rate"],
                                TRAIN_CFG["weight_decay"])
    port_step = make_train_step(model, tcfg, optimizer,
                                [p for _, p in named], TRAIN_CFG)
    out = port_step(to_device(batch, torch.device("cpu")), None,
                    torch.tensor(0.01), torch.tensor(1.0))
    assert abs(float(out["loss"]) - float(metrics["loss"])) \
        <= 1e-5 * abs(float(metrics["loss"]))
    assert trainable and len(trainable) < len(before)
    for name, value in model.state_dict().items():
        if name in trainable:
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                       atol=1e-5, err_msg=name)
        else:
            assert torch.equal(value, before[name]), name
            assert torch.equal(ref[name], before[name]), name
    ours = radam_state_by_name(model, optimizer)
    # the JAX moments of the trainable leaves (inner state of the mask)
    inner = opt_state[0].inner_state
    masked = inner[1]._replace(**{key: jax.tree.map(
        lambda m, p: np.zeros_like(p) if isinstance(m, optax.MaskedNode)
        else np.asarray(m), getattr(inner[1], key), np_params,
        is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        for key in ("exp_avg", "exp_avg_sq")})
    jax_state = radam_state_from_jax(masked)
    assert ours["step"] == jax_state["step"] == 1
    for name in trainable:
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(ours[key][name].numpy(),
                                       jax_state[key][name].numpy(),
                                       atol=1e-6, err_msg=(key, name))


def test_convert_inverse_round_trip():
    params, _ = perturbed_jax_params(seed=3)
    np_params = jax.tree.map(np.asarray, params)
    back = flowtron_jax_from_state_dict(
        flowtron_state_dict_from_jax(np_params), params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)


def _tiny_model(seed=0, **kw):
    return flowtron_init(seed, **dict(DIMS, **kw))[0]


def test_checkpoint_round_trip_and_resume(tmp_path):
    model = _tiny_model()
    opt = RAdam(model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    path = str(tmp_path / "model_3.pt")
    save_checkpoint(path, model, opt, 3, 1e-3, {"train_config": {"x": [1]}})
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"model", "optimizer", "iteration",
                            "learning_rate", "config"}
    fresh = _tiny_model(seed=1)
    fresh_opt = RAdam(fresh.parameters(), lr=1e-3)
    assert load_checkpoint(path, fresh, fresh_opt) == 3
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    assert fresh_opt.state_dict()["state"][0]["step"] == 1
    # ignore_layers: those keep their fresh values, the optimizer stays
    fresh2 = _tiny_model(seed=2)
    opt2 = RAdam(fresh2.parameters(), lr=1e-3)
    kept = fresh2.embedding.weight.clone()
    load_checkpoint(path, fresh2, opt2, ignore_layers=["embedding.weight"])
    assert torch.equal(fresh2.embedding.weight, kept)
    assert torch.equal(fresh2.encoder.lstm.weight_hh_l0,
                       model.encoder.lstm.weight_hh_l0)
    assert not opt2.state


def test_warmstart_filters_by_include_layers(tmp_path):
    src = _tiny_model(seed=4, n_speakers=3)
    path = str(tmp_path / "src.pt")
    torch.save({"state_dict": src.state_dict()}, path)
    dst = _tiny_model(seed=5)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    loaded = warmstart(path, dst, ["speaker", "encoder", "embedding"])
    # the speaker table (3 vs 2 speakers) is dropped, as the reference does
    assert "speaker_embedding.weight" not in loaded
    assert "embedding.weight" in loaded
    assert all(k.startswith(("encoder", "embedding")) for k in loaded)
    for k, v in dst.state_dict().items():
        expect = src.state_dict()[k] if k in loaded else before[k]
        assert torch.equal(v, expect), k
    bad = _tiny_model(seed=6, n_text_dim=8)
    with pytest.raises(ValueError, match="shape"):
        warmstart(path, bad, ["encoder"])
    # a file that is not .pt is read as a JAX pickle
    # (tests/test_torch_port_jax_pickle.py); a directory without the
    # marker of any checkpoint format is refused by name
    # (tests/test_torch_port_dist_ckpt.py loads the formats)
    with pytest.raises(ValueError, match="not a checkpoint directory"):
        warmstart(str(tmp_path), dst)


def test_trainable_parameters_freeze_the_rest():
    model = _tiny_model()
    named = trainable_parameters(model, FINETUNE)
    names = {n for n, _ in named}
    assert names and all(n.startswith(("flows.0", "encoder"))
                         for n in names)
    for n, p in model.named_parameters():
        assert p.requires_grad == (n in names)
    assert len(trainable_parameters(model)) == len(list(model.parameters()))


@pytest.mark.parametrize("iteration", [0, 5, 10, 15, 20, 30])
def test_prior_strength_schedule_matches_jax(iteration):
    for start, end in ((10, 20), (0, 0), (5, 25)):
        assert prior_strength_schedule(iteration, start, end) == \
            jax_schedule(iteration, start, end)


@pytest.mark.parametrize("dist,item", [
    ({"mesh_shape": [1, 2], "mesh_axis_names": ["data", "model"]},
     "holds 2 ranks, the run has 1"),
    ({"mesh_shape": [1, 4, 2], "mesh_axis_names": ["dcn", "data", "model"],
      "dcn_mesh_shape": [2, 1, 1]}, "holds 16 ranks, the run has 1"),
])
def test_train_refuses_unported_features(dist, item):
    """A `model` mesh axis trains (tensor parallelism,
    tests/test_torch_port_tp.py); the second case is
    configs/config_multislice.json's mesh. Nothing refuses it any more:
    one process stops only at the grid's check, before any work, because
    the grid holds more ranks than the run."""
    train_config = {"seed": 1, "learning_rate": 1e-3, "batch_size": 2,
                    "sigma": 1.0, "sharded_checkpoints": True}
    config = {"train_config": train_config, "data_config": {},
              "dist_config": dist, "model_config": DIMS}
    with pytest.raises(ValueError, match=item):
        train(config)
