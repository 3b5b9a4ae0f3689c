"""The JAX package's pickle checkpoints read by the port
(``utils/jax_pickle.py``, ``train/checkpoints.py``,
``infer/sampling.py:load_model_for_inference``,
``vocoder/waveglow.py:load_waveglow``): files written by the JAX
package's own ``save_checkpoint`` (RAdam and Adam, each with a grad clip
and ``finetune_layers``, so the optimizer state is the masked chain) and
by its vocoder trainer's ``{"params", "config"}`` format. Params and
moments load exactly; a resumed step agrees with JAX's; ``ignore_layers``
and ``include_layers`` pick JAX's keys; the CLI's mel and the vocoders'
audio agree with JAX's on the same latents; a foreign global is refused
before it runs; and the JAX package reads the port's WaveGlow ``.pt``."""

import os
import pickle
from collections import namedtuple

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402
from flowtron_tpu.train.checkpoints import (  # noqa: E402
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint, trainable_mask,
    warmstart as jax_warmstart,
)
from flowtron_tpu.train.radam import (  # noqa: E402
    build_optimizer as jax_build_optimizer, masked_optimizer,
)
from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402
from flowtron_tpu.vocoder.waveglow import (  # noqa: E402
    load_waveglow as jax_load_waveglow,
    waveglow_infer_z as jax_waveglow_infer_z,
)

from flowtron_tpu_torch.cli import inference_main  # noqa: E402
from flowtron_tpu_torch.infer import sampling  # noqa: E402
from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.train.checkpoints import (  # noqa: E402
    load_checkpoint, warmstart,
)
from flowtron_tpu_torch.train.radam import (  # noqa: E402
    build_optimizer, clip_by_global_norm, trainable_parameters,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_jax_from_state_dict, flowtron_state_dict_from_jax,
    radam_state_by_name, radam_state_from_jax,
)
from flowtron_tpu_torch.utils.jax_pickle import load_jax_pickle  # noqa: E402
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    load_waveglow, waveglow_infer_z, waveglow_init,
)

from tests.test_torch_port_train import DIMS, perturbed_jax_params  # noqa: E402
from tests.test_torch_port_slice import ROOT  # noqa: E402

LR, WD, CLIP = 5e-3, 1e-6, 1.0
FINETUNE = ["flows.1", "speaker_embedding"]   # the same leaves in both
SAVED_AT = 6        # RAdam rectifies from count 6: its v is in the step
Moments = namedtuple("Moments", "count exp_avg exp_avg_sq")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32)), params)


def _jax_moments(opt_state, algo):
    """The RAdam / Adam state inside JAX's masked chain, as Moments."""
    inner = opt_state[0].inner_state[1]           # (clip, the optimizer)
    return Moments(*(inner if algo == "RAdam" else inner[1]))


def _port_model(seed, **kw):
    return flowtron_init(seed, n_flows=2, use_gate_layer=True,
                         **dict(DIMS, **kw))[0]


@pytest.fixture(scope="module", params=["RAdam", "Adam"])
def saved(request, tmp_path_factory):
    """SAVED_AT masked updates of JAX's optimizer from seeded gradients,
    then the JAX package's save_checkpoint; returns what the resumed step
    needs."""
    algo = request.param
    params, _ = perturbed_jax_params()
    opt = masked_optimizer(jax_build_optimizer(algo, LR, WD, CLIP),
                           trainable_mask(params, FINETUNE))

    @jax.jit
    def update(g, state, p):
        u, state = opt.update(g, state, p)
        return optax.apply_updates(p, u), state

    state = opt.init(params)
    for i in range(SAVED_AT):
        params, state = update(_grads(params, i), state, params)
    path = str(tmp_path_factory.mktemp(algo) / f"model_{SAVED_AT}")
    jax_save_checkpoint(path, params, state, SAVED_AT, LR,
                        {"train_config": {"optim_algo": algo}})
    return dict(algo=algo, path=path, params=params, state=state,
                update=update)


def test_params_moments_and_iteration_load_exactly(saved):
    model = _port_model(seed=5)
    named = trainable_parameters(model, FINETUNE)
    optimizer = build_optimizer([p for _, p in named], saved["algo"], LR, WD)
    assert load_checkpoint(saved["path"], model, optimizer) == SAVED_AT
    ref = flowtron_state_dict_from_jax(_np(saved["params"]))
    assert set(ref) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(value, ref[name]), name
    ours = radam_state_by_name(model, optimizer)
    theirs = radam_state_from_jax(_np(_jax_moments(saved["state"],
                                                   saved["algo"])))
    assert ours["step"] == theirs["step"] == SAVED_AT
    assert set(ours["exp_avg"]) == set(theirs["exp_avg"]) == \
        {n for n, _ in named}
    for key in ("exp_avg", "exp_avg_sq"):
        for name, value in ours[key].items():
            assert torch.equal(value, theirs[key][name]), (key, name)


def test_resumed_step_matches_jax(saved):
    """One more step from the loaded state with the same gradients (the
    port clips in the loop, JAX in the chain): every trainable parameter
    within 1e-5 of JAX's, every frozen one untouched."""
    model = _port_model(seed=5)
    named = trainable_parameters(model, FINETUNE)
    params_t = [p for _, p in named]
    optimizer = build_optimizer(params_t, saved["algo"], LR, WD)
    load_checkpoint(saved["path"], model, optimizer)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    g = _grads(saved["params"], 99)
    ref = flowtron_state_dict_from_jax(_np(saved["update"](
        g, saved["state"], saved["params"])[0]))
    g_t = flowtron_state_dict_from_jax(_np(g))
    for name, p in named:
        p.grad = g_t[name].clone()
    clip_by_global_norm(params_t, CLIP)
    optimizer.step()
    trainable = {n for n, _ in named}
    for name, value in model.state_dict().items():
        if name in trainable:
            np.testing.assert_allclose(value.numpy(), ref[name].numpy(),
                                       atol=1e-5, err_msg=name)
        else:
            assert torch.equal(value, before[name]), name


def test_ignore_layers_keep_fresh_values_as_jax(saved):
    """ignore_layers names JAX's flat keys, exactly; those keep the fresh
    model's values and the optimizer starts fresh, as in JAX's
    load_checkpoint."""
    keys = ["embedding.table", "flows.0.conv.w", "flows.1.lstm"]
    model = _port_model(seed=7)
    fresh = flowtron_jax_from_state_dict(model.state_dict(),
                                         _np(saved["params"]))
    ref, _, it, _ = jax_load_checkpoint(saved["path"],
                                        jax.tree.map(jnp.asarray, fresh),
                                        None, ignore_layers=keys)
    optimizer = build_optimizer(list(model.parameters()), saved["algo"], LR)
    assert load_checkpoint(saved["path"], model, optimizer,
                           ignore_layers=keys) == it == SAVED_AT
    assert not optimizer.state
    ref = flowtron_state_dict_from_jax(_np(ref))
    kept = {"embedding.weight", "flows.0.conv.weight"}
    saved_sd = flowtron_state_dict_from_jax(_np(saved["params"]))
    for name, value in model.state_dict().items():
        assert torch.equal(value, ref[name]), name
        # "flows.1.lstm" is no exact key: nothing under it stays fresh
        assert torch.equal(value, saved_sd[name]) == (name not in kept), name


@pytest.mark.parametrize("include", [None, ["embedding", "flows.0"]])
def test_warmstart_picks_jax_keys_and_keeps_mismatched_shapes(tmp_path,
                                                              include):
    """JAX's pickle branch of warmstart: include_layers substrings match
    JAX's flat keys and any key whose shape differs (here the speaker and
    text tables) keeps its fresh value, where the .pt branch would raise."""
    from flowtron_tpu.models import flowtron_init as jax_init
    like, _ = perturbed_jax_params(seed=2)
    other, _ = jax_init(jax.random.PRNGKey(4), n_flows=2, use_gate_layer=True,
                        **dict(DIMS, n_speakers=3, n_text=150))
    path = str(tmp_path / "model_2")
    jax_save_checkpoint(path, other, None, 2, LR, None)
    model = _port_model(seed=9)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    fresh = flowtron_jax_from_state_dict(before, _np(like))
    ref = flowtron_state_dict_from_jax(_np(jax_warmstart(
        path, jax.tree.map(jnp.asarray, fresh), include)))
    src = flowtron_state_dict_from_jax(_np(other))
    loaded = warmstart(path, model, include)
    for name, value in model.state_dict().items():
        assert torch.equal(value, ref[name]), name
        assert torch.equal(value, src[name] if name in loaded
                           else before[name]), name
    for name in ("speaker_embedding.weight", "embedding.weight"):
        assert name not in loaded and torch.equal(
            model.state_dict()[name], before[name])
    assert any(n.startswith("flows.0.") for n in loaded)
    if include:
        assert not any(n.startswith(("flows.1", "encoder"))
                       for n in loaded)


def _wg_pickle(path, seed, **kw):
    """A JAX WaveGlow with its end convs perturbed, pickled as the JAX
    vocoder trainer writes it."""
    params, cfg = jax_waveglow_init(jax.random.PRNGKey(seed), **kw)
    rng = np.random.default_rng(seed)
    for wn in params["wn"]:
        wn["end"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            wn["end"]["w"].shape).astype(np.float32))
    with open(path, "wb") as f:
        pickle.dump({"params": _np(params), "config": cfg}, f)
    return params, cfg


def _latents(cfg, B, T_mel, seed):
    rng = np.random.default_rng(seed)
    Tg = T_mel * 256 // cfg["n_group"]
    spect = rng.standard_normal((B, cfg["n_mel_channels"], T_mel)) \
        .astype(np.float32)
    n_rem = cfg["n_group"] - cfg["n_early_size"] * (
        (cfg["n_flows"] - 1) // cfg["n_early_every"])
    z_main = rng.standard_normal((B, n_rem, Tg)).astype(np.float32)
    z_early = [rng.standard_normal((B, cfg["n_early_size"], Tg))
               .astype(np.float32)
               if f % cfg["n_early_every"] == 0 and f > 0 else None
               for f in range(cfg["n_flows"])]
    return spect, z_main, z_early


def _port_audio(model, cfg, spect, z_main, z_early):
    with torch.no_grad():
        return waveglow_infer_z(
            model, cfg, torch.from_numpy(spect), torch.from_numpy(z_main),
            [None if z is None else torch.from_numpy(z) for z in z_early]
        ).numpy()


def _jax_audio(params, cfg, spect, z_main, z_early):
    return np.asarray(jax.jit(lambda p, s, zm, ze: jax_waveglow_infer_z(
        p, cfg, s, zm, ze))(params, spect, z_main, z_early))


@pytest.mark.parametrize("n_channels", [64, 512])
def test_waveglow_pickle_of_any_width(tmp_path, n_channels):
    """load_waveglow builds the pickle's own width and gives JAX's audio
    within 1e-4 on the same latents."""
    kw = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
              n_early_size=2, n_layers=2, n_channels=n_channels)
    path = str(tmp_path / "waveglow_0")
    params, cfg = _wg_pickle(path, 3, **kw)
    model, tcfg = load_waveglow(path)
    assert tcfg == cfg and model.WN[0].n_channels == n_channels
    lat = _latents(cfg, 2, 3, 4)
    np.testing.assert_allclose(_port_audio(model, tcfg, *lat),
                               _jax_audio(params, cfg, *lat), atol=1e-4)


def test_port_waveglow_pt_reads_in_the_jax_package(tmp_path):
    """A 256-channel .pt in the port trainer's format ({"model", "config"})
    read by JAX's load_waveglow gives the port's audio within 1e-4."""
    model, cfg = waveglow_init(seed=6)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for wn in model.WN:
            wn.end.weight.normal_(0.0, 0.05, generator=g)
    path = str(tmp_path / "waveglow_0.pt")
    torch.save({"model": model.state_dict(), "config": cfg}, path)
    params, jcfg = jax_load_waveglow(path)
    assert jcfg == cfg
    lat = _latents(cfg, 1, 2, 5)
    np.testing.assert_allclose(_port_audio(load_waveglow(path)[0], cfg, *lat),
                               _jax_audio(params, jcfg, *lat), atol=1e-4)


class _Boom:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


def test_foreign_global_is_refused_before_it_runs(tmp_path):
    marker = tmp_path / "ran"
    for name in ("model_1", "waveglow_1"):
        path = tmp_path / name
        with open(path, "wb") as f:
            pickle.dump({"params": _Boom(marker), "config": {}}, f)
        with pytest.raises(pickle.UnpicklingError, match="system"):
            load_jax_pickle(str(path))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        load_checkpoint(str(tmp_path / "model_1"), _port_model(0))
    with pytest.raises(pickle.UnpicklingError, match="system"):
        load_waveglow(str(tmp_path / "waveglow_1"))
    assert not marker.exists()


def test_directory_formats_name_their_item(tmp_path):
    """The directory formats load (tests/test_torch_port_dist_ckpt.py); a
    directory without any format's marker is refused, naming them."""
    with pytest.raises(ValueError, match="index.json.*meta.json"):
        load_checkpoint(str(tmp_path), _port_model(0))
    with pytest.raises(ValueError, match="not a checkpoint directory"):
        warmstart(str(tmp_path), _port_model(0))


def test_cli_synthesizes_from_jax_pickles(tmp_path, monkeypatch):
    """flowtron-torch-infer with -f a JAX model_N pickle and -w a JAX
    waveglow pickle: its mel within 1e-4 of JAX's flowtron_infer on the
    latents the CLI drew, and a wav written."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    dims = dict(DIMS, n_mel_channels=80)
    from flowtron_tpu.models import flowtron_init as jax_init
    params, jcfg = jax_init(jax.random.PRNGKey(8), n_flows=2,
                            use_gate_layer=True, **dims)
    rng = np.random.default_rng(8)
    for f in params["flows"]:
        f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            f["conv"]["w"].shape).astype(np.float32))
    ft = str(tmp_path / "model_3")
    jax_save_checkpoint(ft, params, None, 3, LR, None)
    wg = str(tmp_path / "waveglow_0")
    _wg_pickle(wg, 9, n_mel_channels=80, n_flows=2, n_layers=2,
               n_channels=64)
    seen = []

    def spy(model, cfg, residual, sid, text, **kw):
        out = infer(model, cfg, residual, sid, text, **kw)
        seen.append((residual.numpy(), sid.numpy(), text.numpy(), kw,
                     out[0].numpy()))
        return out
    infer = sampling.flowtron_infer
    monkeypatch.setattr(sampling, "flowtron_infer", spy)
    monkeypatch.chdir(ROOT)     # config.json's filelist and cmudict paths
    inference_main(["-c", "config.json", "-p",
                    *[f"model_config.{k}={v}" for k, v in dims.items()],
                    "-f", ft, "-w", wg, "-t", "Hello world.", "-n", "6",
                    "-g", "1e6", "-o", str(tmp_path / "out")])
    assert len(seen) == 1 and list((tmp_path / "out").glob("*.wav"))
    residual, sid, text, kw, mel = seen[0]
    mel_j = jax_flowtron_infer(params, jcfg, jnp.asarray(residual),
                               jnp.asarray(sid), jnp.asarray(text),
                               gate_threshold=kw["gate_threshold"])[0]
    np.testing.assert_allclose(mel, np.asarray(mel_j), atol=1e-4)
