"""WaveGlow training in the port against the JAX package at toy widths:
``waveglow_forward`` (z, log_s, log_det), ``waveglow_loss``, the
gradients against ``jax.grad``, one Adam step against ``optax.adam``, the
bf16 policy of the vocoder trainer, the trainer's first batch against the
JAX script's ``sample_batch``, and the routing: the training forward never
reaches kernel K2, and K2 refuses autograd on the card. Same weights
through ``waveglow_from_jax``, the zero-init end convs perturbed, inputs
drawn with numpy."""

import json
import sys

import numpy as np
import optax
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402
from flowtron_tpu.vocoder.waveglow import (  # noqa: E402
    waveglow_forward as jax_waveglow_forward,
    waveglow_loss as jax_waveglow_loss,
)

from flowtron_tpu_torch.data.synth import make_aligned_corpus  # noqa: E402
from flowtron_tpu_torch.ops.wavenet import wn_layer  # noqa: E402
from flowtron_tpu_torch.scripts import train_waveglow  # noqa: E402
from flowtron_tpu_torch.utils.convert import waveglow_from_jax  # noqa: E402
from flowtron_tpu_torch.vocoder import waveglow as wgm  # noqa: E402
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    load_waveglow, waveglow_forward, waveglow_init, waveglow_loss,
)

from tests.probe_scripts import ROOT, load_script  # noqa: E402

WG = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
          n_early_size=2, n_layers=2, n_channels=32, kernel_size=3)
B, T_AUDIO = 2, 2048                  # 8 mel frames, Tg = 256
SIGMA = 1.0


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
    """JAX params with the end convs perturbed and the 1x1 convs moved
    off the orthogonal init (there log|det W| is 0 up to rounding, which
    B * Tg = 512 magnifies), the port's model holding them, and a numpy
    batch."""
    params, cfg = jax_waveglow_init(jax.random.PRNGKey(0), **WG)
    rng = np.random.default_rng(1)
    for wn, inv in zip(params["wn"], params["convinv"]):
        for k in ("w", "b"):
            wn["end"][k] = jnp.asarray(0.05 * rng.standard_normal(
                wn["end"][k].shape).astype(np.float32))
        inv["w"] = inv["w"] + jnp.asarray(0.2 * rng.standard_normal(
            inv["w"].shape).astype(np.float32))
    np_params = jax.tree.map(np.asarray, params)
    model, tcfg = waveglow_init(**WG)
    model.load_state_dict(waveglow_from_jax(np_params, cfg), strict=True)
    spect = rng.standard_normal((B, 8, T_AUDIO // 256)).astype(np.float32)
    audio = (0.3 * rng.standard_normal((B, T_AUDIO))).astype(np.float32)
    return params, cfg, model, tcfg, spect, audio


@pytest.fixture(scope="module")
def jax_ref(pair):
    """JAX's loss, (z, log_s, log_det) and gradients, one jitted call."""
    params, cfg, _, _, spect, audio = pair

    def loss_fn(p):
        z, ls, ld = jax_waveglow_forward(p, cfg, jnp.asarray(spect),
                                         jnp.asarray(audio))
        return jax_waveglow_loss(z, ls, ld, SIGMA), (z, ls, ld)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)


def test_forward_and_loss_match_jax(pair, jax_ref):
    params, cfg, model, tcfg, spect, audio = pair
    (loss_j, (z_j, ls_j, ld_j)), _ = jax_ref
    with torch.no_grad():
        z, ls, ld = waveglow_forward(model, tcfg, _t(spect), _t(audio))
        loss = waveglow_loss(z, ls, ld, SIGMA)
    assert z.shape == (B, 8, T_AUDIO // 8) and len(ls) == len(ld) == 4
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=1e-5)
    for a, r in zip(ls, ls_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5)
    for a, r in zip(ld, ld_j):
        assert a.dtype == torch.float32 and abs(float(r)) > 1.0
        assert abs(float(a) - float(r)) <= 1e-5 * abs(float(r))
    loss_j = float(loss_j)
    assert abs(float(loss) - loss_j) <= 1e-5 * max(1.0, abs(loss_j))


def test_gradients_and_one_adam_step_match_jax(pair, jax_ref):
    """Gradients within 1e-4 of each tensor's largest value; then one
    step of the trainer's Adam and of optax.adam, fed the same gradients,
    within 1e-5."""
    params, cfg, model, tcfg, spect, audio = pair
    _, grads_j = jax_ref
    ref = waveglow_from_jax(jax.tree.map(np.asarray, grads_j), cfg)
    model = waveglow_init(**WG)[0]
    model.load_state_dict(waveglow_from_jax(
        jax.tree.map(np.asarray, params), cfg), strict=True)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3,
                                 betas=(0.9, 0.999), eps=1e-8)
    loss = train_waveglow.waveglow_train_loss(model, tcfg, _t(spect),
                                              _t(audio), SIGMA, None)
    loss.backward()
    for name, p in model.named_parameters():
        r = ref[name]
        scale = max(float(r.abs().max()), 1e-30)
        assert float((p.grad - r).abs().max()) <= 1e-4 * scale, name
        p.grad = r.clone()
    optimizer.step()
    opt = optax.adam(1e-3)

    @jax.jit
    def adam_step(p, g):
        return optax.apply_updates(p, opt.update(g, opt.init(p), p)[0])

    stepped = waveglow_from_jax(jax.tree.map(
        np.asarray, adam_step(params, grads_j)), cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   stepped[name].numpy(), atol=1e-5,
                                   err_msg=name)


def test_bf16_policy_matches_jax_bf16(pair):
    """The trainer's fp16_run policy: each output in JAX's dtype, the fp32
    loss within 1e-3 relative of JAX's bf16 loss, gradients on the fp32
    masters."""
    params, cfg, model, tcfg, spect, audio = pair
    bf16 = jnp.bfloat16

    @jax.jit
    def policy(p):       # scripts/train_waveglow.py's loss_fn
        pc = jax.tree.map(lambda x: x.astype(bf16), p)
        z, ls, ld = jax_waveglow_forward(
            pc, cfg, jnp.asarray(spect).astype(bf16),
            jnp.asarray(audio).astype(bf16))
        return (z, ls, ld), jax_waveglow_loss(
            z.astype(jnp.float32), [x.astype(jnp.float32) for x in ls],
            [x.astype(jnp.float32) for x in ld], SIGMA)

    (z_j, ls_j, ld_j), loss_j = policy(params)
    loss_j = float(loss_j)
    z, ls, ld = waveglow_forward(model, tcfg, _t(spect), _t(audio),
                                 compute_dtype=torch.bfloat16)
    names = {jnp.dtype(bf16): torch.bfloat16,
             jnp.dtype(jnp.float32): torch.float32}
    assert z.dtype == names[z_j.dtype]
    assert [x.dtype for x in ls] == [names[x.dtype] for x in ls_j]
    assert [x.dtype for x in ld] == [names[jnp.asarray(x).dtype]
                                     for x in ld_j]
    model.zero_grad(set_to_none=True)
    loss = train_waveglow.waveglow_train_loss(
        model, tcfg, _t(spect), _t(audio), SIGMA, torch.bfloat16)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - loss_j) <= 1e-3 * abs(loss_j)
    loss.backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())
    model.zero_grad(set_to_none=True)


def test_training_forward_never_reaches_k2(pair, monkeypatch):
    """The coupling's WN runs channel-major in training: a spy in place of
    wn_layer is never called by a forward and backward."""
    _, _, model, tcfg, spect, audio = pair
    calls = []
    monkeypatch.setattr(wgm, "wn_layer",
                        lambda *a, **k: calls.append(1) or wn_layer(*a, **k))
    loss = train_waveglow.waveglow_train_loss(model, tcfg, _t(spect),
                                              _t(audio), SIGMA, None)
    loss.backward()
    model.zero_grad(set_to_none=True)
    assert not calls
    with torch.no_grad():    # the inverse pass does go through it
        wgm.waveglow_infer(model, tcfg, _t(spect[:1, :, :2]), sigma=0.5)
    assert len(calls) == WG["n_flows"] * WG["n_layers"]


class _Stop(Exception):
    pass


def _config(tmp_path, files_fl, out_dir):
    with open(ROOT / "configs" / "config_waveglow.json") as f:
        config = json.load(f)
    tc, dc = config["train_config"], config["data_config"]
    dc.update(training_files=str(files_fl), segment_length=3000)
    tc.update(batch_size=1, output_directory=str(out_dir), epochs=1,
              iters_per_checkpoint=2, fp16_run=False)
    config["waveglow_config"].update(WG, n_mel_channels=80)
    path = tmp_path / "config_waveglow.json"
    path.write_text(json.dumps(config))
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six coded-tone utterances and one wav shorter than a segment."""
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp("wg_corpus")
    train_fl, _ = make_aligned_corpus(str(root), n_utterances=6, seed=3)
    short = root / "short.wav"
    wavfile.write(str(short), 22050, (np.sin(np.arange(1000) / 7.0)
                                      * 9000).astype(np.int16))
    with open(train_fl, "a") as f:
        f.write(f"{short}|ab|0\n")
    return root, train_fl


def test_first_batch_matches_the_jax_script(corpus, tmp_path, monkeypatch):
    """The trainer's first batch, files, segments and mel, equals the one
    the JAX script's sample_batch draws at the same seed (the JAX script
    runs unchanged; its jitted step is replaced by a recorder that stops
    it). The JAX script's batch is per-device times the device count, the
    8 virtual CPU devices of these tests, so the port takes batch 8."""
    import flowtron_tpu.data as jax_data
    root, train_fl = corpus
    cfg_path = _config(tmp_path, train_fl, tmp_path / "out")
    seen = {"jax": [], "port": []}
    batches = {}

    def spy(tag, load):
        def read(path):
            seen[tag].append(path)
            return load(path)
        return read

    def jit(fn, **kwargs):
        def step(params, opt_state, mel, audio):
            batches["jax"] = (np.asarray(mel), np.asarray(audio))
            raise _Stop
        return step

    mod = load_script("train_waveglow")
    monkeypatch.setattr(jax_data, "load_wav", spy("jax", jax_data.load_wav))
    monkeypatch.setattr(jax, "jit", jit)
    monkeypatch.setattr(sys, "argv", ["train_waveglow.py", "-c",
                                      str(cfg_path)])
    with pytest.raises(_Stop):
        mod.main()
    monkeypatch.undo()

    def make_step(*args, **kwargs):
        def step(mel, audio):
            batches["port"] = (mel.numpy(), audio.numpy())
            raise _Stop
        return step

    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    monkeypatch.setattr(train_waveglow, "make_step", make_step)
    monkeypatch.setattr(train_waveglow, "load_wav",
                        spy("port", train_waveglow.load_wav))
    with pytest.raises(_Stop):
        train_waveglow.main(["-c", str(cfg_path), "-p",
                             "train_config.batch_size=8"])
    assert len(seen["jax"]) == 8 and seen["port"] == seen["jax"]
    assert str(root / "short.wav") in seen["jax"]      # a padded row
    (mel_j, audio_j), (mel, audio) = batches["jax"], batches["port"]
    assert audio.shape == (8, 2816) and mel.shape == (8, 80, 11)
    np.testing.assert_array_equal(audio, audio_j)
    np.testing.assert_array_equal(mel, mel_j)


def test_trainer_writes_checkpoints_that_load_at_their_width(corpus,
                                                             tmp_path,
                                                             monkeypatch):
    """Two steps at 64 channels on the CPU (fp32: the bf16 policy is held
    to JAX above, and bf16 convolutions are slow on a CPU): finite losses,
    and waveglow_0.pt (a checkpoint from iteration 0 on, as JAX) holding
    the published names and the config, read by
    torch.load(weights_only=True) and by load_waveglow at 64 channels,
    the model of its first step."""
    _, train_fl = corpus
    cfg_path = _config(tmp_path, train_fl, tmp_path / "out")
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    model, wg_cfg, history = train_waveglow.main(
        ["-c", str(cfg_path), "-p", "train_config.batch_size=3",
         "train_config.iters_per_checkpoint=5",
         "waveglow_config.n_channels=64"])
    assert [h["iteration"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert wg_cfg["n_channels"] == 64
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        ["waveglow_0.pt"]
    payload = torch.load(tmp_path / "out" / "waveglow_0.pt",
                         weights_only=True)
    assert set(payload) == {"model", "config"}
    assert payload["config"] == wg_cfg
    assert "WN.0.cond_layer.weight" in payload["model"]
    loaded, cfg = load_waveglow(str(tmp_path / "out" / "waveglow_0.pt"))
    assert cfg == wg_cfg and loaded.WN[0].n_channels == 64
    assert not torch.equal(loaded.WN[0].start.weight,
                           model.WN[0].start.weight)   # a step later
    assert loaded.WN[0].start.weight.shape == (64, 4, 1)


@pytest.mark.cuda
def test_wn_layer_refuses_autograd_on_card():
    """K2 has no backward: with grad mode on and an input that requires
    grad it raises instead of returning outputs cut from the graph; under
    no_grad it runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    dev = torch.device("cuda")
    C, Tp = 64, 128
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(1, Tp, C, generator=g), 2,
            torch.randn(1, Tp, 2 * C, generator=g),
            0.1 * torch.randn(3 * C, 2 * C, generator=g),
            torch.randn(2 * C, generator=g),
            0.1 * torch.randn(C, 2 * C, generator=g),
            torch.randn(2 * C, generator=g), Tp]
    args = [a.to(dev) if torch.is_tensor(a) else a for a in args]
    w = args[3].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        wn_layer(*args[:3], w, *args[4:])
    with torch.no_grad():
        x_new, skip = wn_layer(*args[:3], w, *args[4:])
    assert x_new.shape == (1, Tp, C) and not skip.requires_grad
