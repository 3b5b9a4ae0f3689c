"""The port's inference slice end to end against the JAX package (text ids
-> flowtron_infer -> waveglow_infer_z at toy widths), its CLI, and the
process-level guarantees: the port never imports jax, chip_smoke.py
imports nothing of the JAX package, and it fails without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402
from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402
from flowtron_tpu.vocoder.waveglow import (  # noqa: E402
    waveglow_infer_z as jax_waveglow_infer_z,
)

from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_init, flowtron_infer,
)
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax, waveglow_from_jax,
)
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    waveglow_init, waveglow_infer_z,
)

ROOT = Path(__file__).resolve().parents[1]
DIMS = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)
TINY_WG = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
               n_early_size=2, n_layers=2, n_channels=16, kernel_size=3)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    params, cfg = jax_flowtron_init(jax.random.PRNGKey(0), n_flows=2,
                                    use_gate_layer=True, **DIMS)
    for f in params["flows"]:
        f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            f["conv"]["w"].shape).astype(np.float32))
    wg_params, wg_cfg = jax_waveglow_init(jax.random.PRNGKey(1), **TINY_WG)
    for wn in wg_params["wn"]:
        wn["end"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            wn["end"]["w"].shape).astype(np.float32))
    model, tcfg = flowtron_init(0, n_flows=2, use_gate_layer=True, **DIMS)
    model.load_state_dict(flowtron_state_dict_from_jax(
        jax.tree.map(np.asarray, params)), strict=True)
    wg, twg_cfg = waveglow_init(**TINY_WG)
    wg.load_state_dict(waveglow_from_jax(jax.tree.map(np.asarray, wg_params),
                                         wg_cfg), strict=True)
    return (params, cfg, wg_params, wg_cfg), (model, tcfg, wg, twg_cfg)


def _inputs():
    rng = np.random.default_rng(3)
    B, N = 2, 20
    residual = (rng.standard_normal((B, 8, N)) * 0.5).astype(np.float32)
    text = rng.integers(1, 185, (B, 7))
    return residual, np.asarray([0, 1]), text, np.asarray([7, 5])


@pytest.mark.parametrize("fused", [False, "early"])
@pytest.mark.parametrize("thresh", [1e6, 0.45])
def test_slice_mel_matches_jax(models, fused, thresh):
    (params, cfg, _, _), (model, tcfg, _, _) = models
    residual, sids, text, in_lens = _inputs()
    mel_j, _, nv_j = jax_flowtron_infer(
        params, cfg, jnp.asarray(residual), jnp.asarray(sids),
        jnp.asarray(text), gate_threshold=thresh,
        in_lens=jnp.asarray(in_lens), fused=fused)
    mel, _, nv = flowtron_infer(
        model, tcfg, _t(residual), _t(sids), _t(text), gate_threshold=thresh,
        in_lens=_t(in_lens), fused=fused)
    nv_j = np.asarray(nv_j)
    np.testing.assert_array_equal(nv.numpy(), nv_j)
    for b in range(len(nv_j)):    # with early exit, later frames differ
        n = int(nv_j[b])
        np.testing.assert_allclose(mel.numpy()[b, :, :n],
                                   np.asarray(mel_j)[b, :, :n], atol=1e-4)


def test_slice_audio_matches_jax(models):
    """text ids -> mel -> audio in each package from the same weights and
    latents: mel 1e-4, n_valid identical, audio 1e-4."""
    (params, cfg, wg_params, wg_cfg), (model, tcfg, wg, twg_cfg) = models
    residual, sids, text, in_lens = _inputs()
    B, N = residual.shape[0], residual.shape[2]
    rng = np.random.default_rng(4)
    Tg = N * 256 // 8
    z_main = rng.standard_normal((B, 6, Tg)).astype(np.float32)
    z_early = [rng.standard_normal((B, 2, Tg)).astype(np.float32)
               if f == 2 else None for f in range(4)]
    mel_j, _, nv_j = jax_flowtron_infer(
        params, cfg, jnp.asarray(residual), jnp.asarray(sids),
        jnp.asarray(text), gate_threshold=1e6, in_lens=jnp.asarray(in_lens))
    audio_j = jax_waveglow_infer_z(
        wg_params, wg_cfg, mel_j, jnp.asarray(z_main),
        [None if z is None else jnp.asarray(z) for z in z_early], impl="tc")
    mel, _, nv = flowtron_infer(
        model, tcfg, _t(residual), _t(sids), _t(text), gate_threshold=1e6,
        in_lens=_t(in_lens))
    audio = waveglow_infer_z(wg, twg_cfg, mel, _t(z_main),
                             [None if z is None else _t(z) for z in z_early])
    np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_j))
    np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=1e-4)
    np.testing.assert_allclose(audio.numpy(), np.asarray(audio_j), atol=1e-4)


def _run(code_or_args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    return subprocess.run([sys.executable] + code_or_args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def _jax_pickles(root):
    """A JAX package Flowtron checkpoint (its save_checkpoint, a masked
    RAdam state) at the subprocess's toy widths, pickled and as its
    sharded and orbax directories, and a WaveGlow pickle as its vocoder
    trainer writes one."""
    import pickle
    from flowtron_tpu.train.checkpoints import save_checkpoint, trainable_mask
    from flowtron_tpu.train.radam import build_optimizer, masked_optimizer
    params, _ = jax_flowtron_init(
        jax.random.PRNGKey(0), n_speaker_dim=4, n_text_dim=12,
        n_mel_channels=8, n_hidden=16, n_attn_channels=8)
    opt = masked_optimizer(build_optimizer("RAdam", 1e-3, 0.0, 1.0),
                           trainable_mask(params))
    for name, fmt in (("model_3", "pickle"), ("sharded_3", "sharded"),
                      ("orbax_3", "orbax")):
        save_checkpoint(str(root / name), params, opt.init(params), 3,
                        1e-3, None, fmt=fmt)
    wg, cfg = jax_waveglow_init(jax.random.PRNGKey(1), **TINY_WG)
    with open(root / "waveglow_0", "wb") as f:
        pickle.dump({"params": jax.tree.map(np.asarray, wg), "config": cfg},
                    f)


def test_port_never_imports_jax(tmp_path):
    """Import every module of the port, the training, streaming, mux,
    evaluation, tone-CER, Gaussian-mixture, style-transfer and native ones
    by name too, and run a tiny synthesis, a tiny training step (forward,
    losses, backward through K3's plain versions, RAdam), one
    Gaussian-mixture step with remat, one request and one stream through a
    w8a8 serving engine (K4's plain version), one stream through an
    engine's multistream mux, one request through a bf16 engine and one
    through a (2, 2) serving mesh (tensor-parallel flows), load a
    JAX package Flowtron checkpoint (params and optimizer) as a pickle, a
    sharded directory and an orbax directory (through ``tensorstore``,
    which may load) and a WaveGlow pickle, run a tiny style transfer and
    (with ``g++``) one native mel, in a fresh interpreter: neither jax, optax nor the JAX package (``flowtron_tpu``
    or ``flowtron_tpu.*``) may be in sys.modules. A subprocess, because
    this test process already imported them."""
    _jax_pickles(tmp_path)
    code = (
        "import importlib, pkgutil, sys\n"
        "import flowtron_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('train.loop', 'data.dataset', 'ops.attention', "
        "'cli', 'train.logger', 'audio.griffin_lim', 'vocoder.denoiser', "
        "'infer.streaming', 'serve.streaming', 'infer.multistream', "
        "'train.evaluate', 'data.tone_cer', 'models.gaussian_mixture', "
        "'parallel.mesh', 'parallel.launch', 'parallel.tensor_parallel', "
        "'entry', 'train.dist_ckpt', "
        "'train.sharded_ckpt', 'train.orbax_ckpt', "
        "'scripts.train_waveglow', 'infer.style_transfer', 'native', "
        "'scripts.style_transfer', 'utils.profiler'):\n"
        "    importlib.import_module('flowtron_tpu_torch.' + name)\n"
        "import torch\n"
        "from flowtron_tpu_torch.models.flowtron import flowtron_init, "
        "flowtron_infer\n"
        "from flowtron_tpu_torch.train.loop import make_train_step\n"
        "from flowtron_tpu_torch.train.radam import RAdam\n"
        "m, c = flowtron_init(0, n_speaker_dim=4, n_text_dim=12, "
        "n_mel_channels=8, n_hidden=16, n_attn_channels=8)\n"
        "flowtron_infer(m, c, torch.zeros(1, 8, 3), torch.zeros(1).long(), "
        "torch.ones(1, 4).long())\n"
        "opt = RAdam(m.parameters())\n"
        "step = make_train_step(m, c, opt, list(m.parameters()), "
        "{'sigma': 1.0, 'use_ctc_loss': True, 'grad_clip_val': 1.0})\n"
        "batch = {'mel': torch.randn(2, 8, 5), 'speaker_ids': "
        "torch.zeros(2).long(), 'text': torch.ones(2, 4).long(), "
        "'in_lens': torch.tensor([4, 3]), 'out_lens': torch.tensor([5, 4]),"
        " 'gate_target': torch.zeros(2, 5), 'attn_prior': "
        "torch.full((2, 5, 4), 0.25)}\n"
        "out = step(batch, torch.Generator().manual_seed(0), "
        "torch.tensor(0.01), torch.tensor(1.0))\n"
        "assert all(torch.isfinite(v) for v in out.values()), out\n"
        "mg, cg = flowtron_init(0, n_speaker_dim=4, n_text_dim=12, "
        "n_mel_channels=8, n_hidden=16, n_attn_channels=8, "
        "mel_encoder_n_hidden=8, n_components=3, mean_scale=1.0)\n"
        "step = make_train_step(mg, cg, RAdam(mg.parameters()), "
        "list(mg.parameters()), {'sigma': 1.0, 'use_ctc_loss': True, "
        "'grad_clip_val': 1.0, 'remat': True})\n"
        "out = step(batch, torch.Generator().manual_seed(0), "
        "torch.tensor(0.01), torch.tensor(1.0))\n"
        "assert all(torch.isfinite(v) for v in out.values()), out\n"
        "from flowtron_tpu_torch.config import load_config\n"
        "from flowtron_tpu_torch.serve import SynthesisEngine\n"
        "from flowtron_tpu_torch.vocoder.waveglow import waveglow_init\n"
        f"root = {str(tmp_path)!r}\n"
        "open(root + '/fl.txt', 'w').write('u.wav|hello|0\\n')\n"
        "dims = dict(n_speaker_dim=4, n_text_dim=12, n_mel_channels=80, "
        "n_hidden=128, n_attn_channels=8)\n"
        "torch.save(flowtron_init(0, **dims)[0].state_dict(), "
        "root + '/ft.pt')\n"
        "torch.save(waveglow_init(1)[0].state_dict(), root + '/wg.pt')\n"
        "cfg = load_config(overrides=['data_config.training_files=' + root "
        "+ '/fl.txt', 'data_config.cmudict_path=', "
        "'data_config.heteronyms_path='] + [f'model_config.{k}={v}' for "
        "k, v in dims.items()])\n"
        "eng = SynthesisEngine(cfg, root + '/ft.pt', root + '/wg.pt', "
        "n_frames=3, quantize='w8a8', device='cpu')\n"
        "wav, sr = eng.submit('Hello there.')\n"
        "pcm = [p for p in eng.stream('Hello there.')]\n"
        "eng.shutdown()\n"
        "eng = SynthesisEngine(cfg, root + '/ft.pt', root + '/wg.pt', "
        "n_frames=3, stream_mux=1, device='cpu')\n"
        "muxed = [p for p in eng.stream('Hello there.')]\n"
        "eng.shutdown()\n"
        "eng = SynthesisEngine(cfg, root + '/ft.pt', root + '/wg.pt', "
        "n_frames=3, bf16=True, device='cpu')\n"
        "wav16, _ = eng.submit('Hello there.')\n"
        "assert eng.wg.upsample.weight.dtype == torch.bfloat16\n"
        "eng.shutdown()\n"
        "eng = SynthesisEngine(cfg, root + '/ft.pt', root + '/wg.pt', "
        "n_frames=3, mesh_shape=(2, 2), devices=['cpu'] * 4, "
        "device='cpu')\n"
        "wav22, _ = eng.submit('Hello there.')\n"
        "eng.shutdown()\n"
        "assert len(wav22) in (256, 512, 768), len(wav22)\n"
        "assert len(wav16) in (256, 512, 768), len(wav16)\n"
        "assert sum(len(p) for p in muxed) in (256, 512, 768), muxed\n"
        "assert sr == 22050 and len(wav) in (256, 512, 768), len(wav)\n"
        "assert sum(len(p) for p in pcm) in (256, 512, 768), pcm\n"
        "from flowtron_tpu_torch.train.checkpoints import load_checkpoint\n"
        "from flowtron_tpu_torch.vocoder.waveglow import load_waveglow\n"
        "m, c = flowtron_init(0, n_speaker_dim=4, n_text_dim=12, "
        "n_mel_channels=8, n_hidden=16, n_attn_channels=8)\n"
        "for name in ('model_3', 'sharded_3', 'orbax_3'):\n"
        "    assert load_checkpoint(root + '/' + name, m, "
        "RAdam(m.parameters())) == 3\n"
        "assert 'tensorstore' in sys.modules\n"
        "from flowtron_tpu_torch.infer.style_transfer import "
        "style_transfer\n"
        "batch = {'mel': torch.randn(2, 8, 5).numpy(), 'speaker_ids': [0, 0],"
        " 'text': [[1, 2, 3], [4, 5, 0]], 'in_lens': [3, 2], "
        "'out_lens': [5, 3]}\n"
        "mel, n = style_transfer(m, c, batch, [1, 2], 0, n_frames=4, "
        "gate_threshold=1e6, device='cpu')\n"
        "assert mel.shape == (8, 4), mel.shape\n"
        "from flowtron_tpu_torch.ops import _build\n"
        "from flowtron_tpu_torch import native\n"
        "_build.set_build_dir(root + '/native_build')\n"
        "from flowtron_tpu_torch.audio.stft import MelSpectrogram\n"
        "import shutil\n"
        "if shutil.which('g++'):\n"
        "    ms = MelSpectrogram()\n"
        "    out = native.NativeMel(ms.window, ms.mel_basis)("
        "torch.zeros(600).numpy())\n"
        "    assert out.shape == (80, 3), out.shape\n"
        "assert load_waveglow(root + '/waveglow_0')[1]['n_channels'] == 16\n"
        "bad = [k for k in sys.modules if k in ('jax', 'optax', "
        "'flowtron_tpu') or k.startswith(('jax.', 'optax.', "
        "'flowtron_tpu.'))]\n"
        "print('JAX_MODULES', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "JAX_MODULES []" in r.stdout


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CPU fallback: where CUDA is absent, chip_smoke.py exits
    non-zero with a clear message, in the repo and alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py would run for real")
    r = _run([str(ROOT / "chip_smoke.py")])
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "cuda" in r.stderr.lower()
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    r = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """chip_smoke.py's own imports name neither jax nor flowtron_tpu."""
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    top = {n.split(".")[0] for n in names}
    assert "flowtron_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "optax", "flowtron_tpu"}


@pytest.mark.parametrize("fault", ["missing", "failed"])
def test_kernel_build_failure_names_the_command(tmp_path, monkeypatch,
                                                fault):
    """No nvcc, or an nvcc that fails: load_library raises and the message
    names the build command with its sm_90a target."""
    from flowtron_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fault == "missing":
        monkeypatch.setattr(_build.shutil, "which", lambda name: None)
        monkeypatch.setattr(_build, "NVCC_DEFAULT",
                            str(tmp_path / "no-nvcc"))
        expect = "nvcc not found"
    else:
        monkeypatch.setattr(_build, "_nvcc", lambda: "false")
        expect = "building wavenet.cu failed"
    with pytest.raises(RuntimeError, match=expect) as err:
        _build.load_library("wavenet")
    assert "arch=compute_90a,code=sm_90a" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


def _cli_wav(tmp_path, dims, flags, vocoder=True):
    """flowtron-torch-infer with ``flags`` on the CPU from reference-format
    .pt checkpoints (with a WaveGlow ``-w`` unless ``vocoder`` is False);
    returns the one wav's (rate, frames). Without ``--stream`` it also
    checks the mel/attention PNG beside it."""
    import wave
    from flowtron_tpu_torch.cli import inference_main

    model, _ = flowtron_init(0, **dims)
    torch.save({"state_dict": model.state_dict()}, tmp_path / "ft.pt")
    wg, _ = waveglow_init(seed=1)
    torch.save(wg.state_dict(), tmp_path / "wg.pt")
    overrides = [f"model_config.{k}={v}" for k, v in dims.items()]
    argv = ["-c", str(ROOT / "config.json"), "-p", *overrides,
            "-f", str(tmp_path / "ft.pt"), "-t", "Hello world.", "-n", "6",
            "-o", str(tmp_path / "out")]
    if vocoder:
        argv += ["-w", str(tmp_path / "wg.pt")]
    cwd = os.getcwd()
    os.chdir(ROOT)      # config.json's filelist and cmudict paths
    try:
        inference_main(argv + flags)
    finally:
        os.chdir(cwd)
    wavs = list((tmp_path / "out").glob("*.wav"))
    assert len(wavs) == 1
    pngs = list((tmp_path / "out").glob("*.png"))
    if "--stream" in flags:
        assert wavs[0].name.endswith("_stream.wav") and not pngs
    else:
        assert [p.stem for p in pngs] == [wavs[0].stem]
        assert pngs[0].read_bytes()[:4] == b"\x89PNG"
    with wave.open(str(wavs[0])) as w:
        return w.getframerate(), w.getnframes()


def test_cli_writes_wav(tmp_path, monkeypatch):
    """flowtron-torch-infer end to end on the CPU (FLOWTRON_PLATFORM=cpu):
    reference-format .pt checkpoints in, a wav out."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    dims = dict(DIMS, n_mel_channels=80)    # the published vocoder's input
    rate, frames = _cli_wav(tmp_path, dims, ["--fused"])
    assert rate == 22050 and frames % 256 == 0 and frames > 0


@pytest.mark.parametrize("flag", [["--quantize", "w8"], ["--quantize", "w8a8"],
                                  ["--quantize", "w4"], ["--int8"]])
def test_cli_quantized_modes_write_wav(tmp_path, monkeypatch, flag):
    """--quantize and its alias --int8 quantize the flows before synthesis
    (n_hidden 128, so the LSTM matrices reach the 65536-element floor)."""
    from flowtron_tpu_torch.infer import sampling
    from flowtron_tpu_torch.utils.weights import QuantizedWeight

    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    seen = []

    def spy(model, **kw):
        out = sampling_quantize(model, **kw)
        seen.append((kw["mode"], sum(isinstance(m, QuantizedWeight)
                                     for m in out.modules())))
        return out
    sampling_quantize = sampling.quantize_flows_for_inference
    monkeypatch.setattr(sampling, "quantize_flows_for_inference", spy)
    dims = dict(DIMS, n_mel_channels=80, n_hidden=128)
    rate, frames = _cli_wav(tmp_path, dims, flag)
    assert rate == 22050 and frames % 256 == 0 and frames > 0
    mode = flag[1] if len(flag) > 1 else "w8"
    assert len(seen) == 1 and seen[0][0] == mode and seen[0][1] > 0


def test_no_vocoder_runs_griffin_lim(tmp_path, monkeypatch):
    """Without -w the mel is vocoded by Griffin-Lim on the host: n_valid
    frames give (n_valid - 1) * 256 samples, one frame one hop of
    silence."""
    monkeypatch.setenv("FLOWTRON_PLATFORM", "cpu")
    rate, frames = _cli_wav(tmp_path, dict(DIMS, n_mel_channels=80), [],
                            vocoder=False)
    assert rate == 22050 and frames % 256 == 0 and 0 < frames <= 5 * 256
