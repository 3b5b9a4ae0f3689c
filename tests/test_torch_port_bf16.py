"""bf16 serving (the JAX server's ``--bf16``) in the port against the
unchanged JAX package, on the CPU: the bf16 bodies' plain versions of K4
(ops/qmm.py), K2 (ops/wavenet.py) and K1 (ops/decoder.py) against the
Pallas kernels in interpret mode on bf16 inputs, the bf16 loop against
JAX's bf16 scan, and the slice: a bf16 ``SynthesisEngine`` with a vocoder,
alone and with w8 and w4 quantization, against the JAX engine built the
same way (tests/test_serve.py's bf16 case on both sides). Inputs come from
numpy seeds at toy widths; each test states its tolerance and prints the
deviation it measured."""

import pickle

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from scipy.io import wavfile  # noqa: E402

import flowtron_tpu.ops.qmm_pallas as jax_qmm  # noqa: E402
from flowtron_tpu.config import load_config as jax_load_config  # noqa: E402
from flowtron_tpu.models.ar_step import (  # noqa: E402
    ar_step_infer as jax_ar_step_infer, ar_step_params,
)
from flowtron_tpu.ops.wavenet_pallas import wn_layer_fused  # noqa: E402
from flowtron_tpu.serve import SynthesisEngine as JaxEngine  # noqa: E402
from flowtron_tpu.vocoder.waveglow import (  # noqa: E402
    _shift_t, waveglow_infer_z as jax_waveglow_infer_z,
)

from flowtron_tpu_torch.models.ar_step import ARStep, ar_step_infer  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_infer, flowtron_init,
)
from flowtron_tpu_torch.ops.decoder import (  # noqa: E402
    pack_flow_weights,
)
from flowtron_tpu_torch.ops.qmm import quantized_matmul_reference  # noqa: E402
from flowtron_tpu_torch.ops.wavenet import wn_layer_reference  # noqa: E402
from flowtron_tpu_torch.serve import SynthesisEngine  # noqa: E402
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax, waveglow_from_jax,
)
from flowtron_tpu_torch.utils.weights import (  # noqa: E402
    QuantizedWeight, to_bf16,
)
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    waveglow_infer_z, waveglow_init, waveglow_n_remaining,
)

BF16 = torch.bfloat16


def _t(a):
    return torch.from_numpy(np.array(a))


def _bf16(a):
    """numpy fp32 -> a torch bf16 tensor (round to nearest even)."""
    return _t(np.asarray(a, np.float32)).to(BF16)


def _np(t):
    """torch or JAX array -> fp32 numpy."""
    if torch.is_tensor(t):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def jax_to_bf16(tree):
    """The JAX engine's cast rule (flowtron_tpu/serve/engine.py:90-101):
    every fp32 leaf to bf16, a quantized leaf-dict ("q"/"q4") as it is."""
    if isinstance(tree, dict):
        if "q" in tree or "q4" in tree:
            return tree
        return {k: jax_to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(jax_to_bf16(v) for v in tree)
    if hasattr(tree, "dtype") and tree.dtype == jnp.float32:
        return tree.astype(jnp.bfloat16)
    return tree


# -- K4 ----------------------------------------------------------------------

def _bf16_ulp(r):
    """One bf16 ulp of each |r| (its spacing at r's binade)."""
    e = np.floor(np.log2(np.maximum(np.abs(r), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("a8", [False, True], ids=["w8", "w8a8"])
@pytest.mark.parametrize("M,K,N", [(3, 96, 128), (9, 200, 256)])
def test_k4_bf16_plain_matches_pallas_interpret(M, K, N, a8):
    """bf16 x, bf16 out (the Pallas default, x's dtype). W8A8 bitwise (its
    int32 sums are exact and both round the fp32 result once); weight-only
    within one bf16 ulp of each output, plus 2^-16 of the output scale
    where a near-zero sum is smaller than the fp32 sums' order."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal((M, K)).astype(np.float32)
    q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    s = (rng.uniform(0.5, 1.5, N) * 0.01).astype(np.float32)
    ref = jax_qmm.quantized_matmul(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(q), jnp.asarray(s),
                                   interpret=True, a8=a8)
    ours = quantized_matmul_reference(_bf16(x), _t(q.T.copy()), _t(s), a8=a8)
    assert ours.dtype == BF16 and ref.dtype == jnp.bfloat16
    o, r = _np(ours), _np(ref)
    err = np.abs(o - r)
    print(f"K4 bf16 {'w8a8' if a8 else 'w8'} M={M} K={K} N={N}: max "
          f"|err| {err.max():.3g}, scale {np.abs(r).max():.3g}")
    if a8:
        np.testing.assert_array_equal(o, r)
    else:
        assert np.all(err <= _bf16_ulp(r) + 2.0 ** -16 * np.abs(r).max())


# -- K2 ----------------------------------------------------------------------

@pytest.mark.parametrize("last", [False, True])
def test_k2_bf16_plain_matches_pallas_interpret(last):
    """One WN layer at C = 64 with bf16 x, cond, weights, x' and skip:
    within 1e-2 of the output scale (each output is rounded to bf16 once
    on both sides; the fp32 sums' order and z's bf16 rounding move a
    rounding by a step), pad rows zero."""
    rng = np.random.default_rng(5)
    B, C, T, tile, d = 2, 64, 200, 128, 4
    Tp = -(-T // tile) * tile
    x = rng.standard_normal((B, Tp, C)).astype(np.float32)
    x[:, T:] = 0
    cond = rng.standard_normal((B, Tp, 2 * C)).astype(np.float32)
    w_cat = (rng.standard_normal((3 * C, 2 * C)) / np.sqrt(3 * C)) \
        .astype(np.float32)
    b = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
    n_rs = C if last else 2 * C
    w_rs = (rng.standard_normal((C, n_rs)) / np.sqrt(C)).astype(np.float32)
    b_rs = (0.1 * rng.standard_normal(n_rs)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    M = B * Tp
    ref = wn_layer_fused(
        _shift_t(xj, d).reshape(M, C), xj.reshape(M, C),
        _shift_t(xj, -d).reshape(M, C),
        jnp.asarray(cond, jnp.bfloat16).reshape(M, -1),
        *(jnp.asarray(a, jnp.bfloat16) for a in (w_cat, b, w_rs, b_rs)),
        T=T, Tp=Tp, last=last, tile=tile, interpret=True)
    ours = wn_layer_reference(*map(_bf16, (x,)), d, _bf16(cond),
                              *map(_bf16, (w_cat, b, w_rs, b_rs)), T)
    for o, r in zip(ours, ref):
        if o is None:
            assert r is None
            continue
        assert o.dtype == BF16 and r.dtype == jnp.bfloat16
        o, r = _np(o), _np(r).reshape(B, Tp, C)
        err, scale = np.abs(o - r).max(), np.abs(r).max()
        print(f"K2 bf16 last={last}: max |err| {err:.3g}, scale "
              f"{scale:.3g}")
        assert err <= 1e-2 * scale
    if not last:
        assert bool((ours[0][:, T:] == 0).all())


# -- K1 ----------------------------------------------------------------------

SMALL = dict(n_mel_channels=8, n_speaker_dim=4, n_text_channels=12,
             n_hidden=16, n_attn_channels=8, n_lstm_layers=2)


def _torch_flow(p):
    """One JAX flow's fp32 params in an ARStep (the full-model bridge)."""
    flow = ARStep(add_gate=True, **SMALL)
    sd = flowtron_state_dict_from_jax({
        "speaker_embedding": {"table": np.zeros((1, 4), np.float32)},
        "embedding": {"table": np.zeros((1, 12), np.float32)},
        "encoder": {"convolutions": [], "lstm": {"layers": []}},
        "flows": [jax.tree.map(np.asarray, p)]})
    flow.load_state_dict({k[len("flows.0."):]: v for k, v in sd.items()
                          if k.startswith("flows.0.")}, strict=True)
    return flow


@pytest.fixture(scope="module")
def k1_case():
    """A gated flow (heads perturbed) in fp32 on both sides, 20 frames of
    3 streams over 5 text positions with a key mask."""
    # jitted: the same numbers as the eager init, one compile instead of
    # one a primitive
    p = jax.jit(lambda k: ar_step_params(k, add_gate=True, **SMALL))(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    for k in ("w", "b"):
        p["conv"][k] = jnp.asarray(0.05 * rng.standard_normal(
            p["conv"][k].shape).astype(np.float32))
    N, B, M, Tk = 20, 3, 8, 5
    residual = (rng.standard_normal((N, B, M)) * 0.5).astype(np.float32)
    text = rng.standard_normal((Tk, B, 16)).astype(np.float32)
    key_mask = np.arange(Tk)[None] < np.asarray([5, 3, 4])[:, None]
    return p, _torch_flow(p), residual, text, key_mask


def _pack_leaves(w):
    out = [(k, v) for k, v in w.items() if torch.is_tensor(v)]
    for k in ("lstm", "dense"):
        out += [(f"{k}[{i}][{j}]", t) for i, ts in enumerate(w[k])
                for j, t in enumerate(ts)]
    return out


def test_k1_bf16_pack_of_fp32_params_and_of_the_cast_flow(k1_case):
    """pack_flow_weights(flow, bf16) of fp32 params (the Pallas packer's
    dtype=bf16) and the cast flow's own pack (ARStep.packed_weights in the
    flow's dtype): matrices bf16 with rows padded to 8 elements, the same
    in both; vectors fp32 holding bf16 values (the summed LSTM biases are
    summed in the params' dtype first, so those two may differ)."""
    a = pack_flow_weights(k1_case[1], BF16)
    b = to_bf16(_torch_flow(k1_case[0])).packed_weights()
    for (name, t), (_, u) in zip(_pack_leaves(a), _pack_leaves(b)):
        assert t.dtype == u.dtype and t.shape == u.shape, name
        if t.dim() == 2:
            assert t.dtype == BF16 and t.shape[1] % 8 == 0, name
            assert torch.equal(t, u), name
        else:
            assert t.dtype == torch.float32, name
            assert torch.equal(t, t.to(BF16).float()), name


@pytest.mark.parametrize("fused", ["early", False], ids=["k1", "loop"])
def test_k1_and_loop_bf16_match_jax(k1_case, fused):
    """The JAX engine's cast rule on both sides, then one flow inverted:
    fused="early" runs K1 (the Pallas kernel in interpret mode; the port's
    plain bf16 pack, built by ARStep.packed_weights in the flow's dtype),
    fused=False the loop (JAX's bf16 scan; the port's _scan_infer on bf16
    tensors). mel bf16 on both sides within 2e-2 of its scale on the
    valid frames, the same n_valid."""
    p, flow, residual, text, key_mask = k1_case
    pb = jax_to_bf16(p)
    mel_j, attn_j, nv_j = jax_ar_step_infer(
        pb, jnp.asarray(residual, jnp.bfloat16),
        jnp.asarray(text, jnp.bfloat16), key_mask=jnp.asarray(key_mask),
        gate_threshold=0.45, fused=fused)
    fb = to_bf16(_torch_flow(p))
    with torch.no_grad():
        mel, attn, nv = ar_step_infer(
            fb, _bf16(residual), _bf16(text), key_mask=_t(key_mask),
            gate_threshold=0.45, fused=fused)
    assert mel.dtype == BF16 and mel_j.dtype == jnp.bfloat16
    assert attn.dtype == BF16 and attn_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_j))
    valid = np.arange(mel.shape[0])[:, None, None] < nv.numpy()[None, :, None]
    err = np.abs(np.where(valid, _np(mel) - _np(mel_j), 0)).max()
    scale = np.abs(_np(mel_j) * valid).max()
    print(f"bf16 flow, fused={fused}: mel max |err| {err:.3g}, scale "
          f"{scale:.3g}")
    assert err <= 2e-2 * scale
    if fused:
        assert fb._packed[1]["att_wi"].dtype == BF16


# -- the slice: a bf16 engine with a vocoder -----------------------------------

# tests/test_serve.py's bf16 case at n_hidden 128, where the LSTM matrices
# reach the quantizer's 65536 elements (w8 and w4 quantize them)
SLICE = dict(n_speakers=1, n_speaker_dim=4, n_text=185, n_text_dim=16,
             n_mel_channels=8, n_hidden=128, n_attn_channels=8,
             n_lstm_layers=2, mel_encoder_n_hidden=8)
SLICE_WG = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
                n_early_size=2, n_layers=3, n_channels=16, kernel_size=3)
N_FRAMES = 24


def _jax_waveglow_params(model, config):
    """A port WaveGlow's weights as the JAX package's params pytree
    (numpy leaves): the inverse of utils/convert.py:waveglow_from_jax."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}

    def conv(name):
        return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}

    wn = []
    for f in range(config["n_flows"]):
        p = {ours: conv(f"WN.{f}.{theirs}") for ours, theirs in (
            ("start", "start"), ("end", "end"), ("cond", "cond_layer"))}
        for kind in ("in_layers", "res_skip_layers"):
            p[kind] = [conv(f"WN.{f}.{kind}.{k}")
                       for k in range(config["n_layers"])]
        wn.append(p)
    params = {"upsample": conv("upsample"), "wn": wn,
              "convinv": [{"w": sd[f"convinv.{f}.conv.weight"][:, :, 0]}
                          for f in range(config["n_flows"])]}
    back = waveglow_from_jax(params, config)
    assert all(torch.equal(back[k], torch.from_numpy(v))
               for k, v in sd.items())
    return params


@pytest.fixture(scope="module")
def slice_files(tmp_path_factory):
    """The files both packages' engines load: a reference-format Flowtron
    .pt (one gated flow, its head perturbed) and a JAX WaveGlow pickle
    (end convs perturbed), written from seeded port models."""
    root = tmp_path_factory.mktemp("bf16_slice")
    rng = np.random.default_rng(0)
    wavfile.write(root / "u.wav", 22050,
                  (rng.standard_normal(4096) * 2000).astype(np.int16))
    (root / "fl.txt").write_text(f"{root}/u.wav|hello|0\n")
    model, _ = flowtron_init(0, n_flows=1, use_gate_layer=True, **SLICE)
    wg, wgc = waveglow_init(seed=1, **SLICE_WG)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        head = model.flows[0].conv.weight
        head.copy_(0.05 * torch.randn(head.shape, generator=g))
        for wn in wg.WN:
            wn.end.weight.copy_(0.05 * torch.randn(wn.end.weight.shape,
                                                   generator=g))
    torch.save({"state_dict": model.state_dict()}, root / "ft.pt")
    with open(root / "wg.pkl", "wb") as fh:
        pickle.dump({"params": _jax_waveglow_params(wg, wgc),
                     "config": wgc}, fh)
    config = jax_load_config(overrides=[
        f"data_config.training_files={root}/fl.txt",
        f"data_config.validation_files={root}/fl.txt",
        "data_config.p_arpabet=0.0", "data_config.cmudict_path=",
        "data_config.heteronyms_path=",
        "data_config.use_attn_prior=False"])
    config["model_config"] = dict(SLICE, n_flows=1, use_gate_layer=True)
    return config, str(root / "ft.pt"), str(root / "wg.pkl")


def _quant_scales_fp32(tree):
    """Whether every quantized leaf-dict of a JAX pytree keeps fp32
    scales; returns (all fp32, leaves seen)."""
    if isinstance(tree, dict):
        if "q" in tree or "q4" in tree:
            return tree["s"].dtype == jnp.float32, 1
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return True, 0
    seen = [_quant_scales_fp32(v) for v in items]
    return all(ok for ok, _ in seen), sum(n for _, n in seen)


def _within(name, ref, jax16, port):
    """The port's bf16 output at most 2x as far from JAX's fp32 one as
    JAX's bf16 output, plus 1e-3 of the scale."""
    e_j, e_p = np.abs(jax16 - ref).max(), np.abs(port - ref).max()
    scale = np.abs(ref).max()
    print(f"bf16 slice {name}: port vs JAX fp32 {e_p:.3g}, JAX bf16 vs JAX "
          f"fp32 {e_j:.3g}, scale {scale:.3g}")
    assert e_p <= 2 * e_j + 1e-3 * scale


@pytest.mark.parametrize("quantize", ["", "w8", "w4"])
def test_bf16_slice_matches_jax(slice_files, quantize):
    """A bf16 engine with a vocoder in each package, alone and with w8 and
    w4 flows, beside the JAX fp32 engine. The port's mel (the same
    latents) and, unquantized, its audio (the vocoder on JAX's fp32 mel and
    one set of latents) lie within ``_within`` of JAX's fp32 output, on
    the frames all three keep; the port keeps JAX's dtype at each output
    and fp32 scales on every quantized leaf; a request and a stream
    through the port's engine give finite audio."""
    config, ft, wg = slice_files
    kw = dict(max_batch=2, batch_timeout_ms=20, text_buckets=(16,),
              n_frames=N_FRAMES, quantize=quantize)
    j32 = JaxEngine(config, ft, waveglow_path=wg, **kw)
    j16 = JaxEngine(config, ft, waveglow_path=wg, bf16=True, **kw)
    eng = SynthesisEngine(config, ft, wg, bf16=True, device="cpu", **kw)
    try:
        ok, n_leaves = _quant_scales_fp32(j16.params)
        scales = [m.s for m in eng.model.modules()
                  if isinstance(m, QuantizedWeight)]
        assert ok and len(scales) == n_leaves and bool(scales) == bool(
            quantize)
        assert all(s.dtype == torch.float32 for s in scales)

        rng = np.random.default_rng(3)
        n_mel = SLICE["n_mel_channels"]
        res = (0.5 * rng.standard_normal((1, n_mel, N_FRAMES))) \
            .astype(np.float32)
        ids = np.asarray(eng.frontend.get_text("Hello there."))
        text = np.zeros((1, 16), np.int64)
        text[0, :len(ids)] = ids
        lens = np.asarray([len(ids)])
        mels = {}
        for tag, je, r in (("j32", j32, jnp.asarray(res)),
                           ("j16", j16, jnp.asarray(res, jnp.bfloat16))):
            mel, _, nv = je._synth(je.params, r, jnp.zeros(1, jnp.int32),
                                   jnp.asarray(text), jnp.asarray(lens), 1.0)
            mels[tag] = (mel, int(nv[0]))
        with torch.no_grad():
            mel, _, nv = flowtron_infer(
                eng.model, eng.static_cfg, _t(res).to(BF16),
                torch.zeros(1, dtype=torch.long), _t(text),
                temperature=1.0, gate_threshold=0.5, in_lens=_t(lens),
                fused=eng.fused)
        mels["port"] = (mel, int(nv[0]))
        assert mel.dtype == BF16 and mels["j16"][0].dtype == jnp.bfloat16
        n = min(v[1] for v in mels.values())
        _within(f"{quantize or 'float'} mel", *(
            _np(mels[k][0])[..., :n] for k in ("j32", "j16", "port")))

        if not quantize:
            wgc = eng.wg_cfg
            Tg = N_FRAMES * 256 // wgc["n_group"]
            z_main = (0.8 * rng.standard_normal(
                (1, waveglow_n_remaining(wgc), Tg))).astype(np.float32)
            z_early = [(0.8 * rng.standard_normal(
                (1, wgc["n_early_size"], Tg))).astype(np.float32)
                if f % wgc["n_early_every"] == 0 and f > 0 else None
                for f in range(wgc["n_flows"])]
            mel32 = _np(mels["j32"][0])
            # jitted, as the JAX engine's chain runs it
            vocode = jax.jit(lambda p, *a: jax_waveglow_infer_z(p, wgc, *a))
            audio = {}
            for tag, je, dt in (("j32", j32, jnp.float32),
                                ("j16", j16, jnp.bfloat16)):
                audio[tag] = vocode(
                    je.wg[0], jnp.asarray(mel32, dt), jnp.asarray(z_main, dt),
                    [None if z is None else jnp.asarray(z, dt)
                     for z in z_early])
            with torch.no_grad():
                audio["port"] = waveglow_infer_z(
                    eng.wg, wgc, _bf16(mel32), _bf16(z_main),
                    [None if z is None else _bf16(z) for z in z_early])
            assert audio["port"].dtype == BF16
            assert audio["j16"].dtype == jnp.bfloat16
            _within("audio", *(_np(audio[k]) for k in ("j32", "j16",
                                                        "port")))

        wav, _ = eng.submit("Hello there.", 0)
        out = np.concatenate(list(eng.stream("Stream me.", 0, seed=2)))
        for a in (wav, out):
            assert len(a) > 0 and np.isfinite(a.astype(np.float64)).all()
    finally:
        for e in (j32, j16, eng):
            e.shutdown()
