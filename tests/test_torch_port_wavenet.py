"""Kernel K2 (flowtron_tpu_torch/ops/wavenet.py) and the port's WaveGlow
against the JAX package: the WN layer's plain version against the Pallas
kernel in interpret mode, and the whole inverse pass with the same numpy
latents. The zero-init end convs are perturbed."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.ops.wavenet_pallas import wn_layer_fused  # noqa: E402
from flowtron_tpu.vocoder import waveglow_init as jax_waveglow_init  # noqa: E402
from flowtron_tpu.vocoder.waveglow import (  # noqa: E402
    _shift_t, _upsample_mel as jax_upsample,
    waveglow_infer_z as jax_waveglow_infer_z,
)

from flowtron_tpu_torch.ops.wavenet import wn_layer, wn_layer_reference  # noqa: E402
from flowtron_tpu_torch.utils.convert import waveglow_from_jax  # noqa: E402
from flowtron_tpu_torch.vocoder.waveglow import (  # noqa: E402
    _upsample_mel, load_waveglow, waveglow_init, waveglow_infer_z,
    waveglow_n_remaining,
)

TINY = dict(n_mel_channels=8, n_flows=4, n_group=8, n_early_every=2,
            n_early_size=2, n_layers=2, n_channels=16, kernel_size=3)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def wg():
    params, cfg = jax_waveglow_init(jax.random.PRNGKey(0), **TINY)
    rng = np.random.default_rng(1)
    for f in range(cfg["n_flows"]):
        params["wn"][f]["end"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
            params["wn"][f]["end"]["w"].shape).astype(np.float32))
    model, tcfg = waveglow_init(**TINY)
    model.load_state_dict(waveglow_from_jax(jax.tree.map(np.asarray, params),
                                            cfg), strict=True)
    return params, cfg, model, tcfg


class TestWNLayer:
    # T = 300 is not a multiple of the 128-row tile: rows 300..383 pad
    @pytest.mark.parametrize("last", [False, True])
    @pytest.mark.parametrize("d", [1, 4])
    def test_matches_pallas_interpret(self, last, d):
        rng = np.random.default_rng(2)
        B, C, T, tile = 2, 16, 300, 128
        Tp = -(-T // tile) * tile
        x = rng.standard_normal((B, Tp, C)).astype(np.float32)
        x[:, T:] = 0
        cond = rng.standard_normal((B, Tp, 2 * C)).astype(np.float32)
        w_cat = (0.2 * rng.standard_normal((3 * C, 2 * C))).astype(np.float32)
        b = (0.1 * rng.standard_normal(2 * C)).astype(np.float32)
        n_rs = C if last else 2 * C
        w_rs = (0.2 * rng.standard_normal((C, n_rs))).astype(np.float32)
        b_rs = (0.1 * rng.standard_normal(n_rs)).astype(np.float32)
        xj, M = jnp.asarray(x), B * Tp
        x_new_j, skip_j = wn_layer_fused(
            _shift_t(xj, d).reshape(M, C), xj.reshape(M, C),
            _shift_t(xj, -d).reshape(M, C), jnp.asarray(cond).reshape(M, -1),
            jnp.asarray(w_cat), jnp.asarray(b), jnp.asarray(w_rs),
            jnp.asarray(b_rs), T=T, Tp=Tp, last=last, tile=tile,
            interpret=True)
        x_new, skip = wn_layer(_t(x), d, _t(cond), _t(w_cat), _t(b),
                               _t(w_rs), _t(b_rs), T)
        np.testing.assert_allclose(skip.numpy(),
                                   np.asarray(skip_j).reshape(B, Tp, -1),
                                   atol=1e-5)
        if last:
            assert x_new is None
        else:
            np.testing.assert_allclose(x_new.numpy(),
                                       np.asarray(x_new_j).reshape(B, Tp, C),
                                       atol=1e-5)
            assert float(x_new[:, T:].abs().max()) == 0.0

    def test_shift_reads_zero_outside_valid_rows(self):
        """Rows t >= T are padding even if they hold garbage: the shifted
        taps read zeros there, so valid rows do not see them."""
        rng = np.random.default_rng(3)
        B, C, T, Tp = 1, 16, 10, 16
        args = [rng.standard_normal(s).astype(np.float32) for s in
                ((B, Tp, 2 * C), (3 * C, 2 * C), (2 * C,), (C, 2 * C),
                 (2 * C,))]
        x = rng.standard_normal((B, Tp, C)).astype(np.float32)
        clean = x.copy()
        clean[:, T:] = 0
        a = wn_layer_reference(_t(x), 2, *map(_t, args), T)
        b = wn_layer_reference(_t(clean), 2, *map(_t, args), T)
        torch.testing.assert_close(a[0], b[0])
        torch.testing.assert_close(a[1][:, :T], b[1][:, :T])


class TestWaveGlow:
    def test_upsample_matches_jax(self, wg):
        params, _, model, _ = wg
        spect = np.random.default_rng(4).standard_normal((2, 8, 5)) \
            .astype(np.float32)
        with torch.no_grad():
            ours = _upsample_mel(model, _t(spect), 8, 5 * 256)
        np.testing.assert_allclose(
            ours.numpy(), np.asarray(jax_upsample(params, jnp.asarray(spect),
                                                  8, 5 * 256)), atol=2e-6)

    def test_infer_z_matches_jax(self, wg):
        params, cfg, model, tcfg = wg
        rng = np.random.default_rng(5)
        B, T_mel = 2, 5
        Tg = T_mel * 256 // 8
        spect = rng.standard_normal((B, 8, T_mel)).astype(np.float32)
        z_main = rng.standard_normal(
            (B, waveglow_n_remaining(tcfg), Tg)).astype(np.float32)
        z_early = [rng.standard_normal((B, 2, Tg)).astype(np.float32)
                   if f % 2 == 0 and f > 0 else None for f in range(4)]
        ref = jax_waveglow_infer_z(
            params, cfg, jnp.asarray(spect), jnp.asarray(z_main),
            [None if z is None else jnp.asarray(z) for z in z_early],
            impl="pallas_interpret")
        ours = waveglow_infer_z(model, tcfg, _t(spect), _t(z_main),
                                [None if z is None else _t(z)
                                 for z in z_early])
        assert ours.shape == (B, T_mel * 256)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)

    def test_load_folds_weight_norm(self, tmp_path):
        """load_waveglow reads a published-layout state_dict with
        weight_norm pairs and loads it strictly."""
        model, _ = waveglow_init(seed=3)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        name = "WN.0.in_layers.1.weight"
        v = sd.pop(name) * 3.0
        sd[name[:-len("weight")] + "weight_v"] = v
        sd[name[:-len("weight")] + "weight_g"] = \
            v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt() / 3.0
        torch.save({"model": sd}, tmp_path / "wg.pt")
        loaded, cfg = load_waveglow(str(tmp_path / "wg.pt"))
        assert cfg["n_channels"] == 256
        for k, ref in model.state_dict().items():
            torch.testing.assert_close(loaded.state_dict()[k], ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("last", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, last):
    """K2 against its plain version, with pad rows and a strided cond
    slice (C = 64, the smallest width the kernel takes)."""
    g = torch.Generator().manual_seed(0)
    B, C, T, Tp, d = 2, 64, 300, 384, 4
    x = torch.randn(B, Tp, C, generator=g)
    x[:, T:] = 0
    cond_all = torch.randn(B, Tp, 6 * C, generator=g)
    n_rs = C if last else 2 * C
    weights = [0.1 * torch.randn(3 * C, 2 * C, generator=g),
               torch.randn(2 * C, generator=g),
               0.1 * torch.randn(C, n_rs, generator=g),
               torch.randn(n_rs, generator=g)]
    ref = wn_layer_reference(x, d, cond_all[..., 2 * C:4 * C], *weights, T)
    cond_dev = cond_all.to(cuda_device)[..., 2 * C:4 * C]   # row stride 6C
    dev_args = [x.to(cuda_device), d, cond_dev,
                *[w.to(cuda_device) for w in weights], T]
    ours = wn_layer(*dev_args)
    for a, r in zip(ours, ref):
        if r is None:
            assert a is None
        else:
            torch.testing.assert_close(a.cpu(), r, atol=1e-4, rtol=0)
    if not last:
        assert bool((ours[0][:, T:] == 0).all())
    with pytest.raises(TypeError, match="float32"):
        wn_layer(*[a.double() if torch.is_tensor(a) else a
                   for a in dev_args])
