"""PyTorch port (flowtron_tpu_torch) vs the JAX package: masks, layers,
masked BiLSTM, text encoder, attention step, the weight bridge and the
text frontend. Inputs are drawn with numpy and given to both; fp32
tolerances are 1e-5 absolute."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.models import layers as jl  # noqa: E402
from flowtron_tpu.models.attention import (  # noqa: E402
    attention_params, attention_step as jax_attention_step,
)
from flowtron_tpu.models.encoder import (  # noqa: E402
    encoder_params, encoder_forward as jax_encoder_forward,
    encoder_infer as jax_encoder_infer,
)
from flowtron_tpu.ops.lstm import lstm_params, bilstm_forward as jax_bilstm  # noqa: E402
from flowtron_tpu.train.checkpoints import export_torch_state_dict  # noqa: E402
from flowtron_tpu.utils import masks as jm  # noqa: E402

from flowtron_tpu_torch.models import layers as tl  # noqa: E402
from flowtron_tpu_torch.models.attention import (  # noqa: E402
    Attention, attention_step,
)
from flowtron_tpu_torch.models.encoder import (  # noqa: E402
    Encoder, encoder_forward, encoder_infer,
)
from flowtron_tpu_torch.models.flowtron import flowtron_init  # noqa: E402
from flowtron_tpu_torch.ops.lstm import LSTM, bilstm_forward  # noqa: E402
from flowtron_tpu_torch.utils import masks as tm  # noqa: E402
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)

ATOL = 1e-5
DIMS = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol)


def _jax_lstm_to_torch(params, module):
    """Load a JAX LSTM pytree into the port's LSTM holder."""
    for k, layer in enumerate(params["layers"]):
        dirs = [("", layer["fwd"]), ("_reverse", layer["bwd"])] \
            if "fwd" in layer else [("", layer)]
        for suffix, p in dirs:
            with torch.no_grad():
                getattr(module, f"weight_ih_l{k}{suffix}").copy_(
                    _t(np.asarray(p["w_ih"]).T))
                getattr(module, f"weight_hh_l{k}{suffix}").copy_(
                    _t(np.asarray(p["w_hh"]).T))
                getattr(module, f"bias_ih_l{k}{suffix}").copy_(_t(p["b_ih"]))
                getattr(module, f"bias_hh_l{k}{suffix}").copy_(_t(p["b_hh"]))


class TestMasks:
    @pytest.mark.parametrize("lengths", [[5, 3, 1], [7, 7, 2]])
    def test_sequence_mask_and_flip(self, lengths):
        lens = np.asarray(lengths)
        np.testing.assert_array_equal(
            tm.sequence_mask(_t(lens), 7).numpy(),
            np.asarray(jm.sequence_mask(jnp.asarray(lens), 7)))
        np.testing.assert_array_equal(
            tm.flip_within_length_indices(_t(lens), 7).numpy(),
            np.asarray(jm.flip_within_length_indices(jnp.asarray(lens), 7)))

    def test_flip_time_matches_jax(self):
        from flowtron_tpu.models.ar_step import _flip_time
        rng = np.random.default_rng(0)
        x = rng.standard_normal((6, 3, 2)).astype(np.float32)
        lens = np.asarray([6, 4, 1])
        _close(tm.flip_time(_t(x), _t(lens)),
               _flip_time(jnp.asarray(x), jnp.asarray(lens)), atol=0)


class TestLayers:
    def setup_method(self):
        self.rng = np.random.default_rng(1)

    def test_conv1d_same(self):
        p = jl.conv1d_params(jax.random.PRNGKey(0), 6, 5, 5,
                             w_init_gain="relu")
        p["b"] = jnp.asarray(self.rng.standard_normal(5).astype(np.float32))
        x = self.rng.standard_normal((2, 6, 9)).astype(np.float32)
        for dil in (1, 2):
            _close(tl.conv1d_same(_t(x), _t(p["w"]), _t(p["b"]), dil),
                   jl.conv1d_apply(p, jnp.asarray(x), dilation=dil))

    def test_instance_norms(self):
        x = self.rng.standard_normal((3, 4, 9)).astype(np.float32)
        w = self.rng.standard_normal(4).astype(np.float32)
        b = self.rng.standard_normal(4).astype(np.float32)
        mask = np.arange(9)[None, None, :] < np.asarray([9, 6, 2])[:, None,
                                                                   None]
        _close(tl.masked_instance_norm(_t(x), _t(mask), weight=_t(w),
                                       bias=_t(b)),
               jl.masked_instance_norm(jnp.asarray(x), jnp.asarray(mask),
                                       weight=jnp.asarray(w),
                                       bias=jnp.asarray(b)))
        _close(tl.instance_norm(_t(x), weight=_t(w), bias=_t(b)),
               jl.instance_norm(jnp.asarray(x), weight=jnp.asarray(w),
                                bias=jnp.asarray(b)))

    def test_dense_stack_and_embedding(self):
        p = jl.dense_layer_params(jax.random.PRNGKey(2), 6, (7, 5))
        dense = tl.DenseLayer(6, (7, 5))
        with torch.no_grad():
            for lin, lp in zip(dense.layers, p["layers"]):
                lin.linear_layer.weight.copy_(_t(np.asarray(lp["w"]).T))
                lin.linear_layer.bias.copy_(
                    _t(self.rng.standard_normal(lp["b"].shape)
                       .astype(np.float32)))
                lp["b"] = jnp.asarray(lin.linear_layer.bias.numpy())
        x = self.rng.standard_normal((3, 6)).astype(np.float32)
        _close(dense(_t(x)), jl.dense_layer_apply(p, jnp.asarray(x)))
        table = self.rng.standard_normal((10, 3)).astype(np.float32)
        ids = np.asarray([[1, 9, 0]])
        emb = tl.Embedding(10, 3)
        with torch.no_grad():
            emb.weight.copy_(_t(table))
        _close(emb(_t(ids)), jl.embedding_apply({"table": jnp.asarray(table)},
                                                jnp.asarray(ids)), atol=0)


class TestLSTMAndEncoder:
    def test_masked_bilstm_unequal_lengths(self):
        p = lstm_params(jax.random.PRNGKey(3), 6, 5, num_layers=2,
                        bidirectional=True)
        mod = LSTM(6, 5, num_layers=2, bidirectional=True)
        _jax_lstm_to_torch(p, mod)
        rng = np.random.default_rng(4)
        x = rng.standard_normal((8, 3, 6)).astype(np.float32)
        mask = (np.arange(8)[:, None] < np.asarray([8, 5, 2])[None]).astype(
            np.float32)
        with torch.no_grad():
            ours = bilstm_forward(mod, _t(x), _t(mask))
        _close(ours, jax_bilstm(p, jnp.asarray(x), jnp.asarray(mask)))
        # padded steps are exactly zero, as with packed sequences
        assert float(ours[5:, 1].abs().max()) == 0.0

    @pytest.mark.parametrize("masked", [False, True])
    def test_text_encoder(self, masked):
        p = encoder_params(jax.random.PRNGKey(5), encoder_embedding_dim=12)
        rng = np.random.default_rng(6)
        for conv in p["convolutions"]:
            conv["conv"]["b"] = jnp.asarray(
                rng.standard_normal(12).astype(np.float32) * 0.1)
            conv["norm"]["weight"] = jnp.asarray(
                1 + 0.1 * rng.standard_normal(12).astype(np.float32))
        enc = Encoder(encoder_embedding_dim=12)
        with torch.no_grad():
            for (conv, norm), jp in zip(enc.convolutions, p["convolutions"]):
                conv.conv.weight.copy_(_t(jp["conv"]["w"]))
                conv.conv.bias.copy_(_t(jp["conv"]["b"]))
                norm.weight.copy_(_t(jp["norm"]["weight"]))
                norm.bias.copy_(_t(jp["norm"]["bias"]))
        _jax_lstm_to_torch(p["lstm"], enc.lstm)
        x = rng.standard_normal((2, 12, 9)).astype(np.float32)
        with torch.no_grad():
            if masked:
                mask = np.arange(9)[None] < np.asarray([9, 5])[:, None]
                ours = encoder_forward(enc, _t(x), _t(mask))
                ref = jax_encoder_forward(p, jnp.asarray(x),
                                          jnp.asarray(mask))
            else:
                ours = encoder_infer(enc, _t(x))
                ref = jax_encoder_infer(p, jnp.asarray(x))
        _close(ours, ref)


class TestAttentionStep:
    @pytest.mark.parametrize("case", ["plain", "mask_prior", "per_stream"])
    def test_matches_jax(self, case):
        p = attention_params(jax.random.PRNGKey(7), 16, 4, 12, 8)
        att = Attention(16, 4, 12, 8)
        with torch.no_grad():
            for name in ("query", "key", "value", "v"):
                getattr(att, name).linear_layer.weight.copy_(
                    _t(np.asarray(p[name]["w"]).T))
        rng = np.random.default_rng(8)
        B, Tk = 3, 6
        q = rng.standard_normal((B, 16)).astype(np.float32)
        kp = rng.standard_normal((B, Tk, 8)).astype(np.float32)
        vals = rng.standard_normal((B, Tk, 8)).astype(np.float32)
        mask = prior = None
        temp = 1.3
        if case == "mask_prior":
            mask = np.arange(Tk)[None] < np.asarray([6, 4, 2])[:, None]
            prior = rng.uniform(0.01, 1, (B, Tk)).astype(np.float32)
        if case == "per_stream":
            temp = np.asarray([[0.5], [1.0], [2.0]], np.float32)
        opt = (lambda a, f: None if a is None else f(a))
        with torch.no_grad():
            ctx, w = attention_step(
                att, _t(q), _t(kp), _t(vals), key_mask=opt(mask, _t),
                prior_t=opt(prior, _t),
                temperature=_t(temp) if case == "per_stream" else temp)
        ctx_j, w_j = jax_attention_step(
            p, jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vals),
            key_mask=opt(mask, jnp.asarray), prior_t=opt(prior, jnp.asarray),
            temperature=jnp.asarray(temp) if case == "per_stream" else temp)
        _close(ctx, ctx_j)
        _close(w, w_j)


class TestWeightBridge:
    def test_state_dict_matches_export_and_loads_strict(self):
        params, _ = jax_flowtron_init(jax.random.PRNGKey(0), n_flows=3,
                                      use_gate_layer=True, **DIMS)
        ours = flowtron_state_dict_from_jax(_np(params))
        ref = export_torch_state_dict(params)
        assert list(ours) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)
        model, _ = flowtron_init(0, n_flows=3, use_gate_layer=True, **DIMS)
        model.load_state_dict(ours, strict=True)
        # and the port's own parameter set is exactly the reference's
        assert set(model.state_dict()) == set(ref)


class TestFrontend:
    def test_ids_match_data_get_text(self):
        """The same config.json data_config gives the same ids in both
        packages, draw for draw (p_arpabet 0.5, fixed seed)."""
        from flowtron_tpu.config import load_config
        from flowtron_tpu.data.dataset import Data, data_kwargs
        from flowtron_tpu_torch.data.frontend import TextFrontend

        dc = load_config("config.json")["data_config"]
        assert dc["p_arpabet"] == 0.5
        ref = Data(dc["training_files"], **data_kwargs(dc))
        ours = TextFrontend.from_config(dc)
        texts = ["The house on the street, read by Dr. Smith in 1984.",
                 "Turn left at the cat's house!", "It's 3:30 pm; NASA?"] * 3
        for text in texts:
            np.testing.assert_array_equal(ours.get_text(text),
                                          ref.get_text(text), err_msg=text)
        assert ours.get_speaker_id(0) == ref.get_speaker_id(0)
