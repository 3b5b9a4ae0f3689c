"""Kernel K1 (flowtron_tpu_torch/ops/decoder.py): its plain version
against the JAX Pallas kernel (interpret mode) and the JAX scan path, the
port's routing in ar_step_infer, early-exit semantics, the kernel's split
of each frame over blocks (``k1_plan``), and a CPU emulation of the
kernel's order of sums against JAX. Toy widths as in tests/test_pallas.py;
zero-init coupling heads are perturbed."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")
F = torch.nn.functional

from flowtron_tpu.models import flowtron_init as jax_flowtron_init  # noqa: E402
from flowtron_tpu.models import flowtron_infer as jax_flowtron_infer  # noqa: E402
from flowtron_tpu.models.ar_step import (  # noqa: E402
    ar_step_params, ar_step_infer as jax_ar_step_infer,
)
from flowtron_tpu.models.attention import (  # noqa: E402
    attention_precompute as jax_attention_precompute,
)
from flowtron_tpu.ops.decoder_pallas import (  # noqa: E402
    pack_flow_weights as jax_pack, fused_flow_infer as jax_fused,
)

from flowtron_tpu_torch.models.ar_step import ARStep, ar_step_infer  # noqa: E402
from flowtron_tpu_torch.models.flowtron import (  # noqa: E402
    flowtron_init, flowtron_infer,
)
import flowtron_tpu_torch.ops.decoder as k1_module  # noqa: E402
from flowtron_tpu_torch.ops.decoder import (  # noqa: E402
    K1_BF16_STATIC, MAX_LAYERS, _TAB, _job_matrices, _with_matrices,
    fused_flow_infer, fused_flow_infer_reference, k1_attn_parts,
    k1_blocks, k1_bounds_array, k1_bytes, k1_fixed_bytes, k1_pack,
    k1_pack_for, k1_plan, k1_resident_layout, k1_resident_plan, k1_unpack,
    pack_flow_weights,
)
from flowtron_tpu_torch.utils.weights import to_bf16  # noqa: E402
from flowtron_tpu_torch.utils.convert import (  # noqa: E402
    flowtron_state_dict_from_jax,
)

SMALL = dict(n_mel_channels=8, n_speaker_dim=4, n_text_channels=12,
             n_hidden=16, n_attn_channels=8, n_lstm_layers=2)
DIMS = dict(n_speakers=2, n_speaker_dim=4, n_text=185, n_text_dim=12,
            n_mel_channels=8, n_hidden=16, n_attn_channels=8,
            n_lstm_layers=2, mel_encoder_n_hidden=8)


def _jax_flow(seed=0):
    p = ar_step_params(jax.random.PRNGKey(seed), add_gate=True, **SMALL)
    rng = np.random.default_rng(seed + 1)
    p["conv"]["w"] = jnp.asarray(
        0.05 * rng.standard_normal(p["conv"]["w"].shape).astype(np.float32))
    p["conv"]["b"] = jnp.asarray(
        0.05 * rng.standard_normal(p["conv"]["b"].shape).astype(np.float32))
    return p


def _torch_flow(p, dims=SMALL):
    """Load one JAX flow into an ARStep through the full-model bridge."""
    flow = ARStep(add_gate=True, **dims)
    sd = flowtron_state_dict_from_jax({
        "speaker_embedding": {"table": np.zeros((1, 4), np.float32)},
        "embedding": {"table": np.zeros((1, 12), np.float32)},
        "encoder": {"convolutions": [], "lstm": {"layers": []}},
        "flows": [jax.tree.map(np.asarray, p)]})
    flow.load_state_dict({k[len("flows.0."):]: v for k, v in sd.items()
                          if k.startswith("flows.0.")}, strict=True)
    return flow


@pytest.fixture(scope="module")
def case():
    p = _jax_flow()
    rng = np.random.default_rng(2)
    N, B, M, Tk = 20, 3, 8, 5
    residual = (rng.standard_normal((N, B, M)) * 0.5).astype(np.float32)
    text = rng.standard_normal((Tk, B, 16)).astype(np.float32)
    key_mask = (np.arange(Tk)[None] < np.asarray([5, 3, 4])[:, None])
    return p, _torch_flow(p), residual, text, key_mask


def _t(a):
    return torch.from_numpy(np.array(a))


class TestPlainVersion:
    def test_matches_pallas_interpret_with_key_mask(self, case):
        p, flow, residual, text, key_mask = case
        kp, vals = jax_attention_precompute(p["attention_layer"],
                                            jnp.asarray(text),
                                            jnp.asarray(text))
        km = key_mask.astype(np.float32)
        mel_j, attn_j, gates_j = jax_fused(
            jax_pack(p, dtype=jnp.float32), jnp.asarray(residual), kp, vals,
            jnp.asarray(km), 1.3, interpret=True)
        ours = fused_flow_infer_reference(
            flow.packed_weights(), _t(residual), _t(kp), _t(vals), _t(km),
            1.3)
        for a, r in zip(ours, (mel_j, attn_j, gates_j)):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                       atol=1e-5)

    @pytest.mark.parametrize("fused", [False, True])
    def test_port_paths_match_jax_scan(self, case, fused):
        """ar_step_infer on CPU: the plain loop (fused=False) and K1's
        plain version (fused=True) both equal the JAX scan."""
        p, flow, residual, text, key_mask = case
        mel_j, attn_j, nv_j = jax_ar_step_infer(
            p, jnp.asarray(residual), jnp.asarray(text),
            key_mask=jnp.asarray(key_mask), gate_threshold=0.45)
        with torch.no_grad():
            mel, attn, nv = ar_step_infer(
                flow, _t(residual), _t(text), key_mask=_t(key_mask),
                gate_threshold=0.45, fused=fused)
        np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=1e-5)
        np.testing.assert_allclose(attn.numpy(), np.asarray(attn_j),
                                   atol=1e-5)
        np.testing.assert_array_equal(nv.numpy(), np.asarray(nv_j))

    @pytest.mark.parametrize("fused", [False, "early"])
    def test_prior_and_per_stream_temperature_on_plain_loop(self, case,
                                                            fused):
        """Outside K1's subset a CPU flow runs the plain loop even when
        fused is asked for, as the JAX package falls back to its scan."""
        p, flow, residual, text, _ = case
        rng = np.random.default_rng(9)
        prior = rng.uniform(0.01, 1, (3, 20, 5)).astype(np.float32)
        temp = np.asarray([[0.7], [1.0], [1.6]], np.float32)
        mel_j, _, _ = jax_ar_step_infer(
            p, jnp.asarray(residual), jnp.asarray(text),
            attn_prior=jnp.asarray(prior), temperature=jnp.asarray(temp),
            gate_threshold=1e6, fused=fused)
        with torch.no_grad():
            mel, _, _ = ar_step_infer(flow, _t(residual), _t(text),
                                      attn_prior=_t(prior),
                                      temperature=_t(temp),
                                      gate_threshold=1e6, fused=fused)
        np.testing.assert_allclose(mel.numpy(), np.asarray(mel_j), atol=1e-5)

    def test_wrapper_has_no_silent_fallback(self, case):
        """Only CPU tensors take the plain version; any other device
        launches the kernel or raises."""
        _, flow, residual, text, key_mask = case
        w = {k: (v.to("meta") if torch.is_tensor(v) else
                 [tuple(t.to("meta") for t in pair) for pair in v])
             for k, v in flow.packed_weights().items()}
        meta = torch.zeros(20, 3, 8, device="meta")
        with pytest.raises(ValueError, match="no kernel"):
            fused_flow_infer(w, meta, meta, meta, meta, 1.0)


class TestEarlyExit:
    @pytest.fixture(scope="class")
    def models(self):
        params, cfg = jax_flowtron_init(jax.random.PRNGKey(0), n_flows=2,
                                        use_gate_layer=True, **DIMS)
        rng = np.random.default_rng(1)
        for f in params["flows"]:
            f["conv"]["w"] = jnp.asarray(0.05 * rng.standard_normal(
                f["conv"]["w"].shape).astype(np.float32))
        gate = params["flows"][-1]["gate_layer"]
        gate["w"] = jnp.ones_like(gate["w"]) * 0.2
        model, tcfg = flowtron_init(0, n_flows=2, use_gate_layer=True,
                                    **DIMS)
        model.load_state_dict(flowtron_state_dict_from_jax(
            jax.tree.map(np.asarray, params)), strict=True)
        return params, cfg, model, tcfg

    # 0.35: every stream fires early, later frames are skipped;
    # 0.55: one early hit, two never
    @pytest.mark.parametrize("thresh", [0.35, 0.55])
    def test_matches_scan_on_valid_prefix(self, models, thresh):
        params, cfg, model, tcfg = models
        rng = np.random.default_rng(3)
        B, N = 3, 40
        residual = (rng.standard_normal((B, 8, N)) * 0.8).astype(np.float32)
        text = rng.integers(1, 185, (B, 7))
        sids = np.asarray([0, 1, 0])
        mel_s, _, nv_s = jax_flowtron_infer(
            params, cfg, jnp.asarray(residual), jnp.asarray(sids),
            jnp.asarray(text), gate_threshold=thresh)
        mel_e, _, nv_e = flowtron_infer(
            model, tcfg, _t(residual), _t(sids), _t(text),
            gate_threshold=thresh, fused="early")
        nv_s = np.asarray(nv_s)
        np.testing.assert_array_equal(nv_e.numpy(), nv_s)
        for b in range(B):
            n = int(nv_s[b])
            np.testing.assert_allclose(mel_e.numpy()[b, :, :n],
                                       np.asarray(mel_s)[b, :, :n],
                                       atol=1e-4, err_msg=f"b={b}")
        assert not np.isnan(mel_e.numpy()).any()

    def test_skipped_frames_are_zero_with_gate_one(self, case):
        p, flow, residual, text, key_mask = case
        with torch.no_grad():
            from flowtron_tpu_torch.models.attention import (
                attention_precompute)
            kp, vals = attention_precompute(flow.attention_layer, _t(text),
                                            _t(text))
            w = flow.packed_weights()
            args = (w, _t(residual), kp, vals,
                    torch.ones(3, 5), 1.0)
            mel, attn, gates = fused_flow_infer(*args)
            thresh = float(gates[:5].max(dim=0).values.min()) - 1e-4
            mel_e, attn_e, gates_e = fused_flow_infer(
                *args, early_exit=True, gate_threshold=thresh)
        hit = gates > thresh
        stop = int(hit.to(torch.int64).argmax(dim=0).max())   # done_at
        assert stop < 19
        torch.testing.assert_close(mel_e[:stop + 1], mel[:stop + 1])
        assert bool((mel_e[stop + 1:] == 0).all())
        assert bool((attn_e[stop + 1:] == 0).all())
        assert bool((gates_e[stop + 1:] == 1).all())


FLAGSHIP_K1 = dict(B=1, M=80, H=1024, D=640, n_layers=2, n_dense=2)
SMALL_K1 = dict(B=3, M=8, H=16, D=8, n_layers=2, n_dense=2)


class TestPlan:
    @pytest.mark.parametrize("n_blocks", [132, 114, 7, 1])
    @pytest.mark.parametrize("dims", [FLAGSHIP_K1, SMALL_K1],
                             ids=["flagship", "small"])
    def test_every_row_once_and_balanced(self, dims, n_blocks):
        plan = k1_plan(n_blocks=n_blocks, **dims)
        H, D, M = dims["H"], dims["D"], dims["M"]
        L, nd = dims["n_layers"], dims["n_dense"]
        assert [st.name for st in plan.stages] == (
            ["att", "query", "attn"] + [f"lstm_{l}" for l in range(L)]
            + [f"dense_{i}" for i in range(nd)] + ["head"])
        rows = {name: r for st in plan.stages for name, r, _ in st.jobs}
        assert rows["att_ih"] == rows["rec_att"] == 4 * H
        assert rows["q"] == D and rows["head"] == 2 * M
        assert sorted(n for n in rows if n.startswith("rec_")) == sorted(
            ["rec_att"] + [f"rec_{l}" for l in range(L)])
        for st in plan.stages:
            stage_bytes = [0] * n_blocks
            for (name, r, width), b in zip(st.jobs, st.bounds):
                quads = -(-r // 4)
                assert len(b) == n_blocks + 1
                assert b[0] == 0 and b[-1] == quads, (st.name, name)
                counts = [b[i + 1] - b[i] for i in range(n_blocks)]
                # contiguous, each quad once; at most one over the mean
                assert min(counts) >= 0 and sum(counts) == quads
                assert max(counts) <= quads / n_blocks + 1, (st.name, name)
                for i, c in enumerate(counts):
                    stage_bytes[i] += 16 * width * c
            # every block streams about 1 / n_blocks of the stage's bytes:
            # at most one quad of each job over the mean
            worst = sum(16 * width for _, _, width in st.jobs)
            assert max(stage_bytes) <= sum(stage_bytes) / n_blocks + worst
        flat = k1_bounds_array(plan)
        assert len(flat) == len(plan.stages) * MAX_LAYERS * (n_blocks + 1)

    @pytest.mark.parametrize("B,Tk,n_blocks,parts", [
        (1, 43, 132, 16), (4, 128, 132, 8), (12, 128, 132, 4),
        (1, 5, 132, 5), (2, 128, 3, 3)])
    def test_attention_parts(self, B, Tk, n_blocks, parts):
        assert k1_attn_parts(B, Tk, n_blocks) == parts


def k1_emulated(weights, residual, k_proj, vals, key_mask, temperature,
                n_blocks, early_exit=False, gate_threshold=1e6,
                n_valid_in=None):
    """csrc/decoder.cu's order of sums in plain PyTorch: each LSTM's
    recurrent half W_hh . h(t - 1) summed apart and added to the input
    half before the bias; attention in k1_attn_parts partials of
    contiguous key ranges (scores, local max, exp sum, unnormalised
    context), combined with the weights exp(m_j - max) / sum."""
    w = weights
    N, B, M = residual.shape
    H = w["att_wh"].shape[0] // 4
    D = w["q_w"].shape[0]
    Tk = k_proj.shape[1]
    Mp, Hp, Lp = (-(-n // 4) * 4 for n in (M, H, H + D))
    parts = k1_attn_parts(B, Tk, n_blocks)
    if n_valid_in is None:
        n_valid_in = torch.full((B,), N, dtype=torch.int32)

    def cell(wi, wh, bias, x, h, c):
        ih = F.pad(x, (0, wi.shape[1] - x.shape[1])) @ wi.t()
        rec = F.pad(h, (0, wh.shape[1] - H)) @ wh.t()
        g = ((ih + rec) + bias).view(B, H, 4)
        c = torch.sigmoid(g[..., 1]) * c \
            + torch.sigmoid(g[..., 0]) * torch.tanh(g[..., 2])
        return torch.sigmoid(g[..., 3]) * torch.tanh(c), c

    mel = residual.new_zeros(N, B, M)
    attn = residual.new_zeros(N, B, Tk)
    gates = residual.new_ones(N, B)
    zeros = residual.new_zeros(B, H)
    h_att = c_att = zeros
    hs, cs = [zeros] * len(w["lstm"]), [zeros] * len(w["lstm"])
    prev = residual.new_zeros(B, M)
    done = torch.zeros(B, dtype=torch.bool)
    for t in range(N):
        h_att, c_att = cell(w["att_wi"], w["att_wh"], w["att_b"], prev,
                            h_att, c_att)
        q = h_att @ w["q_w"][:, :H].t() + w["q_b"]
        s = (torch.tanh(q[:, None, :] + k_proj) * w["v_w"]).sum(-1)
        s = torch.where(key_mask > 0.5, s / temperature, -1e9)
        ms, es, cs_part = [], [], []
        for j in range(parts):
            k0, k1 = j * Tk // parts, (j + 1) * Tk // parts
            m = s[:, k0:k1].max(dim=1).values
            e = torch.exp(s[:, k0:k1] - m[:, None])
            ms.append(m)
            es.append(e.sum(dim=1))
            cs_part.append(torch.einsum("bk,bkd->bd", e, vals[:, k0:k1]))
        mx = torch.stack(ms).max(dim=0).values
        ssum = sum(e * torch.exp(m - mx) for m, e in zip(ms, es))
        ctx = sum((torch.exp(m - mx) / ssum)[:, None] * c
                  for m, c in zip(ms, cs_part))
        a = torch.exp(s - mx[:, None]) / ssum[:, None]
        x = torch.cat([h_att, ctx], dim=-1)
        gate = torch.sigmoid(x @ w["gate_w"] + w["gate_b"]) \
            if "gate_w" in w else residual.new_zeros(B)
        for k, (wi, wh, lb) in enumerate(w["lstm"]):
            hs[k], cs[k] = cell(wi, wh, lb, x, hs[k], cs[k])
            x = hs[k]
        for dw, db in w["dense"]:
            x = torch.tanh(x @ dw[:, :H].t() + db)
        out2 = (x @ w["head_w"][:, :H].t() + w["head_b"]).view(B, M, 2)
        prev = (residual[t] - out2[..., 1]) * torch.exp(-out2[..., 0])
        mel[t], attn[t], gates[t] = prev, a, gate
        if early_exit:
            done |= (gate > gate_threshold) | (t + 1 >= n_valid_in)
            if bool(done.all()):
                break
    return mel, attn, gates


class TestKernelOrderOfSums:
    @pytest.mark.parametrize("n_blocks", [3, 132])
    @pytest.mark.parametrize("early", [False, True])
    def test_emulation_matches_jax(self, case, early, n_blocks):
        p, flow, residual, text, key_mask = case
        kp, vals = jax_attention_precompute(p["attention_layer"],
                                            jnp.asarray(text),
                                            jnp.asarray(text))
        km = key_mask.astype(np.float32)
        nvin = np.asarray([20, 9, 20], np.int32)
        kw = dict(early_exit=early, gate_threshold=0.45,
                  n_valid_in=jnp.asarray(nvin))
        mel_j, attn_j, gates_j = jax_fused(
            jax_pack(p, dtype=jnp.float32), jnp.asarray(residual), kp, vals,
            jnp.asarray(km), 1.3, interpret=True, **kw)
        ours = k1_emulated(
            flow.packed_weights(), _t(residual), _t(kp), _t(vals), _t(km),
            1.3, n_blocks, early_exit=early, gate_threshold=0.45,
            n_valid_in=_t(nvin))
        # JAX decides early exit per 16-frame chunk, the kernel per frame:
        # they agree up to the frame at which every stream is done
        g = np.asarray(gates_j)
        done = (g > 0.45) | (np.arange(20)[:, None] + 1 >= nvin[None])
        stop = int(np.argmax(np.cumsum(done, 0).astype(bool).all(1))) \
            if early else 19
        assert (not early) or stop < 19
        for a, r in zip(ours, (mel_j, attn_j, gates_j)):
            np.testing.assert_allclose(a.numpy()[:stop + 1],
                                       np.asarray(r)[:stop + 1], atol=1e-5)
        if early:
            assert (ours[0][stop + 1:] == 0).all()
            assert (ours[1][stop + 1:] == 0).all()
            assert (ours[2][stop + 1:] == 1).all()


H100_OPTIN = 232448    # an H100's opt-in shared memory a block (bytes)
FLAGSHIP_RES = dict(M=80, H=1024, D=640, n_layers=2, n_dense=2,
                    n_blocks=132)


def _quad_bytes(rp):
    """Every (stage, job, block)'s quads and their bytes in the K1 pack."""
    for s, st in enumerate(rp.kplan.stages):
        for j, bnd in enumerate(st.bounds):
            for b in range(rp.kplan.n_blocks):
                yield s, j, b, bnd[b + 1] - bnd[b], 4 * rp.row_bytes[s][j]


class TestResidentPlan:
    """k1_resident_plan / k1_resident_layout / k1_pack: where the bf16
    body's rows lie, at flagship widths on 132 blocks of an H100."""

    @pytest.mark.parametrize("B", [1, 4, 8])
    def test_each_quad_resident_or_streamed_within_the_budget(self, B):
        rp = k1_resident_plan(B, smem_bytes=H100_OPTIN, **FLAGSHIP_RES)
        assert rp.budget == (H100_OPTIN - K1_BF16_STATIC
                             - k1_fixed_bytes(B, 80, 1024, 640, 2))
        res = [0] * 132
        for s, j, b, n, qb in _quad_bytes(rp):
            assert 0 <= rp.nres[s][j][b] <= n
            res[b] += rp.nres[s][j][b] * qb
        assert tuple(res) == rp.res_bytes
        for b in range(132):
            # the resident rows and the ring share the block's budget
            assert 0 < rp.res_bytes[b] and rp.res_bytes[b] + rp.ring[b] \
                <= rp.budget
            for s in range(len(rp.kplan.stages)):
                # water-filled: every stage's streamed rows fit the ring
                assert rp.ring_bytes[s][b] == rp.stream_bytes[s][b] \
                    <= rp.ring[b]
        total = sum(n * qb for *_, n, qb in _quad_bytes(rp))
        assert sum(rp.res_bytes) + sum(map(sum, rp.stream_bytes)) == total
        # in the layout every quad lies once: resident or streamed
        tab, chunks, stream_offset = k1_resident_layout(rp)
        seen = {}
        for s, j, q0, n in chunks:
            for q in range(q0, q0 + n):
                key = (s, j, q)
                assert key not in seen
                seen[key] = 1
        quads = {(s, j, q) for s, st in enumerate(rp.kplan.stages)
                 for j, bnd in enumerate(st.bounds) for q in range(bnd[-1])}
        assert set(seen) == quads
        assert stream_offset == sum(rp.res_bytes)

    def test_groups_past_eight_rows_reuse_the_plan_and_b8_keeps_less(self):
        assert k1_fixed_bytes(12, 80, 1024, 640, 2) \
            == k1_fixed_bytes(8, 80, 1024, 640, 2)
        r1, r8 = (sum(k1_resident_plan(B, smem_bytes=H100_OPTIN,
                                       **FLAGSHIP_RES).res_bytes)
                  for B in (1, 8))
        assert r8 < r1

    def test_streamed_rows_of_a_flow_are_one_range(self):
        rp = k1_resident_plan(1, smem_bytes=H100_OPTIN, **FLAGSHIP_RES)
        tab, chunks, stream_offset = k1_resident_layout(rp)
        end = stream_offset + sum(map(sum, rp.stream_bytes))
        for st_tab in tab:
            for b, t in enumerate(st_tab):
                # each block's resident rows below the streamed range
                assert t[14] + t[15] <= stream_offset
        ranges = sorted((t[12], t[12] + rp.stream_bytes[s][b])
                        for s, st_tab in enumerate(tab)
                        for b, t in enumerate(st_tab))
        assert ranges[0][0] == stream_offset and ranges[-1][1] == end
        for (_, e0), (s1, _) in zip(ranges, ranges[1:]):
            assert e0 == s1          # no gap, no overlap

    def test_fp32_pack_gets_no_residency(self, case, monkeypatch):
        """pack_flow_weights where a K1 target exists (stood in for the
        card): an fp32 pack keeps its matrices and no K1 pack, and
        k1_bytes (k1_launch_info's) finds nothing resident: every frame
        streams all its packed matrices."""
        monkeypatch.setattr(k1_module, "k1_target",
                            lambda dev: (3, H100_OPTIN))
        w = pack_flow_weights(case[1])
        assert "k1" not in w and w["att_wi"].dtype == torch.float32
        mats = sum(t.numel() * 4 for t in _job_matrices(w).values())
        for B in (1, 8):
            got = k1_bytes(w, B)
            assert got["resident_bytes"] == 0
            assert got["streamed_bytes_per_frame"] == got["packed_bytes"] \
                == mats

    def test_bf16_pack_holds_its_k1_packs_by_layout(self, case,
                                                     monkeypatch):
        """A bf16 pack where a K1 target exists (stood in for the card, its
        shared memory cut so that the plans differ with B): its matrices
        only as K1 packs, one for each layout the plans at B = 1 .. 8 need,
        B > 8 on B=8's; resident plus streamed bytes equal the pack
        tensor's; the plain version on it bitwise the plain version on
        the matrices."""
        _, flow, residual, text, key_mask = case
        f16 = to_bf16(copy.deepcopy(flow))
        dims = dict(M=8, H=16, D=8, n_layers=2, n_dense=2, n_blocks=3)
        smem = K1_BF16_STATIC + k1_fixed_bytes(8, 8, 16, 8, 2) + 4096
        monkeypatch.setattr(k1_module, "k1_target", lambda dev: (3, smem))
        w = pack_flow_weights(f16)
        monkeypatch.setattr(k1_module, "k1_target", lambda dev: None)
        plain = pack_flow_weights(f16)
        assert "k1" not in plain
        assert w["att_wi"] is None and len(w["k1"]) == 1
        assert all(wi is None and wh is None for wi, wh, _ in w["lstm"])
        layouts = {}
        for B in (1, 2, 3, 4, 5, 6, 7, 8, 12):
            k1 = k1_pack_for(w, B)
            rp = k1_resident_plan(min(B, 8), smem_bytes=smem, **dims)
            assert k1.plan == rp
            layouts.setdefault((rp.nres, rp.ring), set()).add(
                k1.pack.data_ptr())
            got = k1_bytes(w, B)
            assert got["packed_bytes"] == k1.pack.numel() * 2
            assert got["resident_bytes"] == sum(rp.res_bytes) > 0
            assert got["resident_bytes"] + got["streamed_bytes_per_frame"] \
                == got["packed_bytes"]
        # one pack a layout, and the budget cut made more than one
        assert all(len(ptrs) == 1 for ptrs in layouts.values())
        assert len(w["k1"]) == len(layouts) > 1
        for k1 in w["k1"].values():
            for name, m in k1_unpack(k1).items():
                assert torch.equal(m, _job_matrices(plain)[name])
        args = (_t(residual).to(torch.bfloat16), *self._kv(f16, text),
                _t(key_mask.astype(np.float32)), 1.0)
        for a, b in zip(fused_flow_infer_reference(w, *args),
                        fused_flow_infer_reference(plain, *args)):
            assert torch.equal(a, b)

    @staticmethod
    def _kv(flow, text):
        from flowtron_tpu_torch.models.attention import attention_precompute
        t = _t(text).to(torch.bfloat16)
        with torch.no_grad():
            return attention_precompute(flow.attention_layer, t, t)

    def test_no_room_keeps_nothing_resident_and_streams_past_the_ring(self):
        fixed = k1_fixed_bytes(3, 8, 16, 8, 2)
        rp = k1_resident_plan(3, 8, 16, 8, 2, 2, 1,
                              K1_BF16_STATIC + fixed + 1000)
        assert sum(rp.res_bytes) == 0 and rp.ring == (1000,)
        assert all(r <= 1000 for st in rp.ring_bytes for r in st)
        assert sum(map(sum, rp.ring_bytes)) < sum(map(sum, rp.stream_bytes))

    @pytest.mark.parametrize("B,dims,n_blocks", [
        (3, dict(M=8, H=16, D=8), 3), (3, dict(M=8, H=16, D=8), 132),
        (8, dict(M=80, H=1024, D=640), 132)],
        ids=["toy_3", "toy_132", "flagship_B8"])
    def test_pack_rows_lie_where_the_kernel_reads_them(self, B, dims,
                                                       n_blocks):
        """csrc/decoder.cu:row_at on the table: every row of every quad,
        padded with zeros to its stride, where the kernel reads it."""
        M, H, D = dims["M"], dims["H"], dims["D"]
        g = torch.Generator().manual_seed(0)

        def mat(r, k):
            return torch.randn(r, -(-k // 8) * 8,
                               generator=g).to(torch.bfloat16)
        w = {"att_wi": mat(4 * H, M), "att_wh": mat(4 * H, H),
             "q_w": mat(D, H), "head_w": mat(2 * M, H),
             "lstm": [(mat(4 * H, H + D if l == 0 else H), mat(4 * H, H),
                       None) for l in range(2)],
             "dense": [(mat(H, H), None) for _ in range(2)]}
        rp = k1_resident_plan(B, M, H, D, 2, 2, n_blocks, H100_OPTIN)
        mats = _job_matrices(w)
        k1 = k1_pack(mats, rp)
        pack, stream_offset = k1.pack, k1_resident_layout(rp)[2]
        tab = k1.table.view(len(rp.kplan.stages), n_blocks, _TAB).tolist()
        for s, j, b, n, _ in _quad_bytes(rp):
            name, rows, _ = rp.kplan.stages[s].jobs[j]
            W, ws = mats[name], rp.row_bytes[s][j]
            t = tab[s][b]
            lo = rp.kplan.stages[s].bounds[j][b]
            for l in range(n):
                for r in range(4):
                    if l < t[j]:
                        off = t[14] + t[4 + j] + (4 * l + r) * ws
                        assert t[4 + j] + (4 * l + r + 1) * ws <= t[15]
                    else:
                        off = t[12] + t[8 + j] + (4 * (l - t[j]) + r) * ws
                        assert off >= stream_offset
                    row = pack[off // 2:(off + ws) // 2]
                    want = (W[4 * (lo + l) + r] if 4 * (lo + l) + r < rows
                            else torch.zeros(W.shape[1], dtype=W.dtype))
                    assert torch.equal(row[:W.shape[1]], want)
                    assert not row[W.shape[1]:].any()
        # and k1_unpack gives the matrices back
        back = k1_unpack(k1)
        assert all(torch.equal(back[n], m) for n, m in mats.items())


def _bf16_rnd(t):
    return t.to(torch.bfloat16).float()


def _tile_ks(kplan, n_blocks):
    """Each job's rows' k-parts in the bf16 body: a block with nu < 8
    m-tiles (four quads of one job) in a stage splits each m-tile's
    stretches over 8 // nu warps."""
    ks = {}
    for st in kplan.stages:
        per_block = []
        for b in range(n_blocks):
            nu = sum(-(-(bnd[b + 1] - bnd[b]) // 4) for bnd in st.bounds)
            per_block.append(1 if nu >= 8 or nu == 0 else 8 // nu)
        for (name, rows, _), bnd in zip(st.jobs, st.bounds):
            ks[name] = [per_block[b] for b in range(n_blocks)
                        for _ in range(4 * (bnd[b + 1] - bnd[b]))][:rows]
    return ks


def _mma_dot(x, W, ks_rows):
    """x (B, K) . W (R, K)^T in the bf16 body's order of sums: k in
    stretches of 32 (rows padded with zeros); a stretch is two m16n8k16
    tiles (elements 0-3, 8-11, 16-19, 24-27 and the rest: each lane's 16
    bytes give two elements to each), each tile's 16 exact products summed
    from zero in fp32; a k-part takes every ks-th stretch, its i-th
    stretch into chain i % 4 by two rounded adds; the chains summed in
    order, then the parts."""
    B = x.shape[0]
    R = W.shape[0]
    kp = -(-max(x.shape[1], W.shape[1]) // 32) * 32
    x = F.pad(x, (0, kp - x.shape[1]))
    W = F.pad(W, (0, kp - W.shape[1]))
    ns = kp // 32
    prod = (x[:, None, :] * W[None]).view(B, R, ns, 4, 8)
    p0 = prod[..., :4].sum((-1, -2))
    p1 = prod[..., 4:].sum((-1, -2))
    out = x.new_zeros(B, R)
    for ks in sorted(set(ks_rows)):
        rows = [r for r in range(R) if ks_rows[r] == ks]
        y = None
        for part in range(ks):
            acc = [x.new_zeros(B, len(rows)) for _ in range(4)]
            for i, s in enumerate(range(part, ns, ks)):
                acc[i % 4] = (acc[i % 4] + p0[:, rows, s]) + p1[:, rows, s]
            c = ((acc[0] + acc[1]) + acc[2]) + acc[3]
            y = c if y is None else y + c
        out[:, rows] = y
    return out


def k1_bf16_emulated(weights, residual, k_proj, vals, key_mask,
                     temperature, n_blocks):
    """The bf16 body (csrc/decoder.cu) in plain PyTorch: the dots in its
    order of sums (``_mma_dot``, each row's k-parts from its block), the
    recurrent halves summed apart and added to the input half before the
    bias, attention in k1_attn_parts partials; bf16 roundings where the
    body rounds: the staged inputs, q, q + k and its tanh, the context."""
    w = _with_matrices(weights)
    N, B, M = residual.shape
    H = w["att_wh"].shape[0] // 4
    D = w["q_w"].shape[0]
    Tk = k_proj.shape[1]
    L = len(w["lstm"])
    kplan = k1_plan(B, M, H, D, L, len(w["dense"]), n_blocks)
    ks = _tile_ks(kplan, n_blocks)
    mats = {k: v.float() for k, v in _job_matrices(w).items()}
    parts = k1_attn_parts(B, Tk, n_blocks)
    residual = _bf16_rnd(residual.float())
    kp, vl = k_proj.float(), vals.float()

    def dot(name, x):
        return _mma_dot(_bf16_rnd(x), mats[name], ks[name])

    def cell(ih, rec, bias, x, h, c):
        g = ((dot(ih, x) + dot(rec, h)) + bias).view(B, H, 4)
        c = torch.sigmoid(g[..., 1]) * c \
            + torch.sigmoid(g[..., 0]) * torch.tanh(g[..., 2])
        return torch.sigmoid(g[..., 3]) * torch.tanh(c), c

    mel = residual.new_zeros(N, B, M)
    attn = residual.new_zeros(N, B, Tk)
    gates = residual.new_zeros(N, B)
    zeros = residual.new_zeros(B, H)
    h_att = c_att = zeros
    hs, cs = [zeros] * L, [zeros] * L
    prev = residual.new_zeros(B, M)
    for t in range(N):
        h_att, c_att = cell("att_ih", "rec_att", w["att_b"], prev, h_att,
                            c_att)
        q = _bf16_rnd(dot("q", h_att) + w["q_b"])
        s = (_bf16_rnd(torch.tanh(_bf16_rnd(q[:, None, :] + kp)))
             * w["v_w"]).sum(-1)
        s = torch.where(key_mask > 0.5, s / temperature, -1e9)
        ms, es, cs_part = [], [], []
        for j in range(parts):
            k0, k1 = j * Tk // parts, (j + 1) * Tk // parts
            m = s[:, k0:k1].max(dim=1).values
            e = torch.exp(s[:, k0:k1] - m[:, None])
            ms.append(m)
            es.append(e.sum(dim=1))
            cs_part.append(torch.einsum("bk,bkd->bd", e, vl[:, k0:k1]))
        mx = torch.stack(ms).max(dim=0).values
        ssum = sum(e * torch.exp(m - mx) for m, e in zip(ms, es))
        ctx = _bf16_rnd(sum((torch.exp(m - mx) / ssum)[:, None] * c
                            for m, c in zip(ms, cs_part)))
        a = torch.exp(s - mx[:, None]) / ssum[:, None]
        x = torch.cat([_bf16_rnd(h_att), ctx], dim=-1)
        gate = torch.sigmoid(x @ w["gate_w"] + w["gate_b"])
        for k, (_, _, lb) in enumerate(w["lstm"]):
            hs[k], cs[k] = cell(f"ih_{k}", f"rec_{k}", lb, x, hs[k], cs[k])
            x = hs[k]
        for i, (_, db) in enumerate(w["dense"]):
            x = torch.tanh(dot(f"dense_{i}", x) + db)
        out2 = (dot("head", x) + w["head_b"]).view(B, M, 2)
        prev = (residual[t] - out2[..., 1]) * torch.exp(-out2[..., 0])
        mel[t], attn[t], gates[t] = prev, a, gate
    return mel, attn, gates


WIDE = dict(SMALL, n_hidden=64, n_attn_channels=32)


@pytest.fixture(scope="module")
def wide_case():
    p = ar_step_params(jax.random.PRNGKey(3), add_gate=True, **WIDE)
    rng = np.random.default_rng(4)
    for k in ("w", "b"):
        p["conv"][k] = jnp.asarray(0.05 * rng.standard_normal(
            p["conv"][k].shape).astype(np.float32))
    N, B, M, Tk = 20, 3, 8, 5
    residual = (rng.standard_normal((N, B, M)) * 0.5).astype(np.float32)
    text = rng.standard_normal((Tk, B, 16)).astype(np.float32)
    key_mask = np.arange(Tk)[None] < np.asarray([5, 3, 4])[:, None]
    return p, _torch_flow(p, WIDE), residual, text, key_mask


def _jax_to_bf16(tree):
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                        if a.dtype == jnp.float32 else a, tree)


class TestBf16OrderOfSums:
    @pytest.mark.parametrize("n_blocks", [3, 132])
    @pytest.mark.parametrize("which", ["small", "wide"])
    def test_emulation_matches_jax_bf16(self, case, wide_case, which,
                                        n_blocks):
        """The bf16 body's order of sums against JAX's bf16 K1 (Pallas
        in interpret mode) on the same bf16 pack: mel within 2e-2 of its
        scale (test_torch_port_bf16.py's bar), the same n_valid."""
        p, flow, residual, text, key_mask = (case if which == "small"
                                             else wide_case)
        pb = _jax_to_bf16(p)
        kp, vals = jax_attention_precompute(
            pb["attention_layer"], jnp.asarray(text, jnp.bfloat16),
            jnp.asarray(text, jnp.bfloat16))
        km = key_mask.astype(np.float32)
        mel_j, attn_j, gates_j = jax_fused(
            jax_pack(pb), jnp.asarray(residual, jnp.bfloat16), kp, vals,
            jnp.asarray(km), 1.0, interpret=True)

        def f32(a):
            return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
        w16 = pack_flow_weights(to_bf16(copy.deepcopy(flow)))
        mel, attn, gates = k1_bf16_emulated(
            w16, _t(residual), f32(kp).to(torch.bfloat16),
            f32(vals).to(torch.bfloat16), _t(km), 1.0, n_blocks)
        gj = f32(gates_j)
        nv = (gates > 0.45).int().argmax(0)
        assert torch.equal(nv, (gj > 0.45).int().argmax(0))
        ref = f32(mel_j)
        scale = float(ref.abs().max())
        err = float((mel - ref).abs().max())
        print(f"bf16 body emulated vs JAX bf16 K1 ({which}, {n_blocks} "
              f"blocks): mel {err:.3g} of scale {scale:.3g}")
        assert err <= 2e-2 * scale
        assert float((attn - f32(attn_j)).abs().max()) <= 2e-2


# the bf16 body against its emulated order of sums on the card: near fp32
# rounding (the emulation's exp, tanh and sigmoid are torch's, not the
# kernel's, and its attention sums in another order)
K1_EMU_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "python -m pytest tests/test_torch_port_*.py -m cuda")
    return torch.device("cuda")


def _bf16_kernel_on_card(case, dev):
    """K1's bf16 body: against its plain bf16 version the mel within 2e-3
    of its scale and the attention weights within 1.5e-3, and its mel's
    distance from the fp32 kernel's at most 1.5x the plain bf16 version's
    plus 1e-3 of the scale (early exit off); the same n_valid as the plain
    bf16 version and two calls bitwise equal (early exit off and on);
    against ``k1_bf16_emulated`` (its order of sums, which
    TestBf16OrderOfSums holds against JAX) on the same pack and blocks,
    the mel and attention within K1_EMU_TOL of the mel's scale; B=3 with
    a key mask, B=8 (one full group of rows) and B=12 (two groups) with
    random text and key masks, and B=8 with a text of 2100 keys (a slot
    past the scores kept in shared memory)."""
    from flowtron_tpu_torch.models.attention import attention_precompute
    _, flow, residual, text, key_mask = case
    f32 = copy.deepcopy(flow).to(dev)
    f16 = to_bf16(copy.deepcopy(flow)).to(dev)
    rng = np.random.default_rng(8)
    inputs = [(residual, text, key_mask)]
    for B, Tk in ((8, 5), (12, 5), (8, 2100)):
        inputs.append(((rng.standard_normal((20, B, 8)) * 0.5)
                       .astype(np.float32),
                       rng.standard_normal((Tk, B, 16)).astype(np.float32),
                       np.arange(Tk)[None] < rng.integers(1, Tk + 1, (B, 1))))
    for res_np, text_np, mask_np in inputs:
        km = _t(mask_np.astype(np.float32)).to(dev)
        outs = {}
        for tag, f, dt in (("fp32", f32, torch.float32),
                           ("bf16", f16, torch.bfloat16)):
            t_dev = _t(text_np).to(dev, dt)
            with torch.no_grad():
                kp, vals = attention_precompute(f.attention_layer, t_dev,
                                                t_dev)
            outs[tag] = (f.packed_weights(), _t(res_np).to(dev, dt), kp,
                         vals, km, 1.0)
        for early in (False, True):
            kw = dict(early_exit=early, gate_threshold=0.45)
            ref32 = fused_flow_infer(*outs["fp32"], **kw)
            ours = fused_flow_infer(*outs["bf16"], **kw)
            again = fused_flow_infer(*outs["bf16"], **kw)
            plain = fused_flow_infer_reference(*outs["bf16"], **kw)
            assert all(torch.equal(a, b) for a, b in zip(ours, again))
            nv = (ours[2] > 0.45).int().argmax(0)
            assert torch.equal(nv, (plain[2] > 0.45).int().argmax(0))
            if early:       # past its stop each run writes zeros of its own
                continue
            scale = float(ref32[0].abs().max())
            e_mel = float((ours[0] - plain[0]).abs().max())
            e_attn = float((ours[1] - plain[1]).abs().max())
            print(f"K1 bf16 B={res_np.shape[1]} vs plain bf16: mel {e_mel} "
                  f"(scale {scale}), attn {e_attn}")
            assert e_mel <= 2e-3 * scale and e_attn <= 1.5e-3, (e_mel,
                                                                e_attn)
            e_k = float((ours[0] - ref32[0]).abs().max())
            e_p = float((plain[0] - ref32[0]).abs().max())
            assert e_k <= 1.5 * e_p + 1e-3 * scale, (e_k, e_p)
            emu = k1_bf16_emulated(*outs["bf16"], n_blocks=k1_blocks(dev))
            e_emu = [float((a - b).abs().max()) for a, b in zip(ours, emu)]
            print(f"K1 bf16 B={res_np.shape[1]} Tk={text_np.shape[0]} vs "
                  f"its emulated order of sums: mel {e_emu[0]}, attn "
                  f"{e_emu[1]}, gate {e_emu[2]}")
            assert max(e_emu[:2]) <= K1_EMU_TOL * scale, e_emu


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_plain_on_card(case, cuda_device, dtype):
    if dtype == torch.bfloat16:
        _bf16_kernel_on_card(case, cuda_device)
        return
    _, flow, residual, text, key_mask = case
    flow = flow.to(cuda_device)
    from flowtron_tpu_torch.models.attention import attention_precompute
    with torch.no_grad():
        kp, vals = attention_precompute(flow.attention_layer,
                                        _t(text).to(cuda_device),
                                        _t(text).to(cuda_device))
    args = (flow.packed_weights(), _t(residual).to(cuda_device), kp, vals,
            _t(key_mask.astype(np.float32)).to(cuda_device), 1.0)
    # B=12: two groups of batch rows; one row's n_valid_in ends it early
    rng = np.random.default_rng(12)
    text12 = _t(rng.standard_normal((5, 12, 16)).astype(np.float32))
    with torch.no_grad():
        kp12, vals12 = attention_precompute(flow.attention_layer,
                                            text12.to(cuda_device),
                                            text12.to(cuda_device))
    args12 = (args[0], _t((rng.standard_normal((20, 12, 8)) * 0.5)
                          .astype(np.float32)).to(cuda_device), kp12, vals12,
              _t((np.arange(5)[None] < rng.integers(1, 6, (12, 1)))
                 .astype(np.float32)).to(cuda_device), 1.0)
    nv12 = torch.full((12,), 20, dtype=torch.int32, device=cuda_device)
    nv12[7] = 6
    for a_, nv in ((args, None), (args12, nv12)):
        for early in (False, True):
            kw = dict(early_exit=early, gate_threshold=0.45, n_valid_in=nv)
            ours = fused_flow_infer(*a_, **kw)
            again = fused_flow_infer(*a_, **kw)
            ref = fused_flow_infer_reference(*a_, **kw)
            for a, b, r in zip(ours, again, ref):
                torch.testing.assert_close(a, r, atol=1e-5, rtol=0)
                assert torch.equal(a, b)
    # a prior is outside K1's subset: the flow runs the per-frame loop on
    # the card, as JAX falls back to its scan, and K1 is not launched
    prior = torch.full((3, 20, 5), 0.2)
    launches = fused_flow_infer.launches
    with torch.no_grad():
        mel_card, _, nv_card = ar_step_infer(
            flow, args[1], _t(text).to(cuda_device),
            attn_prior=prior.to(cuda_device))
        assert fused_flow_infer.launches == launches
        mel_cpu, _, nv_cpu = ar_step_infer(flow.cpu(), args[1].cpu(),
                                           _t(text), attn_prior=prior)
    torch.testing.assert_close(mel_card.cpu(), mel_cpu, atol=1e-4, rtol=0)
    assert torch.equal(nv_card.cpu(), nv_cpu)
