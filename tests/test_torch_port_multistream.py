"""The port's multistream mux (flowtron_tpu_torch/infer/multistream.py) on
the CPU at toy widths (``SMALL`` flows, the ``TINY_WG`` vocoder, chunks of
8 frames, context 8, lookahead 4, at most 48 frames).

- Against JAX's ``MultiStreamTTS``, the port fed JAX's own draws through
  ``open(residual=, latents=)``: audio within 1e-4 of its scale, n_valid
  identical; one flow with ragged gates and a mid-run join, two flows
  with the prelude and per-slot temperatures.
- Against the port's solo stream (``pump_stream`` over a
  ``StreamingMelSynthesizer`` and a ``StreamingVocoder`` with the same
  seed), within 1e-5 of the scale: ragged gates, a join mid-run, slot
  reuse, per-slot temperature, rush admission (K joins a tick), caps, and
  a lane's audio whatever the size of its vocoder group.
- Lifecycle: ``MuxFull``, ``close``, a close before the join commits
  (``MuxClosed``, the slot freed), text too long, handles unique across
  slot reuse.
- Routing: a tick never reaches kernel K1's wrapper; each join's prelude
  does, once.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from flowtron_tpu.infer import multistream as jax_multistream  # noqa: E402
from flowtron_tpu.infer import streaming as jax_streaming  # noqa: E402

from flowtron_tpu_torch.infer import multistream  # noqa: E402
from flowtron_tpu_torch.infer.multistream import (  # noqa: E402
    MultiStreamTTS, MuxClosed, MuxFull,
)
from flowtron_tpu_torch.infer.streaming import (  # noqa: E402
    StreamingMelSynthesizer, StreamingVocoder, pump_stream,
    stream_generators,
)
from flowtron_tpu_torch.models import ar_step as port_ar_step  # noqa: E402
from tests.test_torch_port_streaming import (  # noqa: E402
    _pair, _t, wg,  # noqa: F401 - the vocoder fixture
)

GEO = dict(chunk_frames=8, context=8, lookahead=4)
MAXF = 48
TK = 12
M = 8


@pytest.fixture(scope="module")
def one_flow():
    return _pair(1, 1)


@pytest.fixture(scope="module")
def two_flows():
    return _pair(2, 7)


def _streams(n, seed, base_len, step=1):
    rng = np.random.default_rng(seed)
    return [(i % 2, rng.integers(1, 185, (base_len + step * i,)))
            for i in range(n)]


def _mux(port, wg_port, slots, thr, max_frames=MAXF, **kw):
    (model, cfg), (wg_model, wg_cfg) = port, wg_port
    return MultiStreamTTS(model, cfg, wg_model, wg_cfg, slots=slots,
                          text_len=TK, max_frames=max_frames,
                          gate_threshold=thr, **GEO, **kw)


def _solo(port, wg_port, seed, sid, ids, thr, temperature=1.0, cap=None):
    """The B=1 pipeline with the mux's settings: text padded to TK with
    its length, the same generators and geometry. Returns (audio,
    n_valid)."""
    (model, cfg), (wg_model, wg_cfg) = port, wg_port
    g_mel, g_voc = stream_generators(seed)
    mel_s = StreamingMelSynthesizer(model, cfg, chunk_frames=8,
                                    gate_threshold=thr, max_frames=MAXF,
                                    temperature=temperature)
    voc = StreamingVocoder(wg_model, wg_cfg, context=8, lookahead=4,
                           max_frames=MAXF, generator=g_voc)
    text = torch.zeros(1, TK, dtype=torch.long)
    text[0, :len(ids)] = torch.as_tensor(ids)
    chunks = list(pump_stream(mel_s, voc, g_mel, torch.tensor([sid]), text,
                              in_lens=torch.tensor([len(ids)]),
                              max_frames=cap))
    audio = np.concatenate([c[0] for c in chunks]) if chunks \
        else np.zeros((0,), np.float32)
    return audio, int(mel_s.n_valid[0])


def _ticks(mux, n, out, done):
    """``n`` ticks, each stream's audio appended to ``out`` and finished
    handles added to ``done``."""
    for _ in range(n):
        for h, audio, fin in mux.step():
            out.setdefault(h, []).append(audio)
            if fin:
                done.add(h)


def _drain(mux, handles, out=None, done=None, max_ticks=64):
    """Tick until every handle is done; returns {handle: audio}."""
    out = {} if out is None else out
    done = set() if done is None else done
    for _ in range(max_ticks):
        if done >= set(handles) and mux.active == 0:
            break
        _ticks(mux, 1, out, done)
    assert done >= set(handles), (done, handles)
    return {h: np.concatenate(out.get(h, [np.zeros((0,), np.float32)]))
            for h in handles}


def _close(got, want, tol):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())


# -- against JAX's MultiStreamTTS -------------------------------------------
def _jax_draws(key, n_flows, cfg, max_frames=MAXF):
    """What JAX's mux draws for a stream of ``key``: flow 0's latents (one
    (C, 1, M) draw a chunk for one flow, the whole (1, M, max_frames) for
    two)
    as the port's (1, M, N) ``residual``, and its vocoder latents as a
    source."""
    k_mel, k_voc = jax.random.split(key)
    if n_flows == 1:
        z = jnp.concatenate([0.5 * jax.random.normal(
            jax.random.fold_in(k_mel, c), (8, 1, M))
            for c in range(max_frames // 8)])
        residual = np.transpose(np.asarray(z), (1, 2, 0))
    else:
        residual = np.asarray(0.5 * jax.random.normal(k_mel,
                                                      (1, M, max_frames)))

    def source(start, n):
        z_main, z_early = jax_streaming.positional_z(k_voc, cfg, 1, start,
                                                     n, 0.8)
        return _t(z_main), [None if z is None else _t(z) for z in z_early]
    return _t(residual), source


def _both(jax_pair, port_pair, wg, slots, thr, opens, late=(), at_tick=2,
          max_frames=MAXF):
    """Run JAX's mux and the port's over the same streams: ``opens`` (key
    seed, sid, ids, temperature) join first, ``late`` ones after
    ``at_tick`` ticks; both capped at ``max_frames``. Returns each run's
    audio, in the streams' order."""
    (params, cfg), (wg_params, wg_cfg) = jax_pair, wg[0]
    jm = jax_multistream.MultiStreamTTS(
        params, cfg, wg_params, wg_cfg, slots=slots, text_len=TK,
        max_frames=max_frames, gate_threshold=thr, **GEO)
    pm = _mux(port_pair, wg[1], slots, thr, max_frames)
    runs = []
    for mux, is_jax in ((jm, True), (pm, False)):
        def open_(k, sid, ids, temp):
            key = jax.random.PRNGKey(k)
            if is_jax:
                return mux.open(key, sid, ids, temperature=temp)
            residual, source = _jax_draws(key, cfg["n_flows"], wg_cfg,
                                          max_frames)
            return mux.open(k, sid, ids, temperature=temp,
                            residual=residual, latents=source)
        hs = [open_(*s) for s in opens]
        out, done = {}, set()
        _ticks(mux, at_tick, out, done)
        hs += [open_(*s) for s in late]
        got = _drain(mux, hs, out, done)
        runs.append([got[h] for h in hs])
    return runs


def test_one_flow_ragged_gates_and_late_join_match_jax(one_flow, wg):
    """Gates at 4, 23 and the 48-frame cap (on JAX's draws); the third
    stream joins after two ticks."""
    ss = _streams(3, 0, 4, 2)
    opens = [(10 + i, sid, ids, 1.0) for i, (sid, ids) in enumerate(ss)]
    jaxs, port = _both(*one_flow, wg, 3, 0.57, opens[:2], opens[2:])
    assert sorted(len(a) // 256 for a in port) == [4, 23, 48]
    for p, j in zip(port, jaxs):
        assert len(p) == len(j)                   # n_valid identical
        _close(p, j, 1e-4)


def test_two_flows_prelude_and_temperature_match_jax(two_flows, wg):
    """The prelude at each join (gates at 22, 15 and the cap); the first
    stream again at temperature 1.7 in a lane of its own, joining late:
    it differs from the 1.0 lane."""
    ss = _streams(3, 1, 5)
    opens = [(50 + i, sid, ids, 1.0) for i, (sid, ids) in enumerate(ss)]
    opens.append((50, ss[0][0], ss[0][1], 1.7))
    jaxs, port = _both(*two_flows, wg, 4, 0.59, opens[:3], opens[3:])
    assert sorted(len(a) // 256 for a in port[:3]) == [15, 22, 48]
    for p, j in zip(port, jaxs):
        assert len(p) == len(j)
        _close(p, j, 1e-4)
    assert len(port[0]) == len(port[3])
    assert np.abs(port[0] - port[3]).max() > 0


# -- against the port's solo stream -----------------------------------------
def test_ragged_gates_match_solo(one_flow, wg):
    port = one_flow[1], wg[1]
    ss = _streams(4, 0, 4, 2)
    mux = _mux(*port, 4, 0.5)
    hs = [mux.open(100 + i, sid, ids) for i, (sid, ids) in enumerate(ss)]
    got = _drain(mux, hs)
    nvs = []
    for i, (h, (sid, ids)) in enumerate(zip(hs, ss)):
        want, nv = _solo(*port, 100 + i, sid, ids, 0.5)
        nvs.append(nv)
        assert len(got[h]) == nv * 256
        _close(got[h], want, 1e-5)
    assert len(set(nvs)) > 2 and any(8 < n < MAXF for n in nvs), nvs


def test_join_mid_run_and_caps_match_solo(two_flows, wg):
    """B joins after A has run two ticks; C has a 13-frame cap."""
    port = two_flows[1], wg[1]
    (sa, ia), (sb, ib), (sc, ic) = _streams(3, 2, 6, 3)
    mux = _mux(*port, 3, 0.59)
    ha = mux.open(1, sa, ia)
    hc = mux.open(3, sc, ic, max_frames=13)
    out, done = {}, set()
    _ticks(mux, 2, out, done)
    assert set(out) <= {ha, hc}
    hb = mux.open(2, sb, ib)
    got = _drain(mux, [ha, hb, hc], out, done)
    for h, seed, sid, ids, cap in ((ha, 1, sa, ia, None),
                                   (hb, 2, sb, ib, None),
                                   (hc, 3, sc, ic, 13)):
        want, nv = _solo(*port, seed, sid, ids, 0.59, cap=cap)
        assert len(got[h]) == nv * 256
        _close(got[h], want, 1e-5)
    assert len(got[hc]) == 13 * 256


def test_slot_reuse_matches_solo_with_unique_handles(one_flow, wg):
    """One slot hosts three streams in turn: each equals its solo run
    (the carry rows start from zero), and no handle repeats."""
    port = one_flow[1], wg[1]
    mux = _mux(*port, 1, 0.5)
    handles = []
    for i, (sid, ids) in enumerate(_streams(3, 3, 5)):
        h = mux.open(200 + i, sid, ids)
        handles.append(h)
        want, _ = _solo(*port, 200 + i, sid, ids, 0.5)
        _close(_drain(mux, [h])[h], want, 1e-5)
    assert len(set(handles)) == 3


def test_per_slot_temperature_matches_solo(two_flows, wg):
    port = two_flows[1], wg[1]
    sid, ids = _streams(1, 4, 6)[0]
    mux = _mux(*port, 2, 0.59)
    hot = mux.open(7, sid, ids, temperature=1.7)
    std = mux.open(7, sid, ids, temperature=1.0)
    got = _drain(mux, [hot, std])
    _close(got[hot], _solo(*port, 7, sid, ids, 0.59, 1.7)[0], 1e-5)
    _close(got[std], _solo(*port, 7, sid, ids, 0.59, 1.0)[0], 1e-5)
    assert np.abs(got[hot] - got[std]).max() > 0


def test_rush_admission_joins_k_per_tick_same_audio(one_flow, wg):
    """max_joins_per_tick=1: open() only reserves; each tick commits one
    more join, oldest first; every stream's audio is its solo run's."""
    port = one_flow[1], wg[1]
    ss = _streams(3, 0, 4, 2)
    mux = _mux(*port, 4, 0.5, max_joins_per_tick=1)
    hs = [mux.open(300 + i, sid, ids) for i, (sid, ids) in enumerate(ss)]

    def joined():
        with mux._lock:
            return sum(s is not None and s.joined for s in mux._slots)

    assert mux.active == 3 and joined() == 0 and mux.has_work
    out, done = {}, set()
    for tick in range(64):
        for h, audio, fin in mux.step():
            out.setdefault(h, []).append(audio)
            if fin:
                done.add(h)
        if tick < 3:
            assert joined() + len(done) == tick + 1, tick
        if done >= set(hs):
            break
    for i, (h, (sid, ids)) in enumerate(zip(hs, ss)):
        want, _ = _solo(*port, 300 + i, sid, ids, 0.5)
        _close(np.concatenate(out[h]), want, 1e-5)


def test_lane_audio_independent_of_group_size(two_flows, wg, monkeypatch):
    """A stream vocoded alone and in groups of three: the same audio."""
    port = two_flows[1], wg[1]
    sizes = []
    window = MultiStreamTTS._window_audio

    def spy(self, members, W):
        sizes.append(len(members))
        return window(self, members, W)
    monkeypatch.setattr(MultiStreamTTS, "_window_audio", spy)
    ss = _streams(3, 5, 6)
    alone = _mux(*port, 3, 1e6)
    h = alone.open(400, *ss[0])
    solo_audio = _drain(alone, [h])[h]
    assert max(sizes) == 1
    sizes.clear()
    together = _mux(*port, 3, 1e6)
    hs = [together.open(400 + i, sid, ids) for i, (sid, ids) in
          enumerate(ss)]
    got = _drain(together, hs)
    assert min(sizes) == 3
    _close(got[hs[0]], solo_audio, 1e-5)


# -- lifecycle ---------------------------------------------------------------
def test_mux_full_and_close(one_flow, wg):
    port = one_flow[1], wg[1]
    ss = _streams(3, 6, 5)
    mux = _mux(*port, 2, 1e6)
    h = [mux.open(i, sid, ids) for i, (sid, ids) in enumerate(ss[:2])]
    with pytest.raises(MuxFull):
        mux.open(9, *ss[2])
    mux.step()
    mux.close(h[0])
    assert mux.active == 2          # freed at the next tick
    events = mux.step()
    assert mux.active == 1 and all(e[0] == h[1] for e in events)
    assert mux.n_valid_of(h[0]) is None
    h2 = mux.open(9, *ss[2])
    assert mux.active == 2 and h2 not in h
    mux.close(h[1])
    mux.close(h2)
    assert mux.step() == [] and mux.active == 0 and not mux.has_work


def test_close_before_commit_raises_and_frees_the_slot(two_flows, wg,
                                                       monkeypatch):
    """A close that lands while open() still runs the join: open() raises
    MuxClosed and the slot is free. With deferred joins, a stream closed
    before its join commits never emits and frees its slot."""
    port = two_flows[1], wg[1]
    (s0, i0), (s1, i1) = _streams(2, 7, 5)
    mux = _mux(*port, 1, 1e6)
    prelude = multistream.run_prelude

    def racing_prelude(*a, **k):
        mux.close(mux._next_handle - 1)
        mux.step()                    # the tick frees the closed slot
        return prelude(*a, **k)
    monkeypatch.setattr(multistream, "run_prelude", racing_prelude)
    with pytest.raises(MuxClosed):
        mux.open(1, s0, i0)
    assert mux.active == 0
    monkeypatch.setattr(multistream, "run_prelude", prelude)
    h = mux.open(2, s1, i1)
    assert len(_drain(mux, [h])[h]) == MAXF * 256

    deferred = _mux(*port, 2, 1e6, max_joins_per_tick=1)
    ha = deferred.open(3, s0, i0)
    hb = deferred.open(4, s1, i1)
    deferred.close(hb)
    seen = {h for _ in range(3) for h, _a, _d in deferred.step()}
    assert hb not in seen and ha in seen and deferred.active == 1


def test_text_too_long_and_empty(one_flow, wg):
    mux = _mux(one_flow[1], wg[1], 1, 0.5)
    with pytest.raises(ValueError, match="text_len"):
        mux.open(0, 0, np.ones((TK + 1,), np.int64))
    with pytest.raises(ValueError, match="empty"):
        mux.open(0, 0, np.ones((0,), np.int64))
    assert mux.active == 0


def test_failed_join_frees_its_slot(two_flows, wg, monkeypatch):
    """A join that raises (here the prelude) frees the slot it reserved;
    a residual longer than max_frames is refused before any slot."""
    port = two_flows[1], wg[1]
    mux = _mux(*port, 1, 1e6)

    def boom(*a, **k):
        raise RuntimeError("prelude failed")
    monkeypatch.setattr(multistream, "run_prelude", boom)
    with pytest.raises(RuntimeError, match="prelude failed"):
        mux.open(0, 0, np.ones((4,), np.int64))
    assert mux.active == 0 and not mux.has_work
    with pytest.raises(ValueError, match="max_frames"):
        mux.open(0, 0, np.ones((4,), np.int64),
                 residual=torch.zeros(1, M, MAXF + 1))
    assert mux.active == 0


def test_warmup_runs_a_throwaway_stream(one_flow, wg):
    mux = _mux(one_flow[1], wg[1], 2, 1e6)
    mux.warmup()
    assert mux.active == 0 and mux._carry is not None


# -- routing -----------------------------------------------------------------
def test_ticks_never_reach_k1_and_each_prelude_does(two_flows, wg,
                                                    monkeypatch):
    """fused=True (on the CPU, K1's plain version for a flow in its
    subset): each join's prelude reaches K1's wrapper once (the one flow
    before flow 0, a scalar temperature); no tick reaches it."""
    calls = []
    k1 = port_ar_step.fused_flow_infer

    def spy(*a, **k):
        calls.append(1)
        return k1(*a, **k)
    monkeypatch.setattr(port_ar_step, "fused_flow_infer", spy)
    port = two_flows[1], wg[1]
    ss = _streams(2, 8, 5)
    mux = _mux(*port, 2, 1e6, fused=True)
    hs = [mux.open(500 + i, sid, ids) for i, (sid, ids) in enumerate(ss)]
    assert len(calls) == 2
    _drain(mux, hs)
    assert len(calls) == 2
