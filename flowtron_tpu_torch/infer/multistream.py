"""Batched multistream synthesis: N concurrent streams as the N lanes of
one batched frame loop (port of flowtron_tpu/infer/multistream.py).

A stream on its own (infer/streaming.py) runs flow 0's per-frame loop at
B=1: about 40 eager launches a frame, host-bound on the card, so N
streams cost N times the launches. The multiplexer advances every active
stream with one loop over all ``slots`` lanes a tick (one chunk of
``chunk_frames`` frames), and vocodes the windows that are ready across
streams in batches.

- **One tick**: the lanes' latents, the fresh lanes' carry rows zeroed by
  mask on the device, then one ``ar_step_infer(..., carry=,
  return_carry=True)`` at the fixed shape (chunk_frames, slots, n_mel)
  with a (slots, 1) temperature. A carried call always runs the loop, so
  the tick never reaches kernel K1. Mel and gates come to the host in one
  copy. Empty lanes ride along: their encoder rows stay as they were,
  their key mask keeps one true key (an all-masked row would give NaN),
  and nothing reads what they compute.
- **Joins**: encode at ``text_len`` and, for n_flows >= 2, the prelude
  (flows n-1..1) at B=1: one K1 launch a join on the card (a scalar
  temperature keeps it in K1's subset; a cumulative-attention model runs
  it on the loop). The carry holds JAX's seven entries, the attention
  ones at (slots, text_len). Then the slot's rows of the
  shared buffers are written in place. A join runs in ``open()``, or,
  with ``max_joins_per_tick``, in ``step()`` at most K a tick in arrival
  order, so a rush of joins cannot stall the running streams. Every
  launch goes to the one default CUDA stream.
- **Vocoder groups**: ready windows are grouped by width; each group is
  one ``waveglow_infer_z`` at B=G (kernel K2 on the card), with each
  lane's own mel window and positional latents. Groups are not padded to
  the slot count: an eager launch would spend device time on the copies.

Latents come from each stream's generators (``stream_generators(seed)``),
drawn in the shapes and order of the B=1 pipeline (``pump_stream`` over a
``StreamingMelSynthesizer`` and a ``StreamingVocoder``): for one flow
min(chunk, cap - c * chunk) frames a chunk, for two flows the whole (1,
n_mel, max_frames) at the join, for the vocoder one ``positional_z`` over
``max_frames`` at the stream's first window. So each stream's audio is
its solo stream's with the same seed, chunk, context, lookahead and cap.
``open()``'s ``residual`` and ``latents`` take given latents instead (the
tests feed JAX's own draws through them).
"""

import threading

import numpy as np
import torch

from flowtron_tpu_torch.infer.streaming import (
    HOP, positional_z, run_prelude, scaled_normal, stream_generators,
    window_spec,
)
from flowtron_tpu_torch.models.ar_step import ar_step_infer
from flowtron_tpu_torch.models.flowtron import _encode_text
from flowtron_tpu_torch.utils.masks import sequence_mask
from flowtron_tpu_torch.vocoder.waveglow import waveglow_infer_z


class MuxFull(RuntimeError):
    """All slots busy: callers map this to 429."""


class MuxClosed(RuntimeError):
    """The stream was closed while its ``open()`` was still committing:
    the handle would never produce events, so ``open()`` raises this
    instead of returning it."""


class _Slot:
    __slots__ = ("handle", "g_mel", "g_voc", "residual", "latents", "sigma",
                 "c", "n_valid", "fired", "mel_buf", "emitted", "done_mel",
                 "max_frames", "fresh", "pending_close", "joined",
                 "pending_join")

    def __init__(self, handle, seed, sigma, max_frames, residual, latents):
        self.handle = handle      # caller-facing id, never reused
        self.g_mel, self.g_voc = stream_generators(seed)
        self.residual = residual  # given latents (N, 1, n_mel), or None
        self.latents = latents    # vocoder latent source, or None
        self.sigma = float(sigma)
        self.c = 0                # chunks consumed
        self.n_valid = None       # known after the prelude or the gate
        self.fired = False        # one flow: the gate fired
        self.mel_buf = None       # host (n_mel, F), the vocoder's input
        self.emitted = 0          # mel frames vocoded
        self.done_mel = False
        self.max_frames = max_frames
        self.fresh = True         # carry rows zeroed by the next tick
        self.pending_close = False
        self.joined = False       # device rows written
        self.pending_join = None  # a deferred join's arguments


class MultiStreamTTS:
    """Fixed-slot TTS multiplexer: ``open()`` registers a stream,
    ``step()`` advances every active stream one mel chunk and returns the
    audio that became ready. Safe for one stepper thread beside
    concurrent ``open()`` / ``close()`` callers (the serving engine's
    layout).

        mux = MultiStreamTTS(model, cfg, wg, wg_cfg, slots=8)
        h = mux.open(seed, speaker_id=0, text_ids=ids)
        while mux.active:
            for handle, audio, done in mux.step():
                ...  # audio: (n,) float32; done ends the stream
    """

    def __init__(self, model, config, wg_model, wg_config, slots=8,
                 chunk_frames=40, text_len=128, max_frames=2000,
                 gate_threshold=0.5, wg_sigma=0.8, context=24,
                 lookahead=16, fused=False, max_joins_per_tick=None):
        """fused: the prelude's ``fused`` (as ``StreamingMelSynthesizer``'s).
        max_joins_per_tick: None joins in ``open()``; K defers joins to
        ``step()``, at most K a tick."""
        self.model = model
        self.config = config
        self.wg_model = wg_model
        self.wg_config = wg_config
        self.slots = int(slots)
        self.C = int(chunk_frames)
        self.Tk = int(text_len)
        self.max_frames = int(max_frames)
        self.gate_threshold = float(gate_threshold)
        self.wg_sigma = float(wg_sigma)
        self.context = int(context)
        self.lookahead = int(lookahead)
        self.fused = fused
        self.max_joins_per_tick = (None if max_joins_per_tick is None
                                   else max(1, int(max_joins_per_tick)))
        self.n_flows = int(config["n_flows"])
        self.n_mel = int(config["n_mel_channels"])
        self.device = next(model.parameters()).device
        flow0 = model.flows[0]
        self._dtype = flow0.conv.weight.dtype
        self._wg_dtype = next(wg_model.parameters()).dtype
        self._gate_in_stream = self.n_flows == 1 and \
            hasattr(flow0, "gate_layer")
        self._sq = HOP // wg_config["n_group"]

        self._lock = threading.Lock()
        self._slots = [None] * self.slots
        self._next_handle = 0

        B, dev = self.slots, self.device
        self._enc = None          # (Tk, B, D), at the first join
        self._key_mask = torch.zeros(B, self.Tk, dtype=torch.bool,
                                     device=dev)
        self._key_mask[:, 0] = True
        self._temp = torch.ones(B, 1, device=dev)
        # two flows: flow 0's input per lane, time-major and padded to
        # whole chunks so a tick's rows never run past the buffer
        n_pad = -(-self.max_frames // self.C) * self.C
        self._z1 = torch.zeros(n_pad, B, self.n_mel, dtype=self._dtype,
                               device=dev) if self.n_flows > 1 else None
        self._carry = None

    # -- registration -----------------------------------------------------
    @property
    def active(self):
        with self._lock:
            return sum(s is not None for s in self._slots)

    @property
    def has_work(self):
        """Whether ``step()`` has anything to do: a joined stream, a
        deferred join or a close to apply. A slot reserved by a join still
        running in ``open()`` is not work yet, so a stepper that waits on
        this does not spin beside that join."""
        with self._lock:
            return any(s is not None and (s.joined or s.pending_close
                                          or s.pending_join is not None)
                       for s in self._slots)

    def open(self, seed, speaker_id, text_ids, in_len=None, sigma=0.5,
             temperature=1.0, max_frames=None, residual=None, latents=None):
        """Register a stream; returns its handle.

        seed: the stream's latents come from ``stream_generators(seed)``.
        text_ids: (n,) ids, n <= text_len. residual: (1, n_mel, N) latents
        to use instead (sigma applied; for one flow the frames of every
        chunk, for two flows the prelude's input); latents: a vocoder
        latent source ``(start, n) -> (z_main, z_early)`` at B=1 (see
        ``StreamingVocoder``). Raises MuxFull when no slot is free. The
        join (encode, and the prelude for n_flows >= 2) runs here, or in
        ``step()`` with ``max_joins_per_tick``."""
        text_ids = np.asarray(text_ids)
        n = int(in_len) if in_len is not None else int(text_ids.shape[0])
        if n < 1:
            raise ValueError("empty text")
        if n > self.Tk:
            raise ValueError(f"text length {n} > mux text_len {self.Tk}")
        cap = self.max_frames if max_frames is None \
            else min(int(max_frames), self.max_frames)
        res_tbm = None
        if residual is not None:
            res_tbm = torch.as_tensor(residual).permute(2, 0, 1).to(
                self._dtype)
            if self.n_flows == 1:
                cap = min(cap, res_tbm.shape[0])
            elif res_tbm.shape[0] > self.max_frames:
                raise ValueError(f"residual of {res_tbm.shape[0]} frames > "
                                 f"mux max_frames {self.max_frames}")

        with self._lock:
            try:
                b = self._slots.index(None)
            except ValueError:
                raise MuxFull(f"all {self.slots} mux slots busy") from None
            handle = self._next_handle
            self._next_handle += 1
            slot = _Slot(handle, seed, sigma, cap, res_tbm, latents)
            self._slots[b] = slot   # reserved; joined once the rows land

        text_pad = np.zeros((1, self.Tk), np.int64)
        text_pad[0, :n] = text_ids[:n]
        payload = (int(speaker_id), text_pad, n, float(temperature))
        if self.max_joins_per_tick is not None:
            # set under the lock that the stepper reads pending joins
            # under: it never sees a reserved slot without its payload
            with self._lock:
                slot.pending_join = payload
            return handle
        try:
            joined = self._device_join(b, slot, *payload)
        except BaseException:
            with self._lock:            # a failed join frees its slot
                if self._slots[b] is slot:
                    self._slots[b] = None
            raise
        if not joined:
            # close() raced the join: the stream can never emit
            raise MuxClosed(f"stream {handle} closed during open()")
        return handle

    @torch.no_grad()
    def _device_join(self, b, slot, speaker_id, text_pad, n, temperature):
        """Encode (and run the prelude of) a reserved slot, then write its
        rows. Returns False if the slot was freed (a raced close) before
        the rows could land."""
        dev = self.device
        km1 = sequence_mask(torch.tensor([n], device=dev), self.Tk)
        enc1 = _encode_text(self.model, self.config,
                            torch.tensor([speaker_id], device=dev),
                            torch.as_tensor(text_pad, device=dev), km1)
        z1 = None
        if self.n_flows > 1:
            res = slot.residual
            if res is None:
                # the solo stream's (1, n_mel, max_frames) draw
                res = scaled_normal(
                    slot.sigma, (1, self.n_mel, self.max_frames),
                    slot.g_mel, self._dtype).permute(2, 0, 1)
            z1, nv = run_prelude(self.model, res.to(dev).contiguous(), enc1,
                                 km1, temperature, self.gate_threshold,
                                 self.fused)
            slot.n_valid = max(1, min(int(nv[0]), slot.max_frames))

        with self._lock:
            if self._slots[b] is not slot:
                return False
            if self._enc is None:
                self._enc = enc1.new_zeros(self.Tk, self.slots,
                                           enc1.shape[2])
            self._enc[:, b] = enc1[:, 0]
            self._key_mask[b] = km1[0]
            self._temp[b, 0] = temperature
            if z1 is not None:
                self._z1[:z1.shape[0], b] = z1[:, 0]
            slot.pending_join = None
            slot.joined = True
        return True

    def _find(self, handle):
        for s in self._slots:
            if s is not None and s.handle == handle:
                return s
        return None

    def close(self, handle):
        """Abort a stream (its client went away). Its slot is freed at the
        next ``step()``; until then its lane computes into the void."""
        with self._lock:
            s = self._find(handle)
            if s is not None:
                s.pending_close = True

    def n_valid_of(self, handle):
        """Valid mel frames of a live stream (None until known)."""
        with self._lock:
            s = self._find(handle)
            return None if s is None else s.n_valid

    def warmup(self):
        """Run one throwaway stream (its slot frees itself): the tick, a
        join and the first, steady and flush window widths set up their
        kernels and allocations before real traffic."""
        self.open(0, 0, np.ones((min(4, self.Tk),), np.int64),
                  max_frames=min(self.max_frames, 3 * self.C))
        while self.active:
            self.step()

    # -- the tick ---------------------------------------------------------
    def _init_carry(self):
        """The loop's zero state, ``_scan_infer``'s layout: (h_att, c_att,
        hs, cs) at (slots, H), the previous frame at (slots, n_mel), the
        cumulative and previous attention at (slots, Tk), the joins' text
        bucket, as JAX's ``_init_carry``."""
        flow = self.model.flows[0]
        H = flow.attention_lstm.layer_weights(0)[1].shape[1]

        def z(n):
            return torch.zeros(self.slots, n, dtype=self._dtype,
                               device=self.device)

        n_layers = flow.lstm.num_layers
        return (z(H), z(H), tuple(z(H) for _ in range(n_layers)),
                tuple(z(H) for _ in range(n_layers)), z(self.n_mel),
                z(self.Tk), z(self.Tk))

    def _tick(self, mel_live, fresh):
        """One chunk of every lane. Returns host (C, slots, n_mel) mel and
        (C, slots) gates."""
        C, B, M, dev = self.C, self.slots, self.n_mel, self.device
        fresh_t = torch.as_tensor(fresh, device=dev)[:, None]
        h_att, c_att, hs, cs, *rest = self._carry

        def zero_fresh(x):
            return x.masked_fill(fresh_t, 0.0)

        carry = (zero_fresh(h_att), zero_fresh(c_att),
                 tuple(map(zero_fresh, hs)), tuple(map(zero_fresh, cs)),
                 *map(zero_fresh, rest))
        if self.n_flows == 1:
            z = torch.zeros(C, B, M, dtype=self._dtype)
            for b, s in mel_live:
                # the solo stream's draw: the frames its cap leaves
                n = min(C, s.max_frames - s.c * C)
                if s.residual is not None:
                    z[:n, b] = s.residual[s.c * C:s.c * C + n, 0]
                else:
                    z[:n, b] = scaled_normal(s.sigma, (n, 1, M), s.g_mel,
                                             self._dtype)[:, 0]
            z = z.to(dev)
        else:
            cs_h = np.zeros((B,), np.int64)
            for b, s in mel_live:
                cs_h[b] = s.c
            rows = torch.as_tensor(cs_h[None, :] * C
                                   + np.arange(C)[:, None], device=dev)
            z = self._z1[rows, torch.arange(B, device=dev)]
        mel, _attn, gates, self._carry = ar_step_infer(
            self.model.flows[0], z, self._enc, key_mask=self._key_mask,
            temperature=self._temp, carry=carry, return_carry=True)
        packed = torch.cat([mel, gates[:, :, None].to(mel.dtype)], dim=2)
        packed = packed.float().cpu().numpy()        # one copy a tick
        return packed[:, :, :M], packed[:, :, M]

    def _latents_of(self, s):
        if s.latents is None:
            # drawn at the stream's first window, as StreamingVocoder does
            s.latents = positional_z(s.g_voc, self.wg_config, 1,
                                     self.max_frames * self._sq,
                                     self.wg_sigma, self.device,
                                     self._wg_dtype)
        return s.latents

    def _window_audio(self, members, W):
        """One WaveGlow pass over a group of windows of width W (mel
        frames): each lane its slot's mel window and latents. Returns
        host (G, W * HOP) audio."""
        mel = torch.from_numpy(np.stack(
            [s.mel_buf[:, w0:w0 + W] for _b, s, _e0, _n, w0, _e in members]))
        zs = [self._latents_of(s)(w0 * self._sq, W * self._sq)
              for _b, s, _e0, _n, w0, _e in members]
        z_main = torch.cat([zm for zm, _ in zs])
        z_early = [None if ze is None else torch.cat([e[f] for _, e in zs])
                   for f, ze in enumerate(zs[0][1])]
        audio = waveglow_infer_z(self.wg_model, self.wg_config,
                                 mel.to(self.device, self._wg_dtype), z_main,
                                 z_early)
        return audio.float().cpu().numpy()

    @torch.no_grad()
    def step(self):
        """Advance every joined stream one mel chunk in one tick, vocode
        the ready windows in width groups, and return [(handle, audio (n,)
        float32, done), ...]. A finished stream's slot is freed before
        returning. Returns [] when nothing is active."""
        if self.max_joins_per_tick is not None:
            with self._lock:
                pend = sorted(
                    ((b, s) for b, s in enumerate(self._slots)
                     if s is not None and not s.joined
                     and not s.pending_close
                     and s.pending_join is not None),
                    key=lambda bs: bs[1].handle)[:self.max_joins_per_tick]
            for b, s in pend:
                self._device_join(b, s, *s.pending_join)
        with self._lock:
            for b, s in enumerate(self._slots):
                if s is not None and s.pending_close:
                    self._slots[b] = None
            live = [(b, s) for b, s in enumerate(self._slots)
                    if s is not None and s.joined]
            fresh = np.zeros((self.slots,), bool)
            for b, s in live:
                if s.fresh:
                    fresh[b] = True
                    s.fresh = False
        if not live:
            return []
        if self._carry is None:
            self._carry = self._init_carry()

        C = self.C
        events = []
        mel_live = [(b, s) for b, s in live if not s.done_mel]
        if mel_live:
            mel_h, gates_h = self._tick(mel_live, fresh)
            # per slot: the gate's end, then its frames up to its own
            # n_valid (frames past a gate never reach the vocoder)
            for b, s in mel_live:
                if self._gate_in_stream and not s.fired:
                    hit = gates_h[:, b] > self.gate_threshold
                    if hit.any():
                        s.fired = True
                        s.n_valid = min(s.c * C + int(hit.argmax()) + 1,
                                        s.max_frames)
                cap = s.n_valid if s.n_valid is not None else s.max_frames
                n_real = min(C, cap - s.c * C)
                if n_real > 0:
                    mel_b = mel_h[:n_real, b].T
                    s.mel_buf = mel_b if s.mel_buf is None else \
                        np.concatenate([s.mel_buf, mel_b], axis=1)
                s.c += 1
                if s.c * C >= cap:
                    s.done_mel = True
                    if s.n_valid is None:     # never gated: the cap
                        s.n_valid = cap

        # the vocoder: each slot's windows as the solo vocoder's pushes
        # (and, on its last chunk, its flush), grouped by width
        groups = {}   # width -> [(b, slot, e0, n, w0, at_end), ...]

        def enqueue(b, s, e0, n, at_end):
            w0, w1 = window_spec(e0, n, s.mel_buf.shape[1], self.context,
                                 self.lookahead, at_end)
            groups.setdefault(w1 - w0, []).append((b, s, e0, n, w0, at_end))

        finals = {}   # b -> [(e0, audio)] of a finishing slot
        for b, s in live:
            if s.mel_buf is None:
                if s.done_mel:      # gated before any frame
                    events.append((s.handle, np.zeros((0,), np.float32),
                                   True))
                continue
            F = s.mel_buf.shape[1]
            e0 = s.emitted
            if s.done_mel:
                finals[b] = []
            ready = F - self.lookahead - e0
            if ready > 0:
                enqueue(b, s, e0, ready, False)
                e0 += ready
            if s.done_mel:
                tail = F - e0
                if tail > 0:
                    enqueue(b, s, e0, tail, True)
                elif ready <= 0:    # nothing left to vocode
                    del finals[b]
                    events.append((s.handle, np.zeros((0,), np.float32),
                                   True))

        for W, members in sorted(groups.items()):
            audio = self._window_audio(members, W)
            for i, (b, s, e0, n, w0, _at_end) in enumerate(members):
                lo = (e0 - w0) * HOP
                out = audio[i, lo:lo + n * HOP]
                s.emitted = e0 + n
                if b in finals:
                    finals[b].append((e0, out))
                else:
                    events.append((s.handle, out, False))

        slot_of = dict(live)
        for b, pieces in finals.items():
            pieces.sort(key=lambda p: p[0])
            events.append((slot_of[b].handle,
                           np.concatenate([p[1] for p in pieces]), True))

        done = {h for h, _a, d in events if d}
        if done:
            with self._lock:
                for b, s in enumerate(self._slots):
                    if s is not None and s.handle in done:
                        self._slots[b] = None
        return events
