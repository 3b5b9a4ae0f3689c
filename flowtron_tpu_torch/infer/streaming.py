"""Streaming synthesis: mel and audio in chunks as the frame loop runs
(port of flowtron_tpu/infer/streaming.py).

- **Mel** (``StreamingMelSynthesizer``): the inverse AR loop is causal,
  so it chunks exactly: ``chunk_frames`` frames a call with the loop's
  state carried between calls (``ar_step_infer``'s ``carry`` /
  ``return_carry``, always the per-frame loop).

  * n_flows == 1: fully incremental; gate termination is tracked on the
    host across chunks with the offline path's first-hit semantics.
  * n_flows >= 2 (the repo's configs): two stages. Inference runs the
    flows in reverse, so the gated last flow (a backward flow, which
    needs the whole utterance) comes first: flows n-1..1 run offline in
    one pass (kernel K1 on the card), giving flow 0's input and each
    stream's n_valid; then the forward flow 0 is streamed chunk by chunk
    with the carry, exactly the offline loop prefix by prefix.

  Frames at or past a stream's own n_valid are silenced before they are
  yielded: streamed audio cannot be retracted.

- **Audio** (``StreamingVocoder``): WaveGlow is convolutional, not
  causal, so it runs on a sliding window with ``context`` mel frames of
  history and ``lookahead`` frames of delay and emits the interior only.
  Its latents come from a source that is a pure function of absolute
  squeezed-frame position (``positional_z``), so overlapping windows see
  the same z; the seams' truncation error decays with context and
  lookahead.

- ``stream_tts`` drives both into a generator of waveform chunks.

Latents are drawn on the CPU from seeded ``torch.Generator``s (a stream's
own pair, ``stream_generators``), so a seed gives the same stream on
every device; ``jax.random`` cannot be matched, so callers that must
match the JAX package pass ``residual`` and a latent source. The mel
latents are drawn in the flows' dtype (bf16 for a bf16 engine) with sigma
cast to it first (``scaled_normal``), the vocoder's in fp32 and then cast
to the vocoder's dtype.
"""

import numpy as np
import torch

from flowtron_tpu_torch.models.ar_step import (
    ar_back_step_infer, ar_step_infer,
)
from flowtron_tpu_torch.models.flowtron import _encode_text
from flowtron_tpu_torch.utils.masks import sequence_mask
from flowtron_tpu_torch.vocoder.waveglow import (
    waveglow_infer_z, waveglow_n_remaining,
)

HOP = 256  # audio samples per mel frame (data_config.hop_length)
# log-mel silence (the dynamic-range clamp floor, log(1e-5)): what a
# trimmed or post-gate frame vocodes to
SILENCE = float(np.log(1e-5))
VOCODER_STREAM = 1986   # separates a seed's vocoder latents from its mel's


def scaled_normal(sigma, shape, generator, dtype):
    """``sigma`` * N(0, 1) of ``shape`` drawn from ``generator`` (CPU) in
    ``dtype``, sigma cast to ``dtype`` first, as the JAX streamers' draws
    (a weak Python-float sigma takes the draw's dtype; the mux casts its
    fp32 sigmas, flowtron_tpu/infer/multistream.py:222-226)."""
    z = torch.randn(*shape, generator=generator, dtype=dtype)
    return z * torch.tensor(float(sigma), dtype=dtype)


def stream_generators(seed):
    """The CPU generators of a stream seeded ``seed``: (mel latents,
    vocoder latents), the second seeded from (seed, 1986)."""
    entropy = np.random.SeedSequence([int(seed) % 2 ** 64, VOCODER_STREAM])
    return (torch.Generator().manual_seed(int(seed)),
            torch.Generator().manual_seed(int(entropy.generate_state(1)[0])))


class StreamingMelSynthesizer:
    """Chunked AR mel synthesis with carried loop state.

        s = StreamingMelSynthesizer(model, config, chunk_frames=40)
        for mel_chunk in s.stream(generator, speaker_ids, text, sigma=0.5):
            ...  # (B, n_mel, <= chunk_frames) on the model's device
        s.n_valid  # (B,) valid frames, the offline gate semantics
    """

    def __init__(self, model, config, chunk_frames=40, temperature=1.0,
                 gate_threshold=0.5, max_frames=2000, fused=False):
        """fused: the offline prelude's ``fused`` (see ``ar_step_infer``:
        on the card K1 runs it either way; ``"early"`` turns on K1's early
        exit). The chunked flow 0 carries its state and runs the loop."""
        self.model = model
        self.config = config
        self.n_flows = int(config["n_flows"])
        self.chunk_frames = int(chunk_frames)
        self.temperature = float(temperature)
        self.gate_threshold = float(gate_threshold)
        self.max_frames = int(max_frames)
        self.fused = fused
        self.n_valid = None
        self.device = next(model.parameters()).device
        flow0 = model.flows[0]
        # n_flows == 1: the only flow carries the gate; n_flows >= 2: the
        # gate is on the last flow, inside the prelude
        self._gate_in_stream = self.n_flows == 1 and \
            hasattr(flow0, "gate_layer")
        self._dtype = flow0.conv.weight.dtype

    @torch.no_grad()
    def stream(self, generator, speaker_ids, text, sigma=0.5, in_lens=None,
               residual=None, temperature=None, max_frames=None):
        """Generator of (B, n_mel, <= chunk_frames) mel chunks.

        Latents are ``sigma`` * normal drawn from ``generator`` (a CPU
        ``torch.Generator``): for n_flows == 1 a chunk's at a time, for
        n_flows >= 2 the whole (B, n_mel, max_frames) up front, for the
        prelude. A given ``residual`` (B, n_mel, N) is used instead.
        ``temperature`` and ``max_frames`` override the constructor's for
        this call (for n_flows >= 2 ``max_frames`` caps the emitted length,
        not the latents the backward flow sees).

        Afterwards ``self.n_valid`` holds each stream's valid frames
        (first gate hit, inclusive); yielded frames past a stream's own
        n_valid are silence.
        """
        temp = self.temperature if temperature is None \
            else float(temperature)
        key_mask = None if in_lens is None \
            else sequence_mask(in_lens, text.shape[1])
        enc = _encode_text(self.model, self.config, speaker_ids, text,
                           key_mask)
        run = self._stream_incremental if self.n_flows == 1 \
            else self._stream_two_stage
        yield from run(generator, enc, key_mask, speaker_ids.shape[0], sigma,
                       residual, temp, max_frames)

    def _latents(self, generator, sigma, *shape):
        return scaled_normal(sigma, shape, generator,
                             self._dtype).to(self.device)

    def _chunk(self, z, enc, key_mask, carry, temp):
        return ar_step_infer(self.model.flows[0], z, enc, key_mask=key_mask,
                             temperature=temp, carry=carry,
                             return_carry=True)

    # -- n_flows == 1: fully incremental ---------------------------------
    def _stream_incremental(self, generator, enc, key_mask, B, sigma,
                            residual, temp, max_frames_arg):
        n_mel = self.config["n_mel_channels"]
        C = self.chunk_frames
        max_frames = self.max_frames if max_frames_arg is None \
            else min(int(max_frames_arg), self.max_frames)
        if residual is not None:
            max_frames = min(residual.shape[2], max_frames)
            res_tbm = residual.permute(2, 0, 1).to(self.device, self._dtype)

        carry = None
        fired = np.zeros((B,), bool)
        n_valid = np.zeros((B,), np.int64)
        done_at = None
        c = 0
        while c * C < max_frames:
            n_real = min(C, max_frames - c * C)
            z_c = res_tbm[c * C:c * C + n_real] if residual is not None \
                else self._latents(generator, sigma, n_real, B, n_mel)
            mel_c, _attn, gates_c, carry = self._chunk(z_c, enc, key_mask,
                                                       carry, temp)
            if self._gate_in_stream:
                hit = (gates_c > self.gate_threshold).cpu().numpy()
                for b in range(B):
                    if not fired[b] and hit[:, b].any():
                        fired[b] = True
                        n_valid[b] = c * C + int(hit[:, b].argmax()) + 1
                if fired.all():
                    # frames past the last gate hit must never reach the
                    # vocoder: streamed audio cannot be retracted
                    done_at = int(n_valid.max())
                    n_real = min(n_real, done_at - c * C)
            if n_real > 0:
                mel_y = mel_c[:n_real]
                if fired.any():
                    # a fired stream's frames past its own n_valid become
                    # silence, not the loop's continuation
                    mel_y = _mask_past_valid(mel_y, c * C, n_valid, fired)
                yield mel_y.permute(1, 2, 0)
            c += 1
            if done_at is not None and c * C >= done_at:
                break

        n_valid[~fired] = min(c * C, max_frames)
        self.n_valid = n_valid.copy()

    # -- n_flows >= 2: offline prelude + streamed forward flow -----------
    def _stream_two_stage(self, generator, enc, key_mask, B, sigma,
                          residual, temp, max_frames_arg):
        C = self.chunk_frames
        if residual is None:
            residual = self._latents(generator, sigma, B,
                                     self.config["n_mel_channels"],
                                     self.max_frames)
        z_tbm = residual.permute(2, 0, 1).to(self.device, self._dtype) \
            .contiguous()
        N = z_tbm.shape[0]
        z1, n_valid = run_prelude(self.model, z_tbm, enc, key_mask, temp,
                                  self.gate_threshold, self.fused)
        nv = n_valid.cpu().numpy().astype(np.int64)
        if max_frames_arg is not None:
            nv = np.minimum(nv, int(max_frames_arg))
        self.n_valid = nv.copy()
        done_at = max(1, int(nv.max()))

        carry = None
        every = np.ones((B,), bool)
        for c0 in range(0, done_at, C):
            n_real = min(C, done_at - c0, N - c0)
            mel_c, _attn, _gates, carry = self._chunk(
                z1[c0:c0 + n_real], enc, key_mask, carry, temp)
            yield _mask_past_valid(mel_c, c0, nv, every).permute(1, 2, 0)


def run_prelude(model, z, enc, key_mask, temperature, gate_threshold,
                fused=False):
    """Flows n-1..1 of the reversed inference chain
    (reference:flowtron.py:924-929 without the last inverse step) over
    latents ``z`` (N, B, n_mel): on the card kernel K1 for a flow in its
    subset. Returns (flow 0's input (N, B, n_mel), n_valid (B,))."""
    n_flows = len(model.flows)
    n_valid = None
    for rev_i, flow in enumerate(reversed(model.flows[1:])):
        i = n_flows - 1 - rev_i
        step = ar_step_infer if i % 2 == 0 else ar_back_step_infer
        z, _, n_valid = step(flow, z, enc, key_mask, None, temperature,
                             gate_threshold, n_valid=n_valid, fused=fused)
    return z, n_valid


def _mask_past_valid(mel_nbm, c0, n_valid, active):
    """Silence frames at global positions >= their stream's n_valid.

    mel_nbm: (n, B, M); c0: the chunk's first global frame; n_valid (B,)
    and active (B,): host arrays, ``active`` the streams whose n_valid is
    final (the others keep their frames).
    """
    pos = c0 + np.arange(mel_nbm.shape[0])
    past = active[None, :] & (pos[:, None] >= np.asarray(n_valid)[None, :])
    if not past.any():
        return mel_nbm
    past = torch.as_tensor(past, device=mel_nbm.device)[:, :, None]
    return torch.where(past, SILENCE, mel_nbm)


def positional_z(generator, config, B, length, sigma, device=None,
                 dtype=None):
    """A latent source for absolute squeezed-frame positions [0, length):
    z drawn once from ``generator`` (CPU) in fp32 and moved to ``device``
    (and cast to ``dtype``, the vocoder's, when given).
    Returns ``source(start, n) -> (z_main, z_early)`` in
    ``waveglow_infer_z``'s layout for positions [start, start + n): a pure
    function of position, so any two windows agree on their overlap."""
    def draw(n_ch):
        return (sigma * torch.randn(B, n_ch, length,
                                    generator=generator)).to(device, dtype)

    z_main = draw(waveglow_n_remaining(config))
    z_early = [draw(config["n_early_size"])
               if f % config["n_early_every"] == 0 and f > 0 else None
               for f in range(config["n_flows"])]

    def source(start, n):
        if start < 0 or start + n > length:
            raise ValueError(f"positions [{start}, {start + n}) outside the "
                             f"drawn [0, {length})")
        return (z_main[:, :, start:start + n],
                [None if z is None else z[:, :, start:start + n]
                 for z in z_early])

    return source


class StreamingVocoder:
    """Sliding-window WaveGlow: push mel chunks, get waveform chunks.

    Emits audio for mel frames [emitted, emitted + n) once ``lookahead``
    frames of later mel exist (or at ``flush()``); each window also
    carries ``context`` frames of history. Window edges are clamped to
    the true sequence ends, so boundary padding matches the offline pass.

    Latents: ``latents(start, n) -> (z_main, z_early)`` over absolute
    squeezed-frame positions (``positional_z``'s layout, sigma applied);
    by default ``positional_z`` of ``generator`` (default seeded 0) over
    ``max_frames`` mel frames, drawn at the first window.
    ``dtype``: the windows' (mel and latents) dtype, by default the
    vocoder's (bf16 for a bf16 engine's, JAX's ``dtype=jnp.bfloat16``).
    """

    def __init__(self, wg_model, wg_config, latents=None, sigma=0.8,
                 context=24, lookahead=16, max_frames=2000, generator=None,
                 dtype=None):
        self.model = wg_model
        self.dtype = dtype or next(wg_model.parameters()).dtype
        self.config = wg_config
        self.sigma = float(sigma)
        self.context = int(context)
        self.lookahead = int(lookahead)
        self.max_frames = int(max_frames)
        self.sq_per_frame = HOP // wg_config["n_group"]
        self.device = next(wg_model.parameters()).device
        self.reset(generator, latents)

    def reset(self, generator=None, latents=None):
        """Start a new utterance with latents from ``latents``, or drawn
        from ``generator`` (default seeded 0)."""
        self._mel = None        # (B, n_mel, F) on the vocoder's device
        self._emitted = 0
        self._latents = latents
        self._generator = generator

    def push(self, mel_chunk):
        """Append (B, n_mel, n) mel frames; return the audio that is ready,
        (B, m * HOP) float32 numpy, possibly m = 0 while lookahead fills."""
        mel_chunk = mel_chunk.to(self.device)
        self._mel = mel_chunk if self._mel is None else \
            torch.cat([self._mel, mel_chunk], dim=2)
        F = self._mel.shape[2]
        ready = F - self.lookahead - self._emitted
        if ready <= 0:
            return np.zeros((self._mel.shape[0], 0), np.float32)
        return self._emit(ready, F)

    def truncate(self, n_frames):
        """Drop buffered mel frames from ``n_frames`` on (the utterance's
        end, known after the last chunk)."""
        if self._mel is not None and self._mel.shape[2] > n_frames:
            self._mel = self._mel[:, :, :n_frames]

    def flush(self):
        """Emit everything remaining (end of utterance)."""
        if self._mel is None:
            return np.zeros((1, 0), np.float32)
        F = self._mel.shape[2]
        if F - self._emitted <= 0:
            return np.zeros((self._mel.shape[0], 0), np.float32)
        return self._emit(F - self._emitted, F, at_end=True)

    def _emit(self, n, F, at_end=False):
        e0 = self._emitted
        w0, w1 = window_spec(e0, n, F, self.context, self.lookahead, at_end)
        mel_win = self._mel[:, :, w0:w1].to(self.dtype)
        if self._latents is None:
            self._latents = positional_z(
                self._generator or torch.Generator().manual_seed(0),
                self.config, mel_win.shape[0],
                self.max_frames * self.sq_per_frame, self.sigma, self.device,
                self.dtype)
        z_main, z_early = self._latents(w0 * self.sq_per_frame,
                                        (w1 - w0) * self.sq_per_frame)
        audio = waveglow_infer_z(self.model, self.config, mel_win, z_main,
                                 z_early)
        lo = (e0 - w0) * HOP
        self._emitted = e0 + n
        return audio[:, lo:lo + n * HOP].float().cpu().numpy()


def window_spec(e0, n, F, context, lookahead, at_end=False):
    """The sliding window's arithmetic: given ``e0`` frames already
    emitted, ``n`` to emit now and ``F`` buffered, the mel window [w0, w1)
    to vocode. Widths are rounded up to multiples of 16 by extending left
    into real history (more context, the same semantics), so ragged tails
    reuse a few shapes."""
    W = context + n + lookahead
    w0 = max(0, e0 - context)
    if not at_end:
        w0 = min(w0, max(0, F - W))
        w1 = min(F, w0 + W)
    else:
        w1 = F
        w0 = max(0, w1 - W)
    bucket = -(-(w1 - w0) // 16) * 16
    w0 = max(0, w1 - bucket)
    return w0, w1


def pump_stream(mel_s, voc, generator, speaker_ids, text, sigma=0.5,
                in_lens=None, temperature=None, max_frames=None):
    """Drive a mel streamer into a vocoder streamer; yields (B, n * HOP)
    float32 numpy waveform chunks. Shared by ``stream_tts`` and the
    serving engine (which keeps both streamers across requests)."""
    pending = 0
    for mel_chunk in mel_s.stream(generator, speaker_ids, text, sigma=sigma,
                                  in_lens=in_lens, temperature=temperature,
                                  max_frames=max_frames):
        audio = voc.push(mel_chunk)
        pending += mel_chunk.shape[2]
        if audio.shape[1]:
            yield audio
    # cut the buffer at the gate's n_valid before flushing
    voc.truncate(int(mel_s.n_valid.max()) if mel_s.n_valid is not None
                 else pending)
    tail = voc.flush()
    if tail.shape[1]:
        yield tail


def stream_tts(model, config, wg_model, wg_config, seed, speaker_ids, text,
               sigma=0.5, wg_sigma=0.8, chunk_frames=40, gate_threshold=0.5,
               max_frames=2000, in_lens=None, context=24, lookahead=16,
               temperature=1.0):
    """Full streaming TTS: yields (B, n * HOP) float32 waveform chunks,
    the latents from ``stream_generators(seed)``. Time to first audio is
    one mel chunk plus the lookahead, and for n_flows >= 2 the prelude."""
    g_mel, g_voc = stream_generators(seed)
    mel_s = StreamingMelSynthesizer(
        model, config, chunk_frames=chunk_frames, temperature=temperature,
        gate_threshold=gate_threshold, max_frames=max_frames)
    voc = StreamingVocoder(wg_model, wg_config, sigma=wg_sigma,
                           context=context, lookahead=lookahead,
                           max_frames=max_frames, generator=g_voc)
    yield from pump_stream(mel_s, voc, g_mel, speaker_ids, text,
                           sigma=sigma, in_lens=in_lens)
