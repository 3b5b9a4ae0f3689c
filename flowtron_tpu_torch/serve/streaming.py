"""SynthesisEngine's streaming side (port of
flowtron_tpu/serve/streaming.py): the worker-pool path and the batched
multistream mux path (``--stream-mux``). Mixed into SynthesisEngine
(engine.py); every method runs against engine state.

Pool: a stream checks a warm (StreamingMelSynthesizer, StreamingVocoder)
pair out of a pool of ``stream_workers``; a producer thread runs
``infer/streaming.py:pump_stream`` on it (kernel K1 for the prelude
flows, the per-frame loop for flow 0, kernel K2 for each vocoder window
on the card) and hands PCM16 chunks to the caller through a bounded
queue.

Mux: a stream holds a slot of the engine's ``MultiStreamTTS``
(infer/multistream.py); one stepper thread (``_mux_loop``) ticks it and
routes each stream's audio to its own queue, sized for a whole
utterance so the stepper never blocks on a consumer.

Either way each stream (each segment of a split one) draws its latents
from its own generators (``stream_generators`` of its seed plus the
segment's index), so a muxed stream is the pooled stream of the same
request.
"""

import queue
import threading
import time

import numpy as np
import torch

from flowtron_tpu_torch.infer.multistream import MuxFull
from flowtron_tpu_torch.infer.streaming import (
    pump_stream, stream_generators,
)
from flowtron_tpu_torch.serve.common import (
    EngineOverloaded, TextTooLong, _log, split_measured,
)
from flowtron_tpu_torch.vocoder.denoiser import StreamingDenoiser


class StreamPathMixin:
    """``stream()``: a generator of PCM16 chunks, on checked-out streamer
    pairs from a warm pool."""

    @property
    def can_stream(self):
        return self._stream_pool is not None or self._mux is not None

    @property
    def active_mux_streams(self):
        """Streams holding a mux slot (0 without ``stream_mux``)."""
        return self._mux.active if self._mux is not None else 0

    def stream(self, text, speaker_id=0, sigma=0.5, seed=1234,
               n_frames=None, temperature=None, split=False,
               denoise=None):
        """Mono int16 PCM chunk generator. Time to first audio is one mel
        chunk plus the vocoder's lookahead, after the offline prelude for
        multi-flow models. Needs a loaded vocoder. Amplitude uses a fixed
        clip scale: a stream cannot be normalised to its own peak. An
        engine started with -d denoises streams too (a host-side
        StreamingDenoiser of the same bias spectrum, exact at chunk
        seams); ``denoise`` overrides the strength per request.

        ``split=True`` streams text longer than the largest bucket as one
        continuous stream: sentence-split segments synthesized back to
        back on the same streamer pair.

        Validation and the pool checkout run at the call, not at the first
        ``next()``, so an HTTP caller can still answer 4xx/5xx before it
        commits to a 200 and a chunked response."""
        if self._closed:
            raise RuntimeError("engine is shut down")
        if self._stream_pool is None and self._mux is None:
            raise RuntimeError("streaming requires a neural vocoder (-w)")
        if n_frames is not None:  # the batch path's clamp
            n_frames = max(1, min(int(n_frames), self.n_frames))
        if temperature is not None:
            temperature = float(temperature)
        denoise = self._request_denoise(denoise)
        try:
            ids = self.frontend.get_text(text)
            if len(ids) == 0:
                raise ValueError("empty text after cleaning")
            if len(ids) > self.text_buckets[-1]:
                if not split:
                    raise TextTooLong(len(ids), self.text_buckets[-1])
                segments = [p_ids for _, p_ids in split_measured(
                    text, self.frontend.get_text, self.text_buckets[-1])]
            else:
                segments = [ids]
        except TextTooLong:
            self._count("rejected_too_long")
            raise
        sid = int(self.frontend.speaker_ids.get(int(speaker_id), 0))
        if self._mux is not None:
            return self._stream_gen_mux(segments, sid, sigma, seed,
                                        n_frames, temperature, denoise)
        # the pool is captured under the lifecycle lock: shutdown() drops
        # the attribute
        with self._lifecycle_lock:
            if self._closed or self._stream_pool is None:
                raise RuntimeError("engine is shut down")
            pool = self._stream_pool
        try:
            pair = pool.get(timeout=self.stream_acquire_timeout)
        except queue.Empty:
            if self._closed:  # shutdown reclaimed the pairs meanwhile
                raise RuntimeError("engine is shut down")
            self._count("rejected_overload")
            raise EngineOverloaded("all streaming workers busy; retry later")
        self._count("stream_requests")
        return self._stream_gen(pool, pair, segments, sid, sigma, seed,
                                n_frames, temperature, denoise)

    def _stream_gen(self, pool, pair, segments, sid, sigma, seed,
                    n_frames, temperature, denoise):
        """The producer thread owns the checked-out pair; chunks cross to
        the caller through a bounded queue. The thread starts now, so the
        pair returns to the pool even if the generator is dropped
        unconsumed; a consumer that stalls longer than
        ``stream_stall_timeout`` (a dead client) aborts the stream."""
        out_q = queue.Queue(maxsize=4)
        cancel = threading.Event()
        # captured now: shutdown() drops engine attributes under live
        # streams
        den, device = self._denoiser, pair[2]

        def emit(samples):
            """float audio -> PCM16 on the queue; False aborts."""
            if samples.size == 0:
                return True
            pcm = (np.clip(samples, -1.0, 1.0) * 32767).astype(np.int16)
            try:
                out_q.put(pcm, timeout=self.stream_stall_timeout)
                return True
            except queue.Full:
                self._count("stream_stalls")
                return False

        def produce():
            err = None
            try:
                mel_s, voc, _ = pair
                for si, ids in enumerate(segments):
                    # per segment, as the batch path denoises each
                    # synthesized utterance
                    sd = StreamingDenoiser(den, strength=denoise) \
                        if denoise else None
                    n = len(ids)
                    text_pad = torch.zeros(1, self._bucket(n),
                                           dtype=torch.long)
                    text_pad[0, :n] = torch.as_tensor(ids)
                    # the segment's own latents, as the batch path seeds
                    # a split request's segments
                    g_mel, g_voc = stream_generators(int(seed) + si)
                    voc.reset(g_voc)
                    for audio in pump_stream(
                            mel_s, voc, g_mel,
                            torch.tensor([sid], device=device),
                            text_pad.to(device), sigma=float(sigma),
                            in_lens=torch.tensor([n], device=device),
                            temperature=temperature, max_frames=n_frames):
                        if cancel.is_set():
                            return
                        out = audio[0] if sd is None else sd.feed(audio[0])
                        if not emit(out):
                            return
                    if sd is not None:
                        if cancel.is_set() or not emit(sd.flush()):
                            return
            except Exception as e:  # noqa: BLE001 - raised to the consumer
                err = e
            finally:
                pool.put(pair)
                try:
                    out_q.put(err, timeout=5)
                except queue.Full:
                    _log.debug("stream end sentinel dropped (consumer "
                               "stalled; the liveness check ends it)")

        t = threading.Thread(target=produce, daemon=True)
        t.start()

        def consume():
            try:
                while True:
                    try:
                        item = out_q.get(timeout=1.0)
                    except queue.Empty:
                        # a stall-aborted producer may have dropped the
                        # sentinel: check it is alive
                        if not t.is_alive():
                            break
                        continue
                    if item is None:
                        break
                    if isinstance(item, Exception):
                        raise item
                    yield item
            finally:
                cancel.set()
                # drain so a producer blocked on put() sees cancel and
                # returns the pair
                while t.is_alive():
                    try:
                        out_q.get_nowait()
                    except queue.Empty:
                        time.sleep(0.005)

        return consume()

    # -- the batched multistream path (--stream-mux) ----------------------
    def _mux_loop(self):
        """The stepper thread: each ``MultiStreamTTS.step()`` tick advances
        every active stream; its audio goes to each stream's route
        queue."""
        mux = self._mux
        while not self._closed:
            if not mux.has_work:
                self._mux_wake.wait(timeout=0.25)
                self._mux_wake.clear()
                continue
            try:
                events = mux.step()
            except Exception as e:  # noqa: BLE001 - raised to the consumers
                # a failing tick poisons every active stream: close every
                # route (the lanes free at the next tick), hand each
                # consumer the error, and back off before trying again
                _log.warning("mux tick failed", exc_info=True)
                with self._mux_lock:
                    routes, self._mux_routes = self._mux_routes, {}
                for h, q in routes.items():
                    mux.close(h)
                    try:
                        q.put_nowait(e)
                    except queue.Full:
                        _log.debug("mux route %s full; error dropped", h)
                time.sleep(0.1)
                continue
            with self._mux_lock:
                routes = dict(self._mux_routes)
            for h, audio, done in events:
                q = routes.get(h)
                if q is None:
                    continue
                try:
                    # never blocks: a route holds a whole utterance, so
                    # one stalled consumer cannot stall every stream.
                    # Full means a dead client: close it, make room for
                    # an error that ends a consumer still draining
                    q.put_nowait((audio, done))
                except queue.Full:
                    self._count("stream_stalls")
                    mux.close(h)
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    try:
                        q.put_nowait(RuntimeError(
                            "stream aborted: consumer stalled"))
                    except queue.Full:
                        _log.debug("mux stall error dropped (route %s "
                                   "full)", h)
                    done = True
                if done:
                    with self._mux_lock:
                        self._mux_routes.pop(h, None)

    def _mux_open_routed(self, seed, sid, ids, sigma, temperature,
                         n_frames):
        """``open()`` a mux slot with its route registered before the
        stepper can emit for it. Returns (handle, route queue)."""
        # captured under the lifecycle lock: shutdown() drops the attribute
        with self._lifecycle_lock:
            if self._closed or self._mux is None:
                raise RuntimeError("engine is shut down")
            mux = self._mux
        # a whole utterance (one event a tick at most) and slack
        q = queue.Queue(maxsize=mux.max_frames // mux.C + 4)
        try:
            h = mux.open(seed, sid, ids, sigma=float(sigma),
                         temperature=(1.0 if temperature is None
                                      else float(temperature)),
                         max_frames=n_frames)
        except MuxFull:
            self._count("rejected_overload")
            raise EngineOverloaded(
                "all mux stream slots busy; retry later") from None
        with self._mux_lock:
            self._mux_routes[h] = q
        self._mux_wake.set()
        return h, q

    def _stream_gen_mux(self, segments, sid, sigma, seed, n_frames,
                        temperature, denoise):
        """The mux counterpart of ``_stream_gen``. The first segment's
        slot is opened now (429 before the 200 header, as the pool's
        checkout); a split stream's later segments wait for a free slot
        between ticks. Segment ``si`` is seeded ``seed + si``, as in the
        pool."""
        den, mux = self._denoiser, self._mux
        h0, q0 = self._mux_open_routed(int(seed), sid, segments[0], sigma,
                                       temperature, n_frames)
        self._count("stream_requests")

        def pcm16(samples):
            return (np.clip(samples, -1.0, 1.0) * 32767).astype(np.int16)

        def consume():
            hq = (h0, q0)
            try:
                for si, ids in enumerate(segments):
                    if hq is None:
                        deadline = time.time() + self.stream_stall_timeout
                        while True:
                            try:
                                hq = self._mux_open_routed(
                                    int(seed) + si, sid, ids, sigma,
                                    temperature, n_frames)
                                break
                            except EngineOverloaded:
                                if time.time() > deadline:
                                    return      # truncated: no free slot
                                time.sleep(0.05)
                    _h, q = hq
                    sd = StreamingDenoiser(den, strength=denoise) \
                        if denoise else None
                    while True:
                        try:
                            item = q.get(
                                timeout=self.stream_stall_timeout + 60)
                        except queue.Empty:
                            # the stepper dropped this route without an
                            # error: end the stream (an HTTP caller sees
                            # its end) rather than raise mid-response
                            _log.debug("mux consumer timed out; ending "
                                       "the stream")
                            return
                        if isinstance(item, Exception):
                            raise item
                        audio, done = item
                        if sd is not None:
                            audio = sd.feed(audio)
                        if audio.size:
                            yield pcm16(audio)
                        if done:
                            break
                    if sd is not None:
                        tail = sd.flush()
                        if tail.size:
                            yield pcm16(tail)
                    hq = None
            finally:
                if hq is not None:      # the consumer left mid-stream
                    mux.close(hq[0])
                    with self._mux_lock:
                        self._mux_routes.pop(hq[0], None)

        return consume()

    def _warm_mux(self):
        """One throwaway stream through the mux (its stepper runs it).
        Returns the streams run: 0 when real traffic holds every slot."""
        try:
            _h, q = self._mux_open_routed(
                0, 0, np.ones((4,), np.int64), 0.5, None,
                min(self.n_frames, 3 * self._mux.C))
        except EngineOverloaded:
            return 0
        while True:
            item = q.get(timeout=600)
            if isinstance(item, Exception):
                raise item
            if item[1]:
                return 1
