"""The serving engine: the request queue that micro-batches concurrent
requests into one synthesis chain on the device (port of the batch path
of flowtron_tpu/serve/engine.py; see the package docstring for the
protocol).

This file owns construction and lifecycle (``submit``, ``metrics``,
``warmup``, ``shutdown``) and the request chain itself,
``_synth_vocode``: latents -> flows -> gate masking -> WaveGlow ->
peak-normalised int16, the counterpart of the JAX engine's one jitted
dispatch (flowtron_tpu/serve/engine.py:153-253). PyTorch runs it eagerly:
there is nothing to compile, and ``warmup`` runs one dummy batch per
(batch bucket, text bucket) to set up the kernels and allocator.
dispatch.py owns the dispatcher/completion thread pair.

Options of the JAX engine that are not ported raise NotImplementedError
naming their ROADMAP.md item.
"""

import math
import queue
import threading
import time

import numpy as np
import torch

from flowtron_tpu_torch.data.frontend import TextFrontend
from flowtron_tpu_torch.infer.quantize import (
    MODES, quantize_flows_for_inference,
)
from flowtron_tpu_torch.infer.sampling import load_model_for_inference
from flowtron_tpu_torch.models.flowtron import flowtron_infer
from flowtron_tpu_torch.serve.common import (
    EngineOverloaded, TextTooLong, _SHUTDOWN, split_measured,
)
from flowtron_tpu_torch.serve.dispatch import DispatchMixin
from flowtron_tpu_torch.utils.device import resolve_device
from flowtron_tpu_torch.vocoder.waveglow import (
    load_waveglow, waveglow_infer_z, waveglow_n_remaining,
)

HOP = 256
MEL_FLOOR = math.log(1e-5)      # mel past a request's n_valid
WG_SIGMA = 0.8
VOCODER_STREAM = 1986           # separates vocoder from mel latents


def _refuse_unported(waveglow_path, bf16, mesh_shape, replicas,
                     vocode_buckets, denoise, stream_mux):
    refusals = [
        (not waveglow_path, "an engine without a vocoder (Griffin-Lim)",
         "Queue 1, deferred item 1 (Griffin-Lim / STFT)"),
        (bf16, "bf16", "Queue 1, deferred item 3 (bf16 kernels)"),
        (mesh_shape, "mesh_shape", "Queue 1, slice C item 23"),
        (int(replicas or 1) > 1, "replicas > 1", "Queue 1, slice C item 23"),
        (vocode_buckets, "vocode_buckets", "Queue 1, slice C item 22"),
        (denoise, "denoise", "Queue 1, slice C item 21"),
        (stream_mux, "stream_mux", "Queue 1, slice C item 18"),
    ]
    for on, what, item in refusals:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet; see ROADMAP.md {item}")


def mel_latents(seed, sigma, n_mel, n_frames):
    """A request's (1, n_mel, n_frames) latents, drawn as
    ``infer/sampling.py:synthesize`` draws them."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn(1, n_mel, n_frames, generator=g) * float(sigma)


def vocoder_latents(seed, wg_cfg, n_frames):
    """A request's WaveGlow latents at the full ``n_frames`` length:
    (z_main (n_remaining, Tg), [z_early (n_early_size, Tg) or None per
    flow]), sigma 0.8. Their generator is seeded from (seed, 1986), apart
    from the mel latents' (``seed``), as the JAX engine folds 1986 into
    the request key; drawing at full length and slicing keeps a request's
    audio independent of the batch it lands in."""
    entropy = np.random.SeedSequence([int(seed) % 2 ** 64, VOCODER_STREAM])
    g = torch.Generator().manual_seed(int(entropy.generate_state(1)[0]))
    Tg = n_frames * HOP // wg_cfg["n_group"]
    z_main = WG_SIGMA * torch.randn(waveglow_n_remaining(wg_cfg), Tg,
                                    generator=g)
    z_early = [WG_SIGMA * torch.randn(wg_cfg["n_early_size"], Tg,
                                      generator=g)
               if f % wg_cfg["n_early_every"] == 0 and f > 0 else None
               for f in range(wg_cfg["n_flows"])]
    return z_main, z_early


class SynthesisEngine(DispatchMixin):
    """Batched synthesis over fixed shape buckets: batches are padded to a
    power of two, texts to the smallest text bucket that holds them."""

    def __init__(self, config, flowtron_path, waveglow_path="",
                 max_batch=8, batch_timeout_ms=20.0, text_buckets=(64, 128),
                 n_frames=400, int8=False, quantize="", fused=False,
                 max_queue=64, device=None, bf16=False, mesh_shape=None,
                 replicas=1, vocode_buckets=None, denoise=0.0,
                 stream_mux=0):
        _refuse_unported(waveglow_path, bf16, mesh_shape, replicas,
                         vocode_buckets, denoise, stream_mux)
        qmode = quantize or ("w8" if int8 else "")
        if qmode and qmode not in MODES:
            raise ValueError(f"quantize {qmode!r}; expected one of {MODES}")
        self.device = resolve_device(device)
        self.config = config
        self.data_config = dict(config["data_config"])
        self.n_frames = int(n_frames)
        self.max_batch = int(max_batch)
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.text_buckets = sorted(text_buckets)
        self.fused = "early" if fused else False
        self.quantize = qmode

        self.model, self.static_cfg = load_model_for_inference(
            config, flowtron_path, self.device)
        if qmode:
            self.model = quantize_flows_for_inference(self.model, mode=qmode)
        self.wg, self.wg_cfg = load_waveglow(waveglow_path, self.device)
        self.frontend = TextFrontend.from_config(self.data_config)

        self._metrics = {"requests": 0, "batches": 0, "errors": 0,
                         "audio_seconds": 0.0, "rejected_too_long": 0,
                         "rejected_overload": 0, "text_clamped": 0}
        self._recent_batch_ms = []
        self._metrics_lock = threading.Lock()
        self._closed = False
        # makes the closed-check + enqueue atomic against shutdown()
        self._lifecycle_lock = threading.Lock()
        # bounded: overload returns 429 instead of unbounded latency
        self._queue = queue.Queue(maxsize=max(1, int(max_queue)))
        # dispatch/complete pipeline: at most one batch waits behind the
        # one the completion thread is fetching
        self._inflight = queue.Queue(maxsize=1)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._completer.start()

    can_stream = False      # the streaming endpoints are not ported yet

    def _count(self, name, by=1):
        with self._metrics_lock:
            self._metrics[name] += by

    # -- the request chain -------------------------------------------------
    @torch.no_grad()
    def _synth_vocode(self, seeds, sigmas, sids, text, in_lens, temperature,
                      frames_cap):
        """One batch from host arrays to device tensors: (pcm (B, n_frames
        * 256) int16, n_valid (B,)). Launches the work and returns without
        waiting for it (the completion thread copies to the host)."""
        dev, N = self.device, self.n_frames
        n_mel = self.static_cfg["n_mel_channels"]
        residual = torch.cat([mel_latents(s, sg, n_mel, N)
                              for s, sg in zip(seeds, sigmas)]).to(dev)
        if np.ndim(temperature):
            temperature = torch.as_tensor(temperature, device=dev)
        mel, _, n_valid = flowtron_infer(
            self.model, self.static_cfg, residual,
            torch.as_tensor(sids, device=dev), torch.as_tensor(text,
                                                               device=dev),
            temperature=temperature, gate_threshold=0.5,
            in_lens=torch.as_tensor(in_lens, device=dev), fused=self.fused)
        # per-request n_frames caps before vocoding, so peak normalisation
        # sees exactly the returned region
        n_valid = torch.minimum(n_valid.clamp(min=1),
                                torch.as_tensor(frames_cap, device=dev))
        valid_f = torch.arange(N, device=dev)[None, :] < n_valid[:, None]
        mel = torch.where(valid_f[:, None, :], mel, MEL_FLOOR)
        Tg = N * HOP // self.wg_cfg["n_group"]
        zs = [vocoder_latents(s, self.wg_cfg, self.n_frames) for s in seeds]
        z_main = torch.stack([z[:, :Tg] for z, _ in zs]).to(dev)
        z_early = [None if zs[0][1][f] is None else
                   torch.stack([e[f][:, :Tg] for _, e in zs]).to(dev)
                   for f in range(self.wg_cfg["n_flows"])]
        audio = waveglow_infer_z(self.wg, self.wg_cfg, mel, z_main, z_early)
        valid = torch.arange(audio.shape[1], device=dev)[None, :] \
            < (n_valid * HOP)[:, None]
        peak = (audio.abs() * valid).amax(dim=1, keepdim=True)
        out = audio / peak.clamp(min=1e-8) * valid
        pcm = torch.clamp(out * 32767.0, -32767, 32767).to(torch.int16)
        return pcm, n_valid

    # -- request path -----------------------------------------------------
    def _text_to_ids(self, text):
        """Frontend + validation. Raises ValueError on empty text,
        TextTooLong past the largest bucket."""
        ids = self.frontend.get_text(text)
        if len(ids) == 0:
            raise ValueError("empty text after cleaning")
        if len(ids) > self.text_buckets[-1]:
            raise TextTooLong(len(ids), self.text_buckets[-1])
        return ids

    def submit(self, text, speaker_id=0, sigma=0.5, seed=1234,
               n_frames=None, temperature=None, split=False,
               denoise=None):
        """Blocking: returns (wav_int16, sample_rate).

        Raises TextTooLong when the text exceeds the largest bucket,
        unless split=True: then it is sentence-split, the segments are
        enqueued together (they coalesce into one micro-batch) and the
        audio is concatenated. Raises EngineOverloaded when the request
        queue is full.
        """
        if self._closed:
            raise RuntimeError("engine is shut down")
        if denoise is not None:
            raise ValueError(
                "per-request denoise needs the denoiser, which is not "
                "ported yet; see ROADMAP.md Queue 1, slice C item 21")
        try:
            pieces = [(text, self._text_to_ids(text))]
        except TextTooLong:
            if not split:
                self._count("rejected_too_long")
                raise
            try:
                pieces = split_measured(text, self.frontend.get_text,
                                        self.text_buckets[-1])
            except TextTooLong:
                self._count("rejected_too_long")  # a single huge word
                raise
            if not pieces:
                raise ValueError("empty text after cleaning")

        slots = []
        for i, (_seg, ids) in enumerate(pieces):
            done = threading.Event()
            slot = {}
            item = (ids, speaker_id, sigma, int(seed) + i, n_frames,
                    temperature, slot, done)
            with self._lifecycle_lock:
                if self._closed:  # atomic vs shutdown's queue drain
                    for s, _d in slots:
                        s["cancelled"] = True
                    raise RuntimeError("engine is shut down")
                try:
                    self._queue.put_nowait(item)
                except queue.Full:
                    self._count("rejected_overload")
                    # already-queued segments have no waiter: mark them
                    # so the dispatcher skips their synthesis
                    for s, _d in slots:
                        s["cancelled"] = True
                    raise EngineOverloaded(
                        f"request queue full ({self._queue.maxsize}); "
                        "retry later")
            slots.append((slot, done))
        for slot, done in slots:
            done.wait()
        for slot, _ in slots:
            if "error" in slot:
                raise RuntimeError(slot["error"])
        wav = np.concatenate([slot["wav"] for slot, _ in slots]) \
            if len(slots) > 1 else slots[0][0]["wav"]
        return wav, self.data_config["sampling_rate"]

    @property
    def queue_depth(self):
        return self._queue.qsize()

    def metrics(self):
        with self._metrics_lock:
            recent = list(self._recent_batch_ms)
            out = dict(self._metrics)
        out["queue_depth"] = self.queue_depth
        if recent:
            r = sorted(recent)
            out["batch_ms_p50"] = round(r[len(r) // 2], 1)
            out["batch_ms_p90"] = round(r[int(len(r) * 0.9)], 1)
        return out

    # -- lifecycle --------------------------------------------------------
    def batch_buckets(self):
        """The batch sizes the dispatcher pads to: powers of two up to
        ``max_batch``."""
        out, B = [], 1
        while B <= self.max_batch:
            out.append(B)
            B *= 2
        return out

    def warmup(self):
        """Run one dummy batch through the request chain for every (batch
        bucket, text bucket) pair and wait for each, so the first real
        request pays no kernel build, cuBLAS/cuDNN set-up or allocator
        growth. Uniform temperature (the K1 path on an unquantized
        model)."""
        n = 0
        t0 = time.time()
        for B in self.batch_buckets():
            for Tk in self.text_buckets:
                text = np.zeros((B, Tk), np.int64)
                text[:, 0] = 1
                pcm, n_valid = self._synth_vocode(
                    np.zeros(B, np.int64), np.full(B, 0.5, np.float32),
                    np.zeros(B, np.int64), text, np.ones(B, np.int64), 1.0,
                    np.full(B, self.n_frames, np.int64))
                pcm.cpu(), n_valid.cpu()
                n += 1
        return {"batches": n, "seconds": round(time.time() - t0, 2)}

    def shutdown(self, timeout=60.0):
        """Stop serving and drop the model. New submits raise at once;
        requests already dispatched complete. Safe to call twice."""
        with self._lifecycle_lock:
            if self._closed:
                return
            self._closed = True
        # wake the dispatcher (it forwards the sentinel to the completion
        # thread). A full queue can't block us forever: new submits are
        # refused, so drain-and-fail until the put lands.
        while True:
            try:
                self._queue.put_nowait(_SHUTDOWN)
                break
            except queue.Full:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    continue
                if item is not _SHUTDOWN:
                    self._fail_batch([item],
                                     RuntimeError("engine shut down"))
        self._worker.join(timeout)
        self._completer.join(timeout)
        # fail any requests that raced past the closed check after the
        # sentinel was consumed
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not _SHUTDOWN:
                self._fail_batch([item], RuntimeError("engine shut down"))
        self.model = self.wg = None
