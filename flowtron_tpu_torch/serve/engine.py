"""The serving engine: the request queue that micro-batches concurrent
requests into one synthesis chain on the device, and the stream path
(a pool of warm streamer pairs, or with ``stream_mux`` the batched
multiplexer of infer/multistream.py) (port of
flowtron_tpu/serve/engine.py; see the package docstring for the
protocol).

This file owns construction and lifecycle (``submit``, ``metrics``,
``warmup``, ``shutdown``) and the request chain itself in two stages:
``_synth_mel``, latents -> flows -> gate masking, and ``_vocode_norm``,
WaveGlow (-> the denoiser with per-request strengths) -> peak-normalised
int16, the counterparts of the JAX engine's ``synth_mel`` and
``vocode_norm`` (flowtron_tpu/serve/engine.py:153-253). A batch runs
both at the engine's ``n_frames``, unless staged vocoding
(``vocode_buckets``) lets the completion thread vocode it at the
smallest bucket that covers its frames (dispatch.py). Without a vocoder
the chain ends at the masked mel, and the completion thread vocodes each
request with Griffin-Lim on the host (flowtron_tpu/serve/dispatch.py:
204-214, :250-263). PyTorch runs it eagerly: there is nothing to
compile, and ``warmup`` runs one dummy batch per (batch bucket, text
bucket) to set up the kernels and allocator. dispatch.py owns the
dispatcher/completion thread pair, streaming.py the stream path.

``replicas`` R > 1 (flowtron_tpu/serve/engine.py:315-342): R copies of
the model, its vocoder and denoiser, one a visible card (replica 0 on the
engine's device, replica r on ``local_devices()[r]``); the dispatcher
hands micro-batches to them round-robin, each batch's whole chain on its
replica's card, with up to 2R - 1 batches in flight, so every card keeps
its own double buffer. ``replica_batches`` in ``metrics()`` counts the
batches each replica took. Warmup runs a replica at a time; the warm
streamer pairs are spread over the replicas; the mux runs on replica 0.
R above the number of cards clamps to it with the JAX engine's warning.

``bf16`` (flowtron_tpu/serve/engine.py:82-117): the JAX engine's cast
rule (``utils/weights.py:to_bf16``): every fp32 leaf of the flows and
of the vocoder goes to bf16, a quantized leaf keeps its int payload and
fp32 scales; the request latents are drawn in fp32 and then cast; the
streamers, the mux and the denoiser's bias pass run the bf16 model. Then
K1, K2 and K4 run their bf16 bodies on the card.

``mesh_shape`` (D, M) (flowtron_tpu/serve/engine.py:51-70, :267-290):
the JAX engine's data x model mesh over ``devices`` (default: every
visible card in order; fewer than D x M raises, naming the count; a list
may repeat a device). Data group g takes devices[g M:(g + 1) M]: a copy
of the model on its first device whose flows' weights that JAX shards
are split over the group's M devices (``utils/weights.py:shard_flows``,
after quantizing and the bf16 cast, as JAX places its params), the
encoder, embedding and speaker table whole there, and a copy of the
vocoder and denoiser there. A batch is padded to a multiple of D and
split D ways (dispatch.py), each group running its rows' whole chain. As
the JAX engine, a mesh prints three warnings and takes three decisions:
replicas ignored, ``vocode_buckets`` off, ``fused`` off (so kernel K1
never sees a sharded weight: the flows run the per-frame loop, whose dots
multiply the slices on their devices). Streams and the mux run on data
group 0.
"""

import copy
import queue
import threading
import time
import warnings

import numpy as np
import torch

from flowtron_tpu_torch.data.frontend import TextFrontend
from flowtron_tpu_torch.infer.quantize import (
    MODES, quantize_flows_for_inference,
)
from flowtron_tpu_torch.infer.sampling import (
    load_model_for_inference, mel_to_audio_griffinlim,
)
from flowtron_tpu_torch.infer.multistream import MultiStreamTTS
from flowtron_tpu_torch.infer.streaming import (
    HOP, SILENCE, StreamingMelSynthesizer, StreamingVocoder,
    stream_generators,
)
from flowtron_tpu_torch.models.flowtron import flowtron_infer
from flowtron_tpu_torch.serve.common import (
    EngineOverloaded, TextTooLong, _SHUTDOWN, _log, split_measured,
)
from flowtron_tpu_torch.serve.dispatch import DispatchMixin
from flowtron_tpu_torch.serve.streaming import StreamPathMixin
from flowtron_tpu_torch.utils.device import resolve_device
from flowtron_tpu_torch.utils.weights import shard_flows, to_bf16
from flowtron_tpu_torch.vocoder.denoiser import Denoiser
from flowtron_tpu_torch.vocoder.waveglow import (
    load_waveglow, waveglow_infer_z, waveglow_n_remaining,
)

WG_SIGMA = 0.8
GL_ITERS = 20                   # Griffin-Lim iterations a served request


def mesh_devices(mesh_shape, devices):
    """The (D, M) mesh's data groups: [devices[g M:(g + 1) M] for g < D];
    raises when there are fewer than D x M devices, as the JAX engine's
    reshape of its devices does."""
    D, M = (int(x) for x in mesh_shape)
    devices = [torch.device(d) for d in devices]
    if len(devices) < D * M:
        raise ValueError(
            f"mesh_shape ({D}, {M}) needs {D * M} devices; {len(devices)} "
            f"given ({', '.join(map(str, devices))})")
    return [devices[g * M:(g + 1) * M] for g in range(D)]


def local_devices(device):
    """The devices replicas may take: every visible card when ``device``
    is a CUDA device, else ``device`` alone."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class Replica:
    """One copy of the request chain's weights on one device."""

    def __init__(self, device, model, wg, denoiser):
        self.device, self.model, self.wg, self.denoiser = (
            device, model, wg, denoiser)


def mel_latents(seed, sigma, n_mel, n_frames):
    """A request's (1, n_mel, n_frames) latents, drawn as
    ``infer/sampling.py:synthesize`` draws them."""
    g = torch.Generator().manual_seed(int(seed))
    return torch.randn(1, n_mel, n_frames, generator=g) * float(sigma)


def vocoder_latents(seed, wg_cfg, n_frames):
    """A request's WaveGlow latents at the full ``n_frames`` length:
    (z_main (n_remaining, Tg), [z_early (n_early_size, Tg) or None per
    flow]), sigma 0.8. Their generator is a stream's vocoder generator
    (``stream_generators``: seeded from (seed, 1986), apart from the mel
    latents' ``seed``), as the JAX engine folds 1986 into the request
    key; drawing at full length and slicing keeps a request's audio
    independent of the batch it lands in."""
    g = stream_generators(seed)[1]
    Tg = n_frames * HOP // wg_cfg["n_group"]
    z_main = WG_SIGMA * torch.randn(waveglow_n_remaining(wg_cfg), Tg,
                                    generator=g)
    z_early = [WG_SIGMA * torch.randn(wg_cfg["n_early_size"], Tg,
                                      generator=g)
               if f % wg_cfg["n_early_every"] == 0 and f > 0 else None
               for f in range(wg_cfg["n_flows"])]
    return z_main, z_early


class SynthesisEngine(StreamPathMixin, DispatchMixin):
    """Batched synthesis over fixed shape buckets: batches are padded to a
    power of two, texts to the smallest text bucket that holds them. With
    a vocoder, ``stream_workers`` warm streamer pairs serve ``stream``, or
    with ``stream_mux`` N > 0 one N-slot multiplexer driven by a stepper
    thread (``mux_joins_per_tick`` K > 0 joins at most K streams a tick).
    ``vocode_buckets`` (mel frames) turns on staged vocoding."""

    # seconds a stream waits for a free streamer pair before 429, and a
    # stalled consumer (a dead client) may hold its pair
    stream_acquire_timeout = 5.0
    stream_stall_timeout = 30.0

    def __init__(self, config, flowtron_path, waveglow_path="",
                 max_batch=8, batch_timeout_ms=20.0, text_buckets=(64, 128),
                 n_frames=400, int8=False, quantize="", fused=False,
                 max_queue=64, device=None, bf16=False, mesh_shape=None,
                 replicas=1, vocode_buckets=None, denoise=0.0,
                 stream_mux=0, mux_joins_per_tick=0, stream_workers=2,
                 devices=None):
        if mesh_shape and replicas and int(replicas) > 1:
            # replicas are independent single-device programs, a mesh one
            # program over the devices: the JAX engine lets the mesh win
            print("WARNING: --replicas is incompatible with --mesh; "
                  "ignoring replicas")
            replicas = 1
        if mesh_shape and vocode_buckets:
            print("WARNING: --vocode-buckets is not supported with "
                  "--mesh; using the one-dispatch chain")
            vocode_buckets = None
        if mesh_shape and fused:
            # kernel K1 takes whole weights; the mesh's flows are sharded
            print("WARNING: --fused is incompatible with --mesh "
                  "(VMEM-resident kernel vs TP-sharded weights); "
                  "disabling fused")
            fused = False
        qmode = quantize or ("w8" if int8 else "")
        if qmode and qmode not in MODES:
            raise ValueError(f"quantize {qmode!r}; expected one of {MODES}")
        if denoise and not waveglow_path:
            raise ValueError("denoise needs a WaveGlow vocoder (-w)")
        self.device = resolve_device(device)
        self.config = config
        self.data_config = dict(config["data_config"])
        self.n_frames = int(n_frames)
        self.max_batch = int(max_batch)
        self.batch_timeout = batch_timeout_ms / 1000.0
        self.text_buckets = sorted(text_buckets)
        self.fused = "early" if fused else False
        self.quantize = qmode
        self.bf16 = bool(bf16)
        self._dtype = torch.bfloat16 if self.bf16 else torch.float32

        self.model, self.static_cfg = load_model_for_inference(
            config, flowtron_path, self.device)
        if qmode:
            self.model = quantize_flows_for_inference(self.model, mode=qmode)
        self.wg = self.wg_cfg = None
        if waveglow_path:
            self.wg, self.wg_cfg = load_waveglow(waveglow_path, self.device)
        if self.bf16:
            # before the replicas and the denoiser are made from them
            to_bf16(self.model)
            if self.wg is not None:
                to_bf16(self.wg)
        self.frontend = TextFrontend.from_config(self.data_config)

        # the mesh's data groups, each a Replica on its first device with
        # its flows sharded over the group (the denoisers come below)
        self._groups = None
        self._batch_mult = 1
        if mesh_shape:
            groups = mesh_devices(mesh_shape, devices if devices is not None
                                  else local_devices(self.device))
            self._groups = []
            for g, devs in enumerate(groups):     # copies before sharding
                own = g == 0 and devs[0] == self.device
                model = self.model if own else \
                    copy.deepcopy(self.model).to(devs[0])
                wg = self.wg if own or self.wg is None else \
                    copy.deepcopy(self.wg).to(devs[0])
                self._groups.append(Replica(devs[0], model, wg, None))
            for rep, devs in zip(self._groups, groups):
                shard_flows(rep.model, devs)
            self._batch_mult = len(groups)
            self.device = groups[0][0]
            self.model, self.wg = self._groups[0].model, self._groups[0].wg

        # the WaveGlow bias denoiser (-d): its bias spectrum is estimated
        # once here; the batch chain subtracts it on the device, streams
        # through a host StreamingDenoiser
        self._denoise = float(denoise or 0.0)
        self._denoiser = None
        if self._denoise > 0:
            self._denoiser = Denoiser.from_data_config(
                self.wg, self.wg_cfg, self.data_config)
            for g, rep in enumerate(self._groups or ()):
                rep.denoiser = self._denoiser if g == 0 else \
                    Denoiser.from_data_config(rep.wg, self.wg_cfg,
                                              self.data_config)

        # data-parallel replicas: one copy of the chain a card
        R = max(1, int(replicas or 1))
        devs = local_devices(self.device)
        if R > len(devs):
            print(f"WARNING: --replicas {R} > {len(devs)} local devices; "
                  "clamping")
            R = len(devs)
        self._replicas = [Replica(self.device, self.model, self.wg,
                                  self._denoiser)]
        for dev in devs[1:R]:
            wg = None if self.wg is None else copy.deepcopy(self.wg).to(dev)
            self._replicas.append(Replica(
                dev, copy.deepcopy(self.model).to(dev), wg,
                None if self._denoiser is None else Denoiser.from_data_config(
                    wg, self.wg_cfg, self.data_config)))
        self._n_replicas = R
        self._rr = 0            # round-robin cursor (dispatcher thread only)

        # staged vocoding: the buckets end at n_frames
        self._vocode_buckets = None
        if vocode_buckets and self.wg is not None:
            bs = sorted({int(b) for b in vocode_buckets
                         if 0 < int(b) < self.n_frames})
            if bs:
                self._vocode_buckets = tuple(bs) + (self.n_frames,)
            else:
                warnings.warn(f"vocode_buckets has no bucket below n_frames="
                              f"{self.n_frames}; staged vocoding disabled",
                              stacklevel=2)

        # the stream path: the multiplexer (one stepper thread, started at
        # the end of __init__), else a pool of warm streamer pairs, one a
        # concurrent stream (beyond that a stream waits for a pair, then
        # 429)
        self._mux = None
        self._mux_routes = {}
        self._mux_lock = threading.Lock()
        if self.wg is not None and int(stream_mux or 0) > 0:
            self._mux = MultiStreamTTS(
                self.model, self.static_cfg, self.wg, self.wg_cfg,
                slots=int(stream_mux), chunk_frames=40,
                text_len=self.text_buckets[-1], max_frames=self.n_frames,
                gate_threshold=0.5, wg_sigma=WG_SIGMA, fused=self.fused,
                max_joins_per_tick=(int(mux_joins_per_tick)
                                    if int(mux_joins_per_tick or 0) > 0
                                    else None))
            self._mux_wake = threading.Event()
            self._mux_thread = threading.Thread(target=self._mux_loop,
                                                daemon=True)
        self._stream_workers = max(1, int(stream_workers))
        self._stream_pool = None
        if self.wg is not None and self._mux is None:
            # warm streamer pairs spread over the replicas' cards, each
            # with the device its stream's inputs go to
            self._stream_pool = queue.Queue()
            for i in range(self._stream_workers):
                rep = self._replicas[i % R]
                self._stream_pool.put((
                    StreamingMelSynthesizer(
                        rep.model, self.static_cfg, chunk_frames=40,
                        gate_threshold=0.5, max_frames=self.n_frames,
                        fused=self.fused),
                    StreamingVocoder(rep.wg, self.wg_cfg, sigma=WG_SIGMA,
                                     max_frames=self.n_frames),
                    rep.device))

        self._metrics = {"requests": 0, "batches": 0, "errors": 0,
                         "audio_seconds": 0.0, "stream_requests": 0,
                         "rejected_too_long": 0, "rejected_overload": 0,
                         "text_clamped": 0, "stream_stalls": 0,
                         "replica_batches": [0] * R,
                         "staged_batches": 0,
                         "vocode_bucket_hits": dict.fromkeys(
                             self._vocode_buckets or (), 0)}
        self._recent_batch_ms = []
        self._metrics_lock = threading.Lock()
        self._closed = False
        # makes the closed-check + enqueue atomic against shutdown()
        self._lifecycle_lock = threading.Lock()
        # bounded: overload returns 429 instead of unbounded latency
        self._queue = queue.Queue(maxsize=max(1, int(max_queue)))
        # dispatch/complete pipeline: at most one batch waits behind the
        # one the completion thread is fetching; with R replicas 2R - 1,
        # so every card keeps its own double buffer
        self._inflight = queue.Queue(maxsize=2 * R - 1)
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self._completer = threading.Thread(target=self._complete_loop,
                                           daemon=True)
        self._completer.start()
        if self._mux is not None:
            self._mux_thread.start()

    def _count(self, name, by=1):
        with self._metrics_lock:
            self._metrics[name] += by

    # -- the request chain -------------------------------------------------
    def _synth_vocode(self, seeds, sigmas, sids, text, in_lens, temperature,
                      frames_cap, strengths, rep=None):
        """One batch from host arrays to device tensors in one pass: ("pcm",
        (B, n_frames * 256) int16, n_valid (B,)), or without a vocoder
        ("mel", the masked (B, n_mel, n_frames) mel, n_valid).
        ``strengths`` (B,) are the denoiser's. Runs on replica ``rep``
        (replica 0 by default). Launches the work and returns without
        waiting for it (the completion thread copies to the host)."""
        mel, n_valid = self._synth_mel(seeds, sigmas, sids, text, in_lens,
                                       temperature, frames_cap, rep)
        if self.wg is None:
            # the host's Griffin-Lim takes fp32 (numpy has no bf16)
            return "mel", mel.float(), n_valid
        return "pcm", self._vocode_norm(mel, n_valid, seeds, strengths,
                                        rep), n_valid

    @torch.no_grad()
    def _synth_mel(self, seeds, sigmas, sids, text, in_lens, temperature,
                   frames_cap, rep=None):
        """The mel stage: latents -> flows -> n_valid capped by each
        request's ``frames_cap`` -> frames past it silenced. Returns the
        device tensors (mel (B, n_mel, n_frames), n_valid (B,)) on
        replica ``rep``'s device."""
        rep = rep or self._replicas[0]
        dev, N = rep.device, self.n_frames
        n_mel = self.static_cfg["n_mel_channels"]
        # drawn in fp32, then cast (JAX's dispatch.py:207-208)
        residual = torch.cat([mel_latents(s, sg, n_mel, N)
                              for s, sg in zip(seeds, sigmas)]).to(
                                  dev, self._dtype)
        if np.ndim(temperature):
            temperature = torch.as_tensor(temperature, device=dev)
        mel, _, n_valid = flowtron_infer(
            rep.model, self.static_cfg, residual,
            torch.as_tensor(sids, device=dev), torch.as_tensor(text,
                                                               device=dev),
            temperature=temperature, gate_threshold=0.5,
            in_lens=torch.as_tensor(in_lens, device=dev), fused=self.fused)
        # per-request n_frames caps before vocoding, so peak normalisation
        # sees exactly the returned region
        n_valid = torch.minimum(n_valid.clamp(min=1),
                                torch.as_tensor(frames_cap, device=dev))
        valid_f = torch.arange(N, device=dev)[None, :] < n_valid[:, None]
        return torch.where(valid_f[:, None, :], mel, SILENCE), n_valid

    @torch.no_grad()
    def _vocode_norm(self, mel, n_valid, seeds, strengths, rep=None):
        """The vocode stage at the mel's own length (n_frames, or a staged
        bucket): WaveGlow on each request's latents (drawn at n_frames and
        sliced, so its audio does not depend on the bucket) -> the
        denoiser -> peak-normalised int16 over its n_valid frames. Returns
        the device (B, frames * 256) PCM, on replica ``rep``'s device."""
        rep = rep or self._replicas[0]
        dev = rep.device
        Tg = mel.shape[2] * HOP // self.wg_cfg["n_group"]
        zs = [vocoder_latents(s, self.wg_cfg, self.n_frames) for s in seeds]
        dt = self._dtype
        z_main = torch.stack([z[:, :Tg] for z, _ in zs]).to(dev, dt)
        z_early = [None if zs[0][1][f] is None else
                   torch.stack([e[f][:, :Tg] for _, e in zs]).to(dev, dt)
                   for f in range(self.wg_cfg["n_flows"])]
        audio = waveglow_infer_z(rep.wg, self.wg_cfg, mel, z_main,
                                 z_early).float()
        if rep.denoiser is not None:
            T = audio.shape[1]
            audio = rep.denoiser(audio, strength=torch.as_tensor(
                strengths, device=dev)[:, None, None])
            # the ISTFT's framing can shorten the tail: back to T samples,
            # so the sample mask below lines up
            audio = torch.nn.functional.pad(
                audio, (0, max(0, T - audio.shape[1])))[:, :T]
        valid = torch.arange(audio.shape[1], device=dev)[None, :] \
            < (n_valid * HOP)[:, None]
        peak = (audio.abs() * valid).amax(dim=1, keepdim=True)
        out = audio / peak.clamp(min=1e-8) * valid
        return torch.clamp(out * 32767.0, -32767, 32767).to(torch.int16)

    def _vocode(self, mel):
        """Griffin-Lim for an engine without a vocoder: one request's
        (n_mel, n) host mel -> float32 audio, on the host."""
        return mel_to_audio_griffinlim(mel, self.data_config,
                                       n_iters=GL_ITERS)

    def _request_denoise(self, denoise):
        """A request's denoiser strength: its own ``denoise``, which only
        an engine started with -d takes, else the engine's."""
        if denoise is None:
            return self._denoise
        if self._denoiser is None:
            raise ValueError(
                "per-request denoise requires an engine started with -d "
                "(the bias spectrum is estimated at init)")
        return float(denoise)

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
        queue is full. ``denoise`` overrides the engine's -d strength for
        this request (only on an engine started with -d).
        """
        if self._closed:
            raise RuntimeError("engine is shut down")
        denoise = self._request_denoise(denoise)
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
                    temperature, denoise, slot, done)
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
            out["replica_batches"] = list(out["replica_batches"])
            out["vocode_bucket_hits"] = {
                str(k): v for k, v in out["vocode_bucket_hits"].items()}
        out["queue_depth"] = self.queue_depth
        if self._mux is not None:
            out["mux_active_streams"] = self.active_mux_streams
            out["mux_slots"] = self._mux.slots
        if recent:
            r = sorted(recent)
            out["batch_ms_p50"] = round(r[len(r) // 2], 1)
            out["batch_ms_p90"] = round(r[int(len(r) * 0.9)], 1)
        return out

    # -- lifecycle --------------------------------------------------------
    def batch_buckets(self):
        """The batch sizes the dispatcher pads to: powers of two up to
        ``max_batch``, each rounded up to a multiple of the mesh's data
        groups."""
        out, B, m = [], 1, self._batch_mult
        while B <= self.max_batch:
            out.append(((B + m - 1) // m) * m)
            B *= 2
        return sorted(set(out))

    def warmup(self):
        """Run one dummy batch through the request chain for every (batch
        bucket, text bucket) pair and wait for each, so the first real
        request pays no kernel build, cuBLAS/cuDNN set-up or allocator
        growth; with replicas, on each replica in turn. Uniform temperature (the K1 path on an unquantized
        model). With staged vocoding, also the vocode stage at each bucket
        below n_frames for every batch bucket; with the mux, one
        throwaway stream through it."""
        n = staged = 0
        t0 = time.time()
        for rep, B, Tk in ((rep, B, Tk) for rep in self._replicas
                           for B in self.batch_buckets()
                           for Tk in self.text_buckets):
            text = np.zeros((B, Tk), np.int64)
            text[:, 0] = 1
            seeds = np.zeros(B, np.int64)
            strengths = np.full(B, self._denoise, np.float32)
            args = (seeds, np.full(B, 0.5, np.float32), np.zeros(B, np.int64),
                    text, np.ones(B, np.int64), 1.0,
                    np.full(B, self.n_frames, np.int64))
            if self._groups is not None:
                _, out, n_valid = self._mesh_chain(*args, strengths)
            else:
                mel, n_valid = self._synth_mel(*args, rep)
                out = mel if self.wg is None else self._vocode_norm(
                    mel, n_valid, seeds, strengths, rep)
            out.cpu(), n_valid.cpu()
            n += 1
            if self._vocode_buckets is not None \
                    and Tk == self.text_buckets[0]:
                for Nb in self._vocode_buckets[:-1]:
                    self._vocode_norm(mel[:, :, :Nb], n_valid, seeds,
                                      strengths, rep).cpu()
                    staged += 1
        done = {"batches": n}
        if staged:
            done["staged_vocodes"] = staged
        if self._mux is not None:
            done["mux_streams"] = self._warm_mux()
        done["seconds"] = round(time.time() - t0, 2)
        return done

    def shutdown(self, timeout=60.0):
        """Stop serving and drop the model. New submits and streams raise
        at once; requests already dispatched complete; active streams run
        to their end before their streamer pair is reclaimed. Safe to call
        twice. Afterwards nothing of the engine holds device memory: the
        streamer pairs, the mux and the replicas are dropped with the
        model, the vocoder and the denoiser, and the kernels' weight packs
        go with their modules (K1's cached on each flow, K2's on the WN
        stack and keyed weakly by the weight in ops/wavenet.py); the
        caches in ops/ key on shapes only."""
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
        # reclaim the streamer pairs: each active stream returns its pair
        # when it finishes (stream() refuses new checkouts once closed)
        pool = self._stream_pool
        if pool is not None:
            deadline = time.time() + timeout
            got = 0
            while got < self._stream_workers and time.time() < deadline:
                try:
                    pool.get(timeout=0.2)
                    got += 1
                except queue.Empty:
                    pass
            self._stream_pool = None
        if self._mux is not None:
            # stop the stepper, then fail the consumers still waiting
            self._mux_wake.set()
            self._mux_thread.join(timeout)
            with self._mux_lock:
                routes, self._mux_routes = self._mux_routes, {}
            for q in routes.values():
                try:
                    q.put_nowait(RuntimeError("engine shut down"))
                except queue.Full:
                    _log.debug("shutdown sentinel dropped on a full mux "
                               "route")
            self._mux = None
        self.model = self.wg = self._denoiser = None
        self._replicas = []
        self._groups = None
