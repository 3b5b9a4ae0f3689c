"""SynthesisEngine's micro-batching side: the dispatcher/completion
thread pair (port of flowtron_tpu/serve/dispatch.py:24-86, its batch
assembly, :95-157, its round-robin choice of a replica, :159-173, its
per-batch choice of staged vocoding, :175-198, and its completion,
:225-263: the one-pass chain, the staged vocode stage at the smallest
bucket that covers the batch, and, for an engine without a vocoder,
Griffin-Lim on the host). Under a serving mesh (engine.py's
``mesh_shape``) a batch is padded to a multiple of the D data groups, as
the JAX dispatcher pads to its mesh's data axis (:112-117), and split D
ways: each group runs its rows' chain on its devices, and the results
are concatenated on group 0's device. Mixed into SynthesisEngine
(engine.py)."""

import queue
import time

import numpy as np
import torch

from flowtron_tpu_torch.serve.common import _SHUTDOWN


class DispatchMixin:
    """The batching worker pipeline (see _loop/_complete_loop)."""

    def _bucket(self, n):
        for b in self.text_buckets:
            if n <= b:
                return b
        return self.text_buckets[-1]

    def _loop(self):
        """Dispatcher: gathers micro-batches and launches their device work
        without waiting for it. CUDA launches are asynchronous, so handing
        the result tensors to the completion thread lets the device run
        batch k+1 while batch k is copied to the host and handed out (the
        chain's own host syncs, cuDNN's packed lengths and WaveGlow's
        matrix inverses, bound that overlap today). The in-flight queue is
        bounded: under overload the dispatcher stops launching instead of
        piling up device work."""
        while True:
            first = self._queue.get()
            if first is _SHUTDOWN:
                self._inflight.put(_SHUTDOWN)
                return
            batch = [first]
            stop = False
            deadline = time.time() + self.batch_timeout
            while len(batch) < self.max_batch:
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                try:
                    item = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is _SHUTDOWN:
                    stop = True
                    break
                batch.append(item)
            t0 = time.time()
            try:
                handles = self._dispatch_batch(batch)
            except Exception as e:
                self._fail_batch(batch, e)
                handles = None
            if handles is not None:
                self._inflight.put((batch, handles, t0))
            if stop:
                self._inflight.put(_SHUTDOWN)
                return

    def _complete_loop(self):
        """Completion worker: copies each in-flight batch to the host
        (FIFO, in launch order), hands the audio to the waiting requests
        and records the metrics."""
        while True:
            item = self._inflight.get()
            if item is _SHUTDOWN:
                return
            batch, handles, t0 = item
            try:
                self._complete_batch(batch, handles)
                with self._metrics_lock:
                    self._metrics["requests"] += len(batch)
                    self._metrics["batches"] += 1
                    self._recent_batch_ms.append(
                        (time.time() - t0) * 1e3)
                    del self._recent_batch_ms[:-100]
            except Exception as e:
                self._fail_batch(batch, e)

    def _fail_batch(self, batch, e):
        with self._metrics_lock:
            self._metrics["errors"] += len(batch)
        for *_, slot, done in batch:
            slot["error"] = repr(e)
            done.set()

    def _dispatch_batch(self, batch):
        """Build the padded host arrays and launch the request chain.
        Returns the device result tensors for _complete_batch, or None
        when every request in the batch was cancelled. Does not wait for
        the device."""
        # drop segments whose submit aborted mid-split (overload): nobody
        # waits on them
        batch[:] = [item for item in batch
                    if not item[-2].get("cancelled")]
        if not batch:
            return None

        Tk = self._bucket(max(len(ids) for ids, *_ in batch))
        # bucket the batch dim to a power of two, then to the mesh's data
        # axis; padded rows duplicate row 0
        B = 1
        while B < len(batch):
            B *= 2
        m = self._batch_mult
        B = ((B + m - 1) // m) * m
        text_pad = np.zeros((B, Tk), np.int64)
        in_lens = np.zeros((B,), np.int64)
        sids = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        sigmas = np.full((B,), 0.5, np.float32)
        temps = np.ones((B,), np.float32)
        frames_cap = np.full((B,), self.n_frames, np.int64)
        strengths = np.full((B,), self._denoise, np.float32)
        for b, (ids, sid, sigma, seed, nf, temp, dstr, _, _) in \
                enumerate(batch):
            n = len(ids)
            if n > Tk:  # unreachable after validation; never truncate
                # silently: count and clamp
                self._count("text_clamped")
                n = Tk
            text_pad[b, :n] = ids[:n]
            in_lens[b] = n
            sids[b] = int(self.frontend.speaker_ids.get(int(sid), 0))
            seeds[b] = int(seed)
            sigmas[b] = float(sigma)
            if temp is not None:
                temps[b] = float(temp)
            if nf is not None:
                frames_cap[b] = max(1, min(int(nf), self.n_frames))
            strengths[b] = dstr
        for b in range(len(batch), B):
            text_pad[b], in_lens[b] = text_pad[0], in_lens[0]
            sids[b], seeds[b], sigmas[b] = sids[0], seeds[0], sigmas[0]
            temps[b] = temps[0]

        # temperature: a scalar when uniform (a flow then stays in kernel
        # K1's subset), (B, 1) otherwise (the per-frame loop)
        temp_arg = float(temps[0]) if np.all(temps == temps[0]) \
            else temps[:, None]
        if self._groups is not None:
            return self._mesh_chain(seeds, sigmas, sids, text_pad, in_lens,
                                    temp_arg, frames_cap, strengths)
        # the replica, round-robin (this thread only): the batch's whole
        # chain runs on its card while the others' batches proceed
        r = self._rr % self._n_replicas
        self._rr += 1
        rep = self._replicas[r]
        with self._metrics_lock:
            self._metrics["replica_batches"][r] += 1
        if self._staged(frames_cap[:len(batch)]):
            # the mel now; the completion thread reads n_valid and
            # vocodes at the smallest bucket that covers it
            mel, n_valid = self._synth_mel(seeds, sigmas, sids, text_pad,
                                           in_lens, temp_arg, frames_cap,
                                           rep)
            return "staged", (mel, seeds, strengths, rep), n_valid
        return self._synth_vocode(seeds, sigmas, sids, text_pad, in_lens,
                                  temp_arg, frames_cap, strengths, rep)

    def _mesh_chain(self, seeds, sigmas, sids, text, in_lens, temperature,
                    frames_cap, strengths):
        """The D-way split: rows [g n, (g + 1) n) of a batch of D n run on
        data group g; the outputs come back concatenated on group 0's
        device, as one chain's would."""
        n = len(seeds) // len(self._groups)
        outs = []
        for g, rep in enumerate(self._groups):
            r = slice(g * n, (g + 1) * n)
            temp = temperature if np.ndim(temperature) == 0 \
                else temperature[r]
            outs.append(self._synth_vocode(
                seeds[r], sigmas[r], sids[r], text[r], in_lens[r], temp,
                frames_cap[r], strengths[r], rep))
        dev = self._groups[0].device
        return (outs[0][0], torch.cat([o.to(dev) for _, o, _ in outs]),
                torch.cat([nv.to(dev) for _, _, nv in outs]))

    def _staged(self, frames_cap):
        """JAX's rule: stage a batch only when every request's n_frames
        cap fits a bucket below n_frames. A batch that ends only at the
        gate is not known to end early before its mel, so it stays on the
        one-pass chain."""
        return self._vocode_buckets is not None \
            and int(frames_cap.max()) <= self._vocode_buckets[-2]

    def _complete_batch(self, batch, handles):
        """Hand each request its int16 audio: the chain's PCM, a staged
        batch's PCM vocoded here at its bucket, or for an engine without a
        vocoder its mel vocoded here by Griffin-Lim and peak-normalised."""
        kind, out_dev, n_valid_dev = handles
        n_valid = n_valid_dev.cpu().numpy()     # waits; already capped
        if kind == "staged":
            mel, seeds, strengths, rep = out_dev
            need = max(1, int(n_valid[:len(batch)].max()))
            Nb = next(b for b in self._vocode_buckets if b >= need)
            out_dev = self._vocode_norm(mel[:, :, :Nb], n_valid_dev, seeds,
                                        strengths, rep)
            kind = "pcm"
            with self._metrics_lock:
                self._metrics["staged_batches"] += 1
                self._metrics["vocode_bucket_hits"][Nb] += 1
        out = out_dev.cpu().numpy()             # waits for the device
        for b, (*_, slot, done) in enumerate(batch):
            n = max(1, int(n_valid[b]))
            if kind == "pcm":
                slot["wav"] = out[b, :n * 256]
            else:
                audio = self._vocode(out[b, :, :n])
                audio = audio / max(1e-8, float(np.abs(audio).max()))
                slot["wav"] = (audio * 32767).astype(np.int16)
            done.set()
        with self._metrics_lock:
            self._metrics["audio_seconds"] += float(
                np.maximum(1, n_valid[:len(batch)]).sum() * 256
                / self.data_config["sampling_rate"])
