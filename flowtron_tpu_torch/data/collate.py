"""Batch collation and batch iterators (port of flowtron_tpu/data/collate.py,
pure numpy): pad, build gate targets, optionally bucket shapes.

Matches reference:data.py:191-246 (sort by text length descending, zero
padding, gate target = 1 from the last real frame onward) plus
``pad_to_multiple``, which rounds the padded time/text axes up to a small
set of shapes (bucketed padding; the masks make the extra frames inert).
"""

import numpy as np


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class DataCollate:
    def __init__(self, n_frames_per_step=1, use_attn_prior=False,
                 pad_to_multiple=1):
        self.n_frames_per_step = n_frames_per_step
        self.use_attn_prior = use_attn_prior
        self.pad_to_multiple = pad_to_multiple

    def __call__(self, batch):
        """batch: list of (mel (80,T), sid, text_ids, prior|None).

        Returns dict of numpy arrays:
          mel (B,80,T), speaker_ids (B,), text (B,Tk), in_lens (B,),
          out_lens (B,), gate_target (B,T), attn_prior (B,T,Tk)|None.
        """
        # sort by text length, descending (reference parity)
        order = np.argsort([-len(x[2]) for x in batch], kind="stable")
        batch = [batch[i] for i in order]

        max_input_len = max(len(x[2]) for x in batch)
        max_target_len = max(x[0].shape[1] for x in batch)
        if max_target_len % self.n_frames_per_step != 0:
            max_target_len = _round_up(max_target_len,
                                       self.n_frames_per_step)
        if self.pad_to_multiple > 1:
            max_input_len = _round_up(max_input_len, self.pad_to_multiple)
            max_target_len = _round_up(max_target_len, self.pad_to_multiple)

        B = len(batch)
        n_mel = batch[0][0].shape[0]
        text_padded = np.zeros((B, max_input_len), np.int64)
        mel_padded = np.zeros((B, n_mel, max_target_len), np.float32)
        gate_padded = np.zeros((B, max_target_len), np.float32)
        in_lens = np.zeros((B,), np.int64)
        out_lens = np.zeros((B,), np.int64)
        speaker_ids = np.zeros((B,), np.int64)
        attn_prior = None
        if self.use_attn_prior:
            attn_prior = np.zeros((B, max_target_len, max_input_len),
                                  np.float32)

        for i, (mel, sid, text, prior) in enumerate(batch):
            text_padded[i, :len(text)] = text
            in_lens[i] = len(text)
            T = mel.shape[1]
            mel_padded[i, :, :T] = mel
            gate_padded[i, T - 1:] = 1.0
            out_lens[i] = T
            speaker_ids[i] = sid
            if self.use_attn_prior:
                attn_prior[i, :prior.shape[0], :prior.shape[1]] = prior

        return {
            "mel": mel_padded,
            "speaker_ids": speaker_ids,
            "text": text_padded,
            "in_lens": in_lens,
            "out_lens": out_lens,
            "gate_target": gate_padded,
            "attn_prior": attn_prior,
        }


class PrefetchIterator:
    """Wraps a batch iterable with a background producer thread so host-side
    data work (wav decode, STFT, priors) overlaps device steps — the role
    of the reference's DataLoader worker process (reference:train.py:77)."""

    def __init__(self, iterable, depth=2):
        self.iterable = iterable
        self.depth = depth

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        import queue
        import threading

        q = queue.Queue(maxsize=self.depth)
        _END = object()

        def producer():
            try:
                for item in self.iterable:
                    q.put(item)
                q.put(_END)
            except BaseException as e:  # surface worker errors to consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()


class BatchIterator:
    """Shuffling batch iterator with drop_last (the reference's
    DataLoader and DistributedSampler roles, reference:train.py:74-77).
    Each epoch draws the next permutation of one seeded generator.

    ``num_shards`` / ``shard_index``: the per-process sharding of a
    data-parallel run, as the JAX package's: every process draws the same
    seeded permutation and takes the stride ``idx[shard_index::
    num_shards]``, padded by wrap-around to equal length so that every
    process steps in lockstep; ``batch_size`` is the per-process batch.
    With stride sharding the processes' batches at step i together are
    the one-process batch of ``num_shards * batch_size`` at step i.
    """

    def __init__(self, dataset, batch_size, collate_fn, shuffle=True,
                 seed=1234, drop_last=True, num_shards=1, shard_index=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self._rng = np.random.default_rng(seed)

    def _shard_len(self):
        n = len(self.dataset)
        if self.num_shards == 1:
            return n
        return (n + self.num_shards - 1) // self.num_shards

    def __len__(self):
        n = self._shard_len()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if self.num_shards > 1:
            idx = idx[self.shard_index::self.num_shards]
            idx = np.resize(idx, self._shard_len())  # pad by wrap-around
        end = (len(idx) - len(idx) % self.batch_size if self.drop_last
               else len(idx))
        for s in range(0, end, self.batch_size):
            chunk = idx[s:s + self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])
