"""Request-shaping primitives shared across the serving package:
typed HTTP-mappable errors and the sentence splitter (a copy of
flowtron_tpu/serve/common.py)."""

import logging
import re

_log = logging.getLogger("flowtron_tpu_torch.serve")


class TextTooLong(ValueError):
    """Request text exceeds the largest compiled text bucket (HTTP 413).

    Replaces the former silent ids[:Tk] truncation: a paragraph-length
    request must never return audio for its prefix as if it were the
    whole input.
    """

    def __init__(self, n_ids, max_ids):
        super().__init__(
            f"text is {n_ids} symbols after the frontend; the largest "
            f"bucket is {max_ids}. Shorten the text or pass "
            f"\"split\": true to sentence-split server-side.")
        self.n_ids = n_ids
        self.max_ids = max_ids


class EngineOverloaded(RuntimeError):
    """Request queue is full (HTTP 429)."""


class UnknownModel(ValueError):
    """Request named a model that is not loaded (HTTP 404)."""

    def __init__(self, name, known):
        super().__init__(f"unknown model {name!r}; loaded models: "
                         f"{sorted(known)} (see GET /models)")


_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;:])\s+")

# queue sentinel: wakes the dispatcher (which forwards it to the
# completion thread) so shutdown() can join both workers cleanly
_SHUTDOWN = object()


def split_measured(text, measure, max_ids):
    """Split text into [(segment, ids)] with len(ids) <= max_ids.

    `measure(segment) -> ids` may be STOCHASTIC (the frontend's
    per-word ARPAbet coin flip at 0 < p_arpabet < 1), so each final
    segment is measured exactly once and those ids are what the caller
    must enqueue — re-measuring could re-roll over the budget. Packing
    uses per-sentence counts measured once (O(n) frontend work, not
    O(n^2) over growing candidates); a packed segment that still
    over-measures (join effects / re-rolls) is bisected at word
    boundaries. Raises TextTooLong only when a single word exceeds the
    budget.
    """
    pieces = []

    def emit(seg):
        ids = measure(seg)
        if len(ids) == 0:
            return
        if len(ids) <= max_ids:
            pieces.append((seg, ids))
            return
        words = seg.split()
        if len(words) <= 1:
            raise TextTooLong(len(ids), max_ids)
        mid = len(words) // 2
        emit(" ".join(words[:mid]))
        emit(" ".join(words[mid:]))

    sentences = [s for s in _SENTENCE_SPLIT.split(text.strip()) if s]
    units = [(s, len(measure(s))) for s in sentences]
    cur, cur_n = [], 0
    for s, n in units:
        if cur and cur_n + 1 + n > max_ids:
            emit(" ".join(cur))
            cur, cur_n = [], 0
        cur_n += (1 if cur else 0) + n
        cur.append(s)
    if cur:
        emit(" ".join(cur))
    return pieces
