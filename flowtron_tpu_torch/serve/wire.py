"""Byte-level transport helpers: WAV container framing and the request
body bound (the batch path's part of flowtron_tpu/serve/wire.py; its
WebSocket framing and chunked-WAV header come with the streaming
endpoints). The WAV is written with the standard library's ``wave``, the
same 44-byte PCM16 header scipy writes, so the first response pays no
scipy import."""

import io
import wave

import numpy as np


def _wav_bytes(wav_int16, sr):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(np.asarray(wav_int16, "<i2").tobytes())
    return buf.getvalue()


_HTTP_MAX_BODY = 1 << 20  # text requests are <=128-id buckets


class _BodyTooLarge(Exception):
    def __init__(self, length):
        super().__init__(f"request body {length} bytes exceeds "
                         f"{_HTTP_MAX_BODY}")
