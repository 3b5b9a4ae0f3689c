"""Byte-level transport helpers (port of flowtron_tpu/serve/wire.py): WAV
container framing, the chunked stream's WAV header, a minimal RFC 6455
WebSocket codec (standard library only) and the request body bound. The
WAV is written with the standard library's ``wave``, the same 44-byte
PCM16 header scipy writes, so the first response pays no scipy import."""

import base64
import hashlib
import io
import struct
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


def _wav_stream_header(sr):
    """RIFF/WAVE header with unknown (0xFFFFFFFF) sizes, the convention for
    live PCM16 mono streams; players read to EOF."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt " +
            struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16) +
            b"data" + struct.pack("<I", 0xFFFFFFFF))


# -- minimal RFC 6455 WebSocket framing -------------------------------------

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_WS_MAX_FRAME = 1 << 20  # the only inbound payload is a small JSON body
_HTTP_MAX_BODY = 1 << 20  # text requests are <=128-id buckets


def _ws_accept_key(key):
    return base64.b64encode(
        hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()


def _ws_send(wfile, payload, opcode):
    """One unmasked server->client frame (FIN set). opcode: 1 text,
    2 binary, 8 close."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    wfile.write(head + payload)
    wfile.flush()


def _ws_recv(rfile):
    """One client->server frame -> (opcode, payload), unmasked. Returns
    (None, b'') on EOF or on a frame larger than _WS_MAX_FRAME (a
    client-supplied 64-bit length must not drive an unbounded read)."""
    h = rfile.read(2)
    if len(h) < 2:
        return None, b""
    opcode = h[0] & 0x0F
    masked = h[1] & 0x80
    n = h[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", rfile.read(2))[0]
    elif n == 127:
        n = struct.unpack(">Q", rfile.read(8))[0]
    if n > _WS_MAX_FRAME:
        return None, b""
    mask = rfile.read(4) if masked else b"\x00" * 4
    data = rfile.read(n)
    if masked:
        data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
    return opcode, data


class _BodyTooLarge(Exception):
    def __init__(self, length):
        super().__init__(f"request body {length} bytes exceeds "
                         f"{_HTTP_MAX_BODY}")
