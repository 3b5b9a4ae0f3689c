"""P2, port of scripts/exp_int4_variants.py: which int4 dequant
formulation keeps the AR scan weight-streaming-bound? Times a STEPS-long
scan ``carry = 0.999 * carry + 0.001 * y[:, :IN]`` (bf16) of x @ dequant(W)
on the decoder-LSTM-sized weight (1664 x 4096) for several variants.

    python -m flowtron_tpu_torch.scripts.exp_int4_variants [B] [STEPS]

The script's four XLA baselines (``dot_w8``, ``dot_w4_rows``,
``dot_w4_perchan``, ``dot_w4_cols``) stay plain PyTorch here: bf16
dequantization and a cuBLAS bf16 product. Its two Pallas bodies run
through csrc/w4.cu (ops/w4.py: ``k_w4_concat`` as "concat",
``k_w4_2dot`` as "2dot"). On the card the baselines' scans are replayed
step for step from CUDA graphs (a cuBLAS step finishes faster than
Python launches it); the kernels' scans run eagerly, so their launch
counters count every launch (their printed times hold some host time:
the Python step takes about as long as the kernel).
"""

import sys

import numpy as np
import torch

from flowtron_tpu_torch.ops.w4 import unpack_int4, w4_matmul
from flowtron_tpu_torch.scripts import _probe
from flowtron_tpu_torch.utils.device import resolve_device

IN, OUT, STEPS = 1664, 4096, 2000
B = 64
G = 128


def _pack_rows(q):
    """Row-halves packing: low nibble row r, high nibble row r + IN/2."""
    half = q.shape[0] // 2
    return ((q[:half] & 0xF) | ((q[half:] & 0xF) << 4)).astype(np.int8)


def make_inputs(B=B, IN=IN, OUT=OUT):
    """The script's ``main`` inputs, drawn and quantized as it does them,
    as numpy arrays: {variant: (x, q, s)} with x (B, IN) fp32 (bf16 on
    the way in)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((IN, OUT)).astype(np.float32)
    x = rng.standard_normal((B, IN)).astype(np.float32)
    s8 = np.abs(w).max(0) / 127.0
    q8 = np.clip(np.round(w / s8), -127, 127).astype(np.int8)
    s8 = s8.astype(np.float32)
    ng = IN // G
    wg = w.reshape(ng, G, OUT)
    s4 = np.abs(wg).max(1) / 7.0
    q = np.clip(np.round(wg / s4[:, None, :]), -7, 7).astype(np.int32)
    q4r = _pack_rows(q.reshape(IN, OUT))
    s4 = s4.astype(np.float32)
    s4c = np.abs(w).max(0) / 7.0
    qc = np.clip(np.round(w / s4c), -7, 7).astype(np.int32)
    q4c = _pack_rows(qc)
    lo = qc[:, : OUT // 2] & 0xF
    hi = (qc[:, OUT // 2:] & 0xF) << 4
    q4col = (lo | hi).astype(np.int8)
    s4c = s4c.astype(np.float32)
    ng2 = IN // 64
    wg2 = w.reshape(ng2, 64, OUT)
    s64 = np.abs(wg2).max(1) / 7.0
    qg = np.clip(np.round(wg2 / s64[:, None, :]), -7, 7).astype(np.int32)
    q4r2 = _pack_rows(qg.reshape(IN, OUT))
    s64 = s64.astype(np.float32)
    return {"w8": (x, q8, s8), "w4_rows": (x, q4r, s4),
            "w4_perchan": (x, q4c, s4c), "w4_cols": (x, q4col, s4c),
            "pallas_concat": (x, q4r, s4), "pallas_2dot": (x, q4r2, s64)}


def _bf(t):
    return t.to(torch.bfloat16)


def dot_w8(x, q, s):
    """The script's int8 baseline: bf16(q * bf16(s)), a bf16 product."""
    return x @ (_bf(q) * _bf(s))


def dot_w4_rows(x, q, s):
    lo, hi = unpack_int4(q)
    full = _bf(torch.cat([lo, hi], 0))
    ng = s.shape[0]
    wd = (full.reshape(ng, -1, full.shape[1]) * _bf(s)[:, None, :]
          ).reshape(full.shape)
    return x @ wd


def dot_w4_perchan(x, q, s):
    lo, hi = unpack_int4(q)
    return x @ (_bf(torch.cat([lo, hi], 0)) * _bf(s))


def dot_w4_cols(x, q, s):
    lo, hi = unpack_int4(q)
    sb = _bf(s)
    half = s.shape[0] // 2
    return torch.cat([x @ (_bf(lo) * sb[:half]), x @ (_bf(hi) * sb[half:])],
                     -1)


def pallas(body):
    def dot(x, q, s):
        return w4_matmul(x, q, s, body)
    return dot


# (printed name, input set, dot, scan in a CUDA graph) in the script's order
VARIANTS = [
    ("w8 per-channel (baseline)", "w8", dot_w8, True),
    ("w4 rows+concat+groups", "w4_rows", dot_w4_rows, True),
    ("w4 rows+concat perchan", "w4_perchan", dot_w4_perchan, True),
    ("w4 col-pack 2mm perchan", "w4_cols", dot_w4_cols, True),
    ("w4 PALLAS concat+groups", "pallas_concat", pallas("concat"), False),
    ("w4 PALLAS 2dot g64", "pallas_2dot", pallas("2dot"), False),
]


def scan_step(dot, q, s):
    """One step of the script's ``scan_of(dot_fn)`` body."""
    def step(carry):
        return _probe.bf16_carry(carry, dot(carry, q, s)[:, :carry.shape[1]])
    return step


def main(argv=None, device=None, B=B, IN=IN, OUT=OUT):
    """Prints the script's lines; returns {input set: (us a step, final
    carry)}."""
    argv = sys.argv[1:] if argv is None else argv
    B, steps = _probe.parse_args(argv, [B, STEPS])
    dev = resolve_device(device)
    inputs = make_inputs(B, IN, OUT)
    results = {}
    for name, key, dot, graph in VARIANTS:
        x, q, s = inputs[key]
        x = _probe.tensor(x, dev, torch.bfloat16)
        q, s = _probe.tensor(q, dev), _probe.tensor(s, dev)
        us, carry = _probe.time_per_step(
            _probe.scan(scan_step(dot, q, s), x, steps, graph), steps)
        results[key] = (us, carry)
        print(f"{name:28s}: {us:7.2f} us/step", flush=True)
    return results


if __name__ == "__main__":
    main()
