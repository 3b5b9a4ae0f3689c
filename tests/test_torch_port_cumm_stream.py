"""A cumulative-attention model streamed and muxed in the port
(infer/streaming.py, infer/multistream.py with the seven-entry carry)
against the JAX package at toy widths, fed the same draws: two flows,
the prelude on the loop (K1 takes no cumulative attention)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_port_cumm import _pair  # noqa: E402
from tests.test_torch_port_multistream import (  # noqa: E402
    _both, _streams,
)
from tests.test_torch_port_streaming import (  # noqa: E402
    _gate_threshold, _inputs, _stream_both, wg,  # noqa: F401
)


@pytest.fixture(scope="module")
def two_flows():
    return _pair(2, 4)


def test_cumm_stream_matches_jax(two_flows):
    """StreamingMelSynthesizer: the prelude (the gated backward flow) on
    the loop, flow 0 chunk by chunk with its carry; n_valid identical,
    frames within 1e-4 of JAX's streamer."""
    residual, sids, text = _inputs(2, 32, 21, Tk=6)
    thresh = _gate_threshold(*two_flows[1], residual, sids, text, 6)
    out = _stream_both(*two_flows, residual, sids, text, 8, thresh, 32)
    (jc, jnv), (pc, pnv) = out["jax"], out["port"]
    np.testing.assert_array_equal(pnv, jnv)
    np.testing.assert_allclose(np.concatenate(pc, axis=2),
                               np.concatenate(jc, axis=2), atol=1e-4)


def test_cumm_mux_matches_jax(two_flows, wg):
    """Three cumulative-attention streams of 24 frames (three chunks) in
    the multistream mux, one joining after two ticks, against JAX's
    MultiStreamTTS fed the same draws: n_valid identical, audio within
    1e-4 of its scale."""
    ss = _streams(3, 5, 5)
    opens = [(70 + i, sid, ids, 1.0) for i, (sid, ids) in enumerate(ss)]
    jaxs, port = _both(*two_flows, wg, 3, 1e6, opens[:2], opens[2:],
                       max_frames=24)
    for p, j in zip(port, jaxs):
        assert len(p) == len(j) == 24 * 256
        np.testing.assert_allclose(p, j, atol=1e-4 * np.abs(j).max())
