"""The gate-interleaved row order that K1 (csrc/decoder.cu) and the
probes' chain kernels (csrc/resident.cu, csrc/fused_cost.cu) read: one
warp takes a quad of packed rows, the four gates of one unit."""


def interleave_gates(t):
    """Rows of ``t`` (dim 0, 4n of them) in gate-major order, row
    c * n + u holding gate c of unit u, reordered unit-major: row 4u + c.
    Works for weights (rows of any width) and for biases or scales (1-D);
    returns a tensor of ``t``'s shape."""
    n = t.shape[0] // 4
    return t.reshape(4, n, *t.shape[1:]).transpose(0, 1).reshape(t.shape)
