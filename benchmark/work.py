"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes each layer's work needs, counted once from the algorithm's shapes
(each input byte read once, each output byte written once), whatever
implements it.

One yardstick serves every precision: no body can beat the H100's dense
bf16 tensor-core rate, so no share of it can pass 100%.
"""

# NVIDIA H100 SXM data sheet, dense (no sparsity): bf16 tensor-core
# operations a second, and HBM3 bytes a second
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def bound_s(flops, n_bytes):
    """The least time the chip could take for the work: the larger of
    operations over the peak rate and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def flow_weights(mc, gated):
    """Weight elements a flow multiplies each frame and row: the attention
    LSTM, the query, the decoder LSTMs, the dense stack, the coupling head
    and (on the gated flow) the gate."""
    H, A, M = mc["n_hidden"], mc["n_attn_channels"], mc["n_mel_channels"]
    n = 4 * H * M + 4 * H * H + A * H + 2 * M * H + 2 * H * H
    for k in range(mc["n_lstm_layers"]):
        n += 4 * H * ((H + A) if k == 0 else H) + 4 * H * H
    return n + (H + A if gated else 0)


def flow_frame_flops(mc, gated, n_keys):
    """One frame of one row through a flow: 2 per weight element, and 6 per
    (text position, attention channel) for the additive scores and the
    context."""
    return 2 * flow_weights(mc, gated) + 6 * n_keys * mc["n_attn_channels"]


def k1_work(mc, dtype, B, N, Tk, in_lens, gated):
    """A flow inverted over N frames of B rows (kernel K1's call): (flops,
    bytes). The weights, latents, projected keys and values and the key
    mask read once, in the served dtype; mel, attention and gates written
    once in fp32."""
    s = DTYPE_BYTES[dtype]
    A, M = mc["n_attn_channels"], mc["n_mel_channels"]
    flops = N * sum(flow_frame_flops(mc, gated, int(n)) for n in in_lens)
    n_bytes = (s * (flow_weights(mc, gated) + N * B * M + 2 * B * Tk * A)
               + 4 * B * Tk + 4 * (N * B * M + N * B * Tk + N * B))
    return flops, n_bytes


def k2_work(wc, dtype, B, T, layer):
    """One gated WaveNet layer (kernel K2's call) over B x T squeezed
    steps: the dilated conv (3 taps, C -> 2C) and the res/skip product
    (C -> 2C, C on the last layer); x, its conditioning slice and the
    weights read once, x' (not on the last layer) and the skip written
    once, in the served dtype."""
    s = DTYPE_BYTES[dtype]
    C, L = wc["n_channels"], wc["n_layers"]
    n_rs = 2 * C if layer < L - 1 else C
    flops = 2 * B * T * (3 * C * 2 * C + C * n_rs)
    n_bytes = s * (B * T * C + B * T * 2 * C + 6 * C * C + 2 * C
                   + C * n_rs + n_rs
                   + B * T * C * (2 if layer < L - 1 else 1))
    return flops, n_bytes


def encoder_flops(mc, n):
    """The text encoder over n positions: three k=5 convs and a BiLSTM,
    and each flow's key and value projections."""
    E, S, A = mc["n_text_dim"], mc["n_speaker_dim"], mc["n_attn_channels"]
    h = E // 2
    flops = n * (3 * 2 * 5 * E * E + 2 * 2 * (4 * h * E + 4 * h * h))
    return flops + mc["n_flows"] * n * 2 * 2 * (E + S) * A


def waveglow_flops(wc, frames):
    """WaveGlow's inverse over ``frames`` mel frames: the upsampling
    transposed conv (4 taps of 80 x 80 a sample), and per flow the start,
    conditioning, WaveNet layers, end and inverse 1x1 convolutions."""
    M, G, C, L = (wc["n_mel_channels"], wc["n_group"], wc["n_channels"],
                  wc["n_layers"])
    T = frames * 256 // G
    flops = 2 * frames * 256 * M * M * (1024 // 256)
    n_rem = G
    for f in range(wc["n_flows"]):
        if f % wc["n_early_every"] == 0 and f > 0:
            n_rem -= wc["n_early_size"]
        half = n_rem // 2
        flops += 2 * T * (C * half + 2 * C * L * M * G + 2 * half * C
                          + n_rem * n_rem)
        flops += sum(k2_work(wc, "float32", 1, T, k)[0] for k in range(L))
    return flops


def request_flops(mc, wc, n_keys, frames):
    """A request's model work: the encoder, every flow over its frames,
    WaveGlow over its samples."""
    flows = sum(frames * flow_frame_flops(mc, f == mc["n_flows"] - 1,
                                          n_keys)
                for f in range(mc["n_flows"]))
    return encoder_flops(mc, n_keys) + flows + waveglow_flops(wc, frames)
