// K1: one flow's whole inverse autoregressive scan, fp32.
//
// Replaces flowtron_tpu/ops/decoder_pallas.py:fused_flow_infer (the Pallas
// kernel _make_kernel, called at :334), with the semantics of :136-223:
// per frame, the attention-LSTM cell on the previous output frame, the
// query, additive attention (v . tanh(q + k) / temperature, key mask to
// -1e9, max-subtracted softmax, context), the gate sigmoid on
// [h_att, ctx] (last flow only), n decoder LSTM cells, the tanh dense
// stack, the coupling head and out = (z - b) * exp(-log_s).
//
// What bounds it on an H100: weight bytes. One flagship flow holds about
// 26.8 M fp32 parameters (107 MB), more than the 50 MB L2 and far more
// than the 227 KB of shared memory of one SM, so unlike the TPU kernel
// (which keeps the whole flow resident in VMEM) every frame streams all
// weights from HBM: at 3.35 TB/s that is a floor of about 32 us per
// flow-frame (an estimate, not a measurement). Batch rows reuse each
// weight row once it is loaded, so B=1..8 costs about the same bytes.
//
// What the design does about it (a simple first version):
// - One host call per flow. The C entry below loops over frames on the
//   host and launches a fixed sequence of 4 + n_layers + n_dense short
//   kernels per frame on the caller's stream (8 at flagship width), so
//   Python is out of the frame loop.
// - Weights are packed once at load time (ops/decoder.py) so that each
//   warp reads whole contiguous rows with 16-byte loads: a row of the
//   (out, in) layout is one dot product. LSTM rows are interleaved
//   (row 4u+g is gate g of unit u) so one warp owns one hidden unit,
//   computes its four gate rows for every batch row, and applies the
//   cell itself: the matvec and the cell are one kernel.
// - The inputs [x ; h] of a block are staged in shared memory, each
//   segment zero-padded to a multiple of 4 floats; weights are padded to
//   match, so the dot loop needs no tail.
// - h is double-buffered across frames (blocks of one launch read h_prev
//   while others write h_new); c is updated in place, each element by
//   the one thread that owns it.
// - Up to 8 batch rows share one pass over the weights; more rows run as
//   further groups in gridDim.y.
// - Early exit: a device int done_at (initially "never") is set to t by
//   the head kernel once every stream's done flag is set (gate fired, or
//   t + 1 >= n_valid_in). Every kernel of frame t' > done_at returns at
//   once; the attention kernel writes attn = 0 and gate = 1 and the head
//   kernel writes mel = 0 for those frames, so no output is left
//   unwritten (decoder_pallas.py:216-223 does the same per chunk; here
//   the granularity is one frame).
//
// wgmma/TMA and a persistent kernel with grid-wide barriers are left to
// later work; this version is plain SIMT fp32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;          // batch rows per pass over the weights
constexpr int kAttnThreads = 1024;  // the attention kernel is one block per row
constexpr float kMaskValue = -1e9f;

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Sum (or max) over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) r += red[i];
  __syncthreads();
  return r;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

// dst[b * Kp + off + k] = src[b * ld + k] for k < n, 0 for n <= k < npad.
// src == nullptr stages zeros (the t = 0 "previous frame").
__device__ void stage(float* dst, int Kp, int off, const float* src, int ld,
                      int n, int npad, int nb) {
  for (int i = threadIdx.x; i < nb * npad; i += blockDim.x) {
    const int b = i / npad, k = i - b * npad;
    dst[b * Kp + off + k] =
        (src != nullptr && k < n) ? src[(size_t)b * ld + k] : 0.f;
  }
}

// One warp: acc[r][b] = dot(W[row0 + r, :Kp], xs[b, :Kp]) for r < R, b < nb.
template <int R>
__device__ __forceinline__ void warp_dot(const float* __restrict__ W,
                                         int row0, int Kp, const float* xs,
                                         int nb, float (&acc)[R][kMaxB]) {
  const int lane = threadIdx.x & 31;
  const int K4 = Kp >> 2;
  const float4* x4 = reinterpret_cast<const float4*>(xs);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[r][b] = 0.f;
#pragma unroll 2
  for (int i = lane; i < K4; i += 32) {
    float4 w[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      w[r] = __ldg(reinterpret_cast<const float4*>(W + (size_t)(row0 + r) * Kp)
                   + i);
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < nb) {
        const float4 xv = x4[b * K4 + i];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][b] = fmaf(w[r].w, xv.w, fmaf(w[r].z, xv.z,
                      fmaf(w[r].y, xv.y, fmaf(w[r].x, xv.x, acc[r][b]))));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[r][b] = warp_sum(acc[r][b]);
}

// Value acc[r][lane] without dynamic register indexing.
template <int R>
__device__ __forceinline__ float pick(const float (&acc)[R][kMaxB], int r,
                                      int lane) {
  float v = 0.f;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b == lane) v = acc[r][b];
  return v;
}

// LSTM cell with its input matvec. W: (4H, Kxp + Hp), row 4u + g holds
// gate g (i, f, g, o) of unit u over [x (padded to Kxp) ; h (padded to
// Hp)]; bias (4H) the same interleave, b_ih + b_hh pre-summed.
// One warp per unit; grid (cdiv(H, kWarps), batch groups).
__global__ void lstm_kernel(const float* __restrict__ W,
                            const float* __restrict__ bias,
                            const float* x, int ldx, int Kx, int Kxp,
                            const float* h_prev, int ldh, int H, int Hp,
                            float* h_out, int ldo, float* c, int B, int t,
                            const int* done_at) {
  if (*done_at < t) return;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int g0 = blockIdx.y * kMaxB;
  const int nb = min(kMaxB, B - g0);
  const int Kp = Kxp + Hp;
  stage(xs, Kp, 0, x == nullptr ? nullptr : x + (size_t)g0 * ldx, ldx, Kx,
        Kxp, nb);
  stage(xs, Kp, Kxp, h_prev + (size_t)g0 * ldh, ldh, H, Hp, nb);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= H) return;
  float acc[4][kMaxB];
  warp_dot<4>(W, 4 * u, Kp, xs, nb, acc);
  if (lane < nb) {
    const int b = g0 + lane;
    const float gi = pick(acc, 0, lane) + bias[4 * u + 0];
    const float gf = pick(acc, 1, lane) + bias[4 * u + 1];
    const float gg = pick(acc, 2, lane) + bias[4 * u + 2];
    const float go = pick(acc, 3, lane) + bias[4 * u + 3];
    const float c_new = sigmoid(gf) * c[(size_t)b * H + u]
                        + sigmoid(gi) * tanhf(gg);
    c[(size_t)b * H + u] = c_new;
    h_out[(size_t)b * ldo + u] = sigmoid(go) * tanhf(c_new);
  }
}

// out[b, n] = act(dot(W[n], x[b]) + bias[n]); act 0 = identity, 1 = tanh.
// One warp per output row; grid (cdiv(N, kWarps), batch groups).
__global__ void matvec_kernel(const float* __restrict__ W,
                              const float* __restrict__ bias, const float* x,
                              int ldx, int K, int Kp, float* out, int ldo,
                              int N, int B, int act, int t,
                              const int* done_at) {
  if (*done_at < t) return;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  const int g0 = blockIdx.y * kMaxB;
  const int nb = min(kMaxB, B - g0);
  stage(xs, Kp, 0, x + (size_t)g0 * ldx, ldx, K, Kp, nb);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  float acc[1][kMaxB];
  warp_dot<1>(W, n, Kp, xs, nb, acc);
  if (lane < nb) {
    float v = pick(acc, 0, lane) + (bias != nullptr ? bias[n] : 0.f);
    if (act == 1) v = tanhf(v);
    out[(size_t)(g0 + lane) * ldo + n] = v;
  }
}

// Attention for one frame, one block per batch row b. dec_in (B, ld_dec)
// holds h_att in [:H] on entry; the context is written to [H:H+D]. Then
// the gate on [h_att, ctx] and this stream's done flag.
__global__ void attention_kernel(
    const float* q, const float* __restrict__ kp,
    const float* __restrict__ vals, const float* __restrict__ key_mask,
    const float* __restrict__ v_w, float* dec_in, int ld_dec, int H,
    const float* __restrict__ gate_w, const float* __restrict__ gate_b,
    float* attn_out, float* gate_out, int* done, const int* done_at,
    const int* n_valid_in, int D, int Tk, int t, float temperature,
    float gate_threshold, int early_exit) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (*done_at < t) {  // every stream finished earlier: skipped frame
    for (int k = tid; k < Tk; k += blockDim.x)
      attn_out[(size_t)b * Tk + k] = 0.f;
    if (tid == 0) gate_out[b] = 1.f;
    return;
  }
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // D
  float* ctx = qs + D;                           // D
  float* sc = ctx + D;                           // Tk
  __shared__ float red[32];
  for (int d = tid; d < D; d += blockDim.x) qs[d] = q[(size_t)b * D + d];
  __syncthreads();

  for (int k = warp; k < Tk; k += (int)(blockDim.x >> 5)) {
    const float* krow = kp + ((size_t)b * Tk + k) * D;
    float s = 0.f;
    for (int d = lane; d < D; d += 32) s += v_w[d] * tanhf(qs[d] + krow[d]);
    s = warp_sum(s);
    if (lane == 0) {
      s = s / temperature;
      sc[k] = key_mask[(size_t)b * Tk + k] > 0.5f ? s : kMaskValue;
    }
  }
  __syncthreads();
  float m = -INFINITY;
  for (int k = tid; k < Tk; k += blockDim.x) m = fmaxf(m, sc[k]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int k = tid; k < Tk; k += blockDim.x) {
    const float e = expf(sc[k] - m);
    sc[k] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its barriers order the sc writes above
  for (int k = tid; k < Tk; k += blockDim.x) {
    const float a = sc[k] / sum;
    sc[k] = a;
    attn_out[(size_t)b * Tk + k] = a;
  }
  __syncthreads();
  for (int d = tid; d < D; d += blockDim.x) {
    const float* vcol = vals + (size_t)b * Tk * D + d;
    float cval = 0.f;
    for (int k = 0; k < Tk; ++k) cval += sc[k] * vcol[(size_t)k * D];
    ctx[d] = cval;
    dec_in[(size_t)b * ld_dec + H + d] = cval;
  }
  __syncthreads();

  float gate = 0.f;
  if (gate_w != nullptr) {
    float g = 0.f;
    for (int j = tid; j < H; j += blockDim.x)
      g += dec_in[(size_t)b * ld_dec + j] * gate_w[j];
    for (int d = tid; d < D; d += blockDim.x) g += ctx[d] * gate_w[H + d];
    g = block_sum(g, red);
    gate = sigmoid(g + gate_b[0]);
  }
  if (tid == 0) {
    gate_out[b] = gate;
    if (early_exit && (gate > gate_threshold || t + 1 >= n_valid_in[b]))
      done[b] = 1;
  }
}

// Coupling head + inverse affine. W: (2M, Kp), rows (2m, 2m + 1) =
// (log_s_m, b_m); bias interleaved the same way. One warp per mel
// channel. Block (0, 0) also publishes done_at = t once every stream is
// done (it runs after this frame's attention kernel wrote the flags).
__global__ void head_kernel(const float* __restrict__ W,
                            const float* __restrict__ bias, const float* x,
                            int ldx, int K, int Kp, const float* z,
                            float* mel, int B, int M, int t, int* done_at,
                            const int* done, int early_exit) {
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.y * kMaxB;
  const int nb = min(kMaxB, B - g0);
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (*done_at < t) {
    if (m < M && lane < nb) mel[(size_t)(g0 + lane) * M + m] = 0.f;
    return;
  }
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  stage(xs, Kp, 0, x + (size_t)g0 * ldx, ldx, K, Kp, nb);
  __syncthreads();
  if (m < M) {
    float acc[2][kMaxB];
    warp_dot<2>(W, 2 * m, Kp, xs, nb, acc);
    if (lane < nb) {
      const size_t i = (size_t)(g0 + lane) * M + m;
      const float log_s = pick(acc, 0, lane) + bias[2 * m];
      const float bb = pick(acc, 1, lane) + bias[2 * m + 1];
      mel[i] = (z[i] - bb) * expf(-log_s);
    }
  }
  if (early_exit && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    int all = 1;
    for (int b = 0; b < B; ++b) all &= done[b];
    if (all) *done_at = t;
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

const char* decoder_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of workspace fused_flow_infer_f32 needs (the caller allocates
// it; the entry zeroes it), and ints of integer workspace.
long long decoder_workspace_floats(int B, int H, int D, int n_layers) {
  const long long L = H + D;
  return (long long)B * (2 * L + 3 * (long long)n_layers * H + 3 * H + D);
}

int decoder_workspace_ints(int B) { return B + 1; }

// One flow's inverse scan over N frames. Shapes (all fp32, contiguous):
//   z (N, B, M); kp, vals (B, Tk, D); key_mask (B, Tk); n_valid_in (B,)
//   int32; outputs mel (N, B, M), attn (N, B, Tk), gates (N, B).
// Packed weights (ops/decoder.py:pack_flow_weights), with P(n) = n
// rounded up to a multiple of 4:
//   att_w (4H, P(M) + P(H)), att_b (4H)          interleaved LSTM rows
//   q_w (D, P(H)), q_b (D), v_w (D)
//   lstm_w[l] (4H, P(K_l) + P(H)), lstm_b[l] (4H), K_0 = H + D, K_l = H
//   dense_w[i] (H, P(H)), dense_b[i] (H)
//   head_w (2M, P(H)), head_b (2M)              interleaved (log_s, b)
//   gate_w (H + D), gate_b (1), or both null when the flow has no gate.
// lstm_w, lstm_b, dense_w, dense_b are host arrays of device pointers.
int fused_flow_infer_f32(
    const float* z, const float* kp, const float* vals,
    const float* key_mask, const int* n_valid_in, const float* att_w,
    const float* att_b, const float* q_w, const float* q_b,
    const float* v_w, const float* const* lstm_w,
    const float* const* lstm_b, int n_layers, const float* const* dense_w,
    const float* const* dense_b, int n_dense, const float* head_w,
    const float* head_b, const float* gate_w, const float* gate_b,
    float* mel, float* attn, float* gates, float* work, int* iwork, int N,
    int B, int M, int H, int D, int Tk, float temperature,
    float gate_threshold, int early_exit, void* stream_handle) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int L = H + D;
  const int Hp = pad4(H), Mp = pad4(M), Lp = pad4(L);
  const int nbmax = B < kMaxB ? B : kMaxB;
  const int groups = cdiv(B, kMaxB);

  float* dec = work;                                   // 2 x (B, L)
  float* hl = dec + 2 * (size_t)B * L;                 // 2 x n_layers x (B, H)
  float* c_att = hl + 2 * (size_t)n_layers * B * H;    // (B, H)
  float* cl = c_att + (size_t)B * H;                   // n_layers x (B, H)
  float* qbuf = cl + (size_t)n_layers * B * H;         // (B, D)
  float* tmp = qbuf + (size_t)B * D;                   // 2 x (B, H)
  int* done = iwork;
  int* done_at = iwork + B;

  cudaError_t err;
  if ((err = cudaMemsetAsync(work, 0,
                             sizeof(float) * decoder_workspace_floats(
                                 B, H, D, n_layers), stream)))
    return err;
  if ((err = cudaMemsetAsync(done, 0, sizeof(int) * B, stream))) return err;
  // 0x7f7f7f7f: larger than any frame index, i.e. "never"
  if ((err = cudaMemsetAsync(done_at, 0x7f, sizeof(int), stream))) return err;

  const size_t lstm_smem = sizeof(float) * nbmax * (size_t)(Lp + Hp);
  const size_t att_smem = sizeof(float) * (2 * (size_t)D + Tk);
  if ((err = allow_smem((const void*)lstm_kernel, lstm_smem))) return err;
  if ((err = allow_smem((const void*)attention_kernel, att_smem))) return err;
  if ((err = allow_smem((const void*)matvec_kernel,
                        sizeof(float) * nbmax * (size_t)Hp)))
    return err;
  if ((err = allow_smem((const void*)head_kernel,
                        sizeof(float) * nbmax * (size_t)Hp)))
    return err;

  const dim3 unit_grid(cdiv(H, kWarps), groups);
  for (int t = 0; t < N; ++t) {
    const int p = t & 1, pp = p ^ 1;
    float* dec_p = dec + (size_t)p * B * L;
    float* dec_pp = dec + (size_t)pp * B * L;
    const float* prev = t ? mel + (size_t)(t - 1) * B * M : nullptr;

    lstm_kernel<<<unit_grid, kThreads, sizeof(float) * nbmax * (Mp + Hp),
                  stream>>>(att_w, att_b, prev, M, M, Mp, dec_pp, L, H, Hp,
                            dec_p, L, c_att, B, t, done_at);
    matvec_kernel<<<dim3(cdiv(D, kWarps), groups), kThreads,
                    sizeof(float) * nbmax * Hp, stream>>>(
        q_w, q_b, dec_p, L, H, Hp, qbuf, D, D, B, 0, t, done_at);
    attention_kernel<<<B, kAttnThreads, att_smem, stream>>>(
        qbuf, kp, vals, key_mask, v_w, dec_p, L, H, gate_w, gate_b,
        attn + (size_t)t * B * Tk, gates + (size_t)t * B, done, done_at,
        n_valid_in, D, Tk, t, temperature, gate_threshold, early_exit);

    const float* x = dec_p;
    int ldx = L, Kx = L;
    for (int l = 0; l < n_layers; ++l) {
      float* h_new = hl + ((size_t)p * n_layers + l) * B * H;
      const float* h_old = hl + ((size_t)pp * n_layers + l) * B * H;
      const int Kxp = pad4(Kx);
      lstm_kernel<<<unit_grid, kThreads,
                    sizeof(float) * nbmax * (Kxp + Hp), stream>>>(
          lstm_w[l], lstm_b[l], x, ldx, Kx, Kxp, h_old, H, H, Hp, h_new, H,
          cl + (size_t)l * B * H, B, t, done_at);
      x = h_new;
      ldx = H;
      Kx = H;
    }
    for (int i = 0; i < n_dense; ++i) {
      float* y = tmp + (size_t)(i & 1) * B * H;
      matvec_kernel<<<dim3(cdiv(H, kWarps), groups), kThreads,
                      sizeof(float) * nbmax * Hp, stream>>>(
          dense_w[i], dense_b[i], x, ldx, H, Hp, y, H, H, B, 1, t, done_at);
      x = y;
    }
    head_kernel<<<dim3(cdiv(M, kWarps), groups), kThreads,
                  sizeof(float) * nbmax * Hp, stream>>>(
        head_w, head_b, x, H, H, Hp, z + (size_t)t * B * M,
        mel + (size_t)t * B * M, B, M, t, done_at, done, early_exit);
    if ((err = cudaGetLastError())) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
