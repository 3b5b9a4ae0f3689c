// P5: K1 stripped to its dots, its LSTM cells or its attention, for cost
// attribution.
//
// Replaces scripts/exp_fused_cost.py:run (pallas_call at :53) and its three
// bodies, each N steps of a recurrence over zero-initialised scratch h,
// h2 (B, H) and prev (B, M), bf16 weights, fp32 sums, z (N, B, M) fp32,
// kv (B, Tk, D) bf16, mel (N, B, M) fp32:
//
//   v_dots (:82)  h = tanh((prev @ w0 + h @ w1)[:, :H]);
//                 h2 = tanh((h @ w2)[:, :H]); out = (h2 @ w3)[:, :M] + z[t]
//   v_lstm (:104) g1 = prev @ w0 + h @ w1, quarters i f g o:
//                 h = sig(o) tanh(sig(f) h + sig(i) tanh(g));
//                 g2 = h @ w2 + h2 @ w3: h2 = sig(g2_0) tanh(g2_1);
//                 out = (h2 @ w4)[:, :M] + z[t]
//   v_attn (:133) q = prev @ w0 (M, D); e_k = sum_d tanh(bf16(bf16(q) +
//                 kv_k)); a = softmax_k(e); ctx = bf16(sum_k bf16(a_k) kv_k);
//                 out = ctx[:, :M] + z[t]
//
// with every dot input rounded to bf16 (`.astype(CDT)`) and prev = out.
// Where the script slices a dot's output ([:, :H], [:, :M]) the kernels
// still compute the whole product and store the unused columns to a
// scratch row: the point of the probe is what reading every weight of a
// K1 frame costs (exp_fused_int8.py:43-44 says why a narrowed dot would
// not measure it).
//
// What bounds it on an H100: the weight bytes of every step (25.8 MB of
// bf16 for v_dots, 25.4 MB for v_lstm, 0.1 MB for v_attn; ~8 us at 3.35
// TB/s from HBM, less if they stay in the 50 MB L2) and the latency of
// the dependent dots.
//
// What the design does about it: K1's own launch structure
// (csrc/decoder.cu), stripped down, so the three times add up against
// K1's per-frame time. One host call loops over the steps and launches,
// per step, one kernel per dependent dot (3 for v_dots and v_lstm; the
// query and one attention block per batch row for v_attn) on the caller's
// stream. A warp owns one quad of weight rows (one unit's four gate rows,
// interleaved by ops/fused_cost.py:pack_weights, or four consecutive
// output columns of the head and query dots), reads them in 16-byte bf16
// vectors against the bf16 input rows staged in shared memory, reduces
// with shuffles, and applies the cell itself. h and h2 are
// double-buffered across steps. SIMT fp32 FMAs; tensor cores and a
// persistent kernel are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;          // batch rows per pass over the weights
constexpr int kAttnThreads = 1024;  // one block per batch row, as in K1

enum Variant { kDots = 0, kLstm = 1, kAttn = 2 };
// epilogues of dot_kernel
enum Mode { kTanhCell = 0, kLstmCell = 1, kHalfCell = 2, kHead = 3,
            kQuery = 4 };

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int pad8(int n) { return (n + 7) & ~7; }

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One input segment of a dot: n fp32 values per batch row at src (row
// stride ld), staged as bf16 and zero-padded to npad (a multiple of 8).
// src == nullptr stages zeros (prev at t = 0).
struct Seg {
  const float* src;
  int ld, n, npad;
};

__device__ void stage(__nv_bfloat16* xs, int Kp, int off, Seg s, int g0,
                      int nb) {
  for (int i = threadIdx.x; i < nb * s.npad; i += blockDim.x) {
    const int b = i / s.npad, k = i - b * s.npad;
    const float v = (s.src != nullptr && k < s.n)
                        ? s.src[(size_t)(g0 + b) * s.ld + k] : 0.f;
    xs[(size_t)b * Kp + off + k] = __float2bfloat16_rn(v);
  }
}

// acc[c][b] for a lane-dependent (c, b), without dynamic register indexing.
__device__ __forceinline__ float acc_at(const float (&acc)[4][kMaxB], int c,
                                        int b) {
  float v = 0.f;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc)
#pragma unroll
    for (int bb = 0; bb < kMaxB; ++bb)
      if (cc == c && bb == b) v = acc[cc][bb];
  return v;
}

// y = [s0 ; s1] @ W^T for the N packed rows of W (N, Kp), then the
// epilogue of `mode`. Cell modes: rows interleaved (row 4u + c = column
// c * N/4 + u), unit u's new state to h_out[:, u] (h_old[:, u] is the old
// one, read by the LSTM cell); kHead: rows in column order, out[:, n] =
// y + z for n < M; kQuery: out (B, N) = y. Every mode but kQuery also
// stores all of y to ybuf (B, N), so no column's work is dropped.
// Grid (cdiv(N / 4, kWarps), batch groups).
__global__ void __launch_bounds__(kThreads) dot_kernel(
    const __nv_bfloat16* __restrict__ W, int Kp, int N, Seg s0, Seg s1,
    int mode, int B, const float* h_old, float* h_out, int ldh,
    const float* __restrict__ z, float* out, int M, float* ybuf) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int g0 = blockIdx.y * kMaxB;
  const int nb = min(kMaxB, B - g0);
  stage(xs, Kp, 0, s0, g0, nb);
  stage(xs, Kp, s0.npad, s1, g0, nb);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= N / 4) return;
  float acc[4][kMaxB];
  quad_dot_bf16<true>(W + (size_t)q * 4 * Kp, Kp, xs, nb, acc);
  const bool natural = mode == kHead || mode == kQuery;
  const int c = lane >> 3, b = lane & 7;
  if (b < nb) {
    const float v = acc_at(acc, c, b);
    const size_t row = (size_t)(g0 + b);
    const int col = natural ? 4 * q + c : c * (N / 4) + q;
    if (mode == kQuery) {
      out[row * N + col] = v;
    } else {
      ybuf[row * N + col] = v;
      if (mode == kHead && col < M) out[row * M + col] = v + z[row * M + col];
    }
  }
  if (!natural && lane < nb) {
    const size_t row = (size_t)(g0 + lane);
    float y[4];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) y[cc] = acc_at(acc, cc, lane);
    float h;
    if (mode == kTanhCell) {
      h = tanhf(y[0]);
    } else if (mode == kLstmCell) {   // gates i, f, g, o
      const float cell = sigmoidf(y[1]) * h_old[row * ldh + q] +
                         sigmoidf(y[0]) * tanhf(y[2]);
      h = sigmoidf(y[3]) * tanhf(cell);
    } else {                          // kHalfCell
      h = sigmoidf(y[0]) * tanhf(y[1]);
    }
    h_out[row * ldh + q] = h;
  }
}

// v_attn's attention for one step, one block per batch row b.
__global__ void __launch_bounds__(kAttnThreads) attention_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ kv,
    const float* __restrict__ z, float* mel_t, float* ctx_out, int D,
    int Tk, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);   // D
  float* sc = qs + D;                           // Tk
  __shared__ float red[kAttnThreads / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nw = kAttnThreads / 32;
  const __nv_bfloat16* kvb = kv + (size_t)b * Tk * D;
  for (int d = tid; d < D; d += kAttnThreads) qs[d] = bf16r(q[(size_t)b * D + d]);
  __syncthreads();
  for (int k = warp; k < Tk; k += nw) {
    float s = 0.f;
    for (int d = lane; d < D; d += 32)
      s += tanhf(bf16r(qs[d] + __bfloat162float(kvb[(size_t)k * D + d])));
    s = warp_sum(s);
    if (lane == 0) sc[k] = s;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int k = tid; k < Tk; k += kAttnThreads) m = fmaxf(m, sc[k]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  float sum = 0.f;
  for (int k = tid; k < Tk; k += kAttnThreads) {
    const float e = expf(sc[k] - m);
    sc[k] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = 0.f;
  for (int w = 0; w < nw; ++w) sum += red[w];
  for (int k = tid; k < Tk; k += kAttnThreads) sc[k] = bf16r(sc[k] / sum);
  __syncthreads();
  for (int d = tid; d < D; d += kAttnThreads) {
    float acc = 0.f;
    for (int k = 0; k < Tk; ++k)
      acc += sc[k] * __bfloat162float(kvb[(size_t)k * D + d]);
    const float ctx = bf16r(acc);
    ctx_out[(size_t)b * D + d] = ctx;
    if (d < M) mel_t[(size_t)b * M + d] = ctx + z[(size_t)b * M + d];
  }
}

cudaError_t launch_dot(const __nv_bfloat16* W, int N, Seg s0, Seg s1,
                       int mode, int B, const float* h_old, float* h_out,
                       int ldh, const float* z, float* out, int M,
                       float* ybuf, cudaStream_t stream) {
  const int Kp = s0.npad + s1.npad;
  const int nbmax = B < kMaxB ? B : kMaxB;
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)nbmax * Kp;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dot_kernel<<<dim3(cdiv(N / 4, kWarps), cdiv(B, kMaxB)), kThreads, smem,
               stream>>>(W, Kp, N, s0, s1, mode, B, h_old, h_out, ldh, z, out,
                         M, ybuf);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fused_cost_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of workspace fused_cost_f32 needs; the caller zeroes it (h and
// h2 start at zero, as the Pallas scratch does).
long long fused_cost_workspace_floats(int B, int H, int D, int Ny) {
  return (long long)B * (4LL * H + Ny + 2LL * D);
}

// N steps of `variant` (0 v_dots, 1 v_lstm, 2 v_attn). z (N, B, M) fp32,
// kv (B, Tk, D) bf16 (v_attn only), mel (N, B, M) fp32 out. Packed bf16
// weights (ops/fused_cost.py:pack_weights), P(n) = n rounded up to 8:
//   v_dots: wa (4H, P(M) + P(H)) and wb (4H, P(H)) interleaved, wc (Nc,
//           P(H)) in column order (Nc = 4H);
//   v_lstm: wa (4H, P(M) + P(H)), wb (4H, 2 P(H)) interleaved, wc (Nc,
//           P(H)) in column order (Nc = 128 when M = 80);
//   v_attn: wa (D, P(M)) in column order; wb, wc unused, H = 0.
// work: fused_cost_workspace_floats(B, H, D, Ny) floats, zeroed, with Ny
// the widest dot output (4H, Nc or D).
int fused_cost_f32(int variant, const float* z, const void* kv,
                   const void* wa, const void* wb, const void* wc,
                   float* mel, float* work, int N, int B, int M, int H,
                   int D, int Tk, int Nc, int Ny, void* stream_handle) {
  if (variant < 0 || variant > 2 || N < 1 || B < 1 || H % 4 || Nc % 4 ||
      D % 4 || (variant == kAttn && D < M) ||
      (variant != kAttn && (Nc < M || H < 4)))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int Mp = pad8(M), Hp = pad8(H);
  float* h = work;                       // 2 x (B, H)
  float* h2 = h + 2 * (size_t)B * H;     // 2 x (B, H)
  float* ybuf = h2 + 2 * (size_t)B * H;  // (B, Ny)
  float* qbuf = ybuf + (size_t)B * Ny;   // (B, D)
  float* ctx = qbuf + (size_t)B * D;     // (B, D)
  const __nv_bfloat16* Wa = static_cast<const __nv_bfloat16*>(wa);
  const __nv_bfloat16* Wb = static_cast<const __nv_bfloat16*>(wb);
  const __nv_bfloat16* Wc = static_cast<const __nv_bfloat16*>(wc);
  const Seg none = {nullptr, 0, 0, 0};
  const size_t att_smem = sizeof(float) * ((size_t)D + Tk);
  if (att_smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaError_t err;
  for (int t = 0; t < N; ++t) {
    const int p = t & 1;
    float* h_new = h + (size_t)p * B * H;
    float* h_old = h + (size_t)(p ^ 1) * B * H;
    float* h2_new = h2 + (size_t)p * B * H;
    float* h2_old = h2 + (size_t)(p ^ 1) * B * H;
    const float* prev = t ? mel + (size_t)(t - 1) * B * M : nullptr;
    float* mel_t = mel + (size_t)t * B * M;
    const float* z_t = z + (size_t)t * B * M;
    const Seg s_prev = {prev, M, M, Mp};
    if (variant == kAttn) {
      if ((err = launch_dot(Wa, D, s_prev, none, kQuery, B, nullptr, nullptr,
                            0, nullptr, qbuf, M, nullptr, stream)))
        return err;
      attention_kernel<<<B, kAttnThreads, att_smem, stream>>>(
          qbuf, static_cast<const __nv_bfloat16*>(kv), z_t, mel_t, ctx, D, Tk,
          M);
      if ((err = cudaGetLastError())) return err;
      continue;
    }
    const Seg s_h_old = {h_old, H, H, Hp}, s_h_new = {h_new, H, H, Hp};
    const Seg s_h2_old = {h2_old, H, H, Hp}, s_h2_new = {h2_new, H, H, Hp};
    if (variant == kDots) {
      if ((err = launch_dot(Wa, 4 * H, s_prev, s_h_old, kTanhCell, B, h_old,
                            h_new, H, nullptr, nullptr, M, ybuf, stream)))
        return err;
      if ((err = launch_dot(Wb, 4 * H, s_h_new, none, kTanhCell, B, nullptr,
                            h2_new, H, nullptr, nullptr, M, ybuf, stream)))
        return err;
    } else {
      if ((err = launch_dot(Wa, 4 * H, s_prev, s_h_old, kLstmCell, B, h_old,
                            h_new, H, nullptr, nullptr, M, ybuf, stream)))
        return err;
      if ((err = launch_dot(Wb, 4 * H, s_h_new, s_h2_old, kHalfCell, B,
                            nullptr, h2_new, H, nullptr, nullptr, M, ybuf,
                            stream)))
        return err;
    }
    if ((err = launch_dot(Wc, Nc, s_h2_new, none, kHead, B, nullptr, nullptr,
                          0, z_t, mel_t, M, ybuf, stream)))
      return err;
  }
  return cudaSuccess;
}

}  // extern "C"
