// P3 and P4: scans whose weights stay on chip across steps.
//
// Replaces two TPU probe kernels, each a whole scan in one pallas_call:
//
//   P3 scripts/exp_resident_weight.py:pallas_scan (:70, kernel :55):
//      state (B, S) bf16, w (S, N) bf16 resident; per step
//      y = state @ w (fp32 sums), state = bf16(0.999 * f32(state)
//      + 0.001 * y[:, :S]).
//   P4 scripts/exp_fused_int8.py:make_bf16 / make_w8a8 `run` (:95, :158):
//      state (B, S) fp32; per step a chain of n dots, dot i taking
//      h[:, :K_i] (h = state for i = 0) to y (B, N), then
//      _consume_gates: g = sig(y_0) * tanh(y_1) + sig(y_2) * tanh(y_3)
//      over the four N/4-wide quarters, h = tile(g)[:, :S]; after the
//      last dot state = 0.999 * state + 0.001 * h.
//      bf16 body: y = bf16(h) @ w_i, fp32 sums.
//      W8A8 body: sx = max|h_row| * fp32(1/127) + 1e-12 in one rounding
//      (the Pallas body's `/ 127.0 + 1e-12`, which XLA folds into one
//      fused multiply-add), q = rint(h / sx) (no clip), exact int32 sums
//      with int8 w_i, y = (f32(acc) * sx) * s_i.
//
// Weights come packed (ops/resident.py): (N, K_i) rows, k contiguous, 16
// bytes a row at least; for P4 row 4u + c holds column c * N/4 + u, so
// the four gate columns of one hidden unit u are one quad of rows.
//
// What bounds it on an H100: for P4 at B = 1 to 8, the bytes of the
// weights, read every step (38.8 MB of bf16 or 19.4 MB of int8 a step,
// ~12 or ~6 us at 3.35 TB/s from HBM), and the latency of the n
// dependent dots; for P3 at B = 64, the 0.87 GFLOP of every step.
//
// What the design does about it (a simple first version):
// - one persistent cooperative launch for the whole scan: one block per
//   SM, each owning a contiguous range of row quads (32 output columns at
//   these shapes), so a block's share of every dot is fixed for all
//   steps;
// - each block copies its rows of every weight that fits into shared
//   memory once, before the first step, and reads them there for every
//   step; a weight that does not fit (P4 bf16: 38.8 MB against ~30 MB of
//   shared memory on 132 SMs) is read from global memory (L2) every step;
//   the host decides dot by dot, in order, and reports the resident bytes;
// - a grid barrier (cooperative_groups grid sync) after every dot, since
//   every block needs the whole previous output; state and the gate
//   outputs are double-buffered in global memory, so no block writes what
//   another may still read;
// - P3 (B = 64) runs on the tensor cores: mma.sync m16n8k16 bf16 tiles,
//   fp32 sums, each warp one 8-column n-tile and one 16-row m-tile of 32
//   staged batch rows, smem rows padded by 16 bytes against bank
//   conflicts;
// - the chains (B = 1 to 8) stay SIMT: each warp owns one row quad (one unit's four gates) and reads
//   its rows and the staged input in 16-byte vectors, lanes on
//   neighbouring addresses; a shuffle reduction then gives every lane the
//   sums, and the warp applies the epilogue itself;
// - up to 8 batch rows share one pass over the rows; each block stages
//   the input rows it needs with 8 loads in flight a thread, and W8A8
//   quantizes them itself (a block-wide max a row), so no extra grid
//   barrier is needed.
// wgmma, TMA, tensor cores for the chains and pinning the streamed rows in
// L2 are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quad_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;         // batch rows per pass (one warp each for W8A8)
constexpr int kMaxDots = 4;
constexpr int kLoads = 8;         // staging loads in flight per thread
constexpr int kMmaRows = 32;      // P3: batch rows staged per pass
constexpr int kPad = 8;           // P3: bf16 of padding per smem row
constexpr float kInv127 = 1.0f / 127.0f;

enum Body { kP3 = 0, kChainBf16 = 1, kChainW8A8 = 2 };

struct Params {
  int body, B, steps, n_dots, N, S, grid, kmax;
  int K[kMaxDots];
  const void* w[kMaxDots];        // packed (N, K_i), bf16 or int8
  const float* scale[kMaxDots];   // (N,) packed, W8A8 only
  size_t smem_off[kMaxDots];      // offset of the resident slice, or -1
  size_t stage_off;               // offset of the staged input rows
  void* state[2];                 // P3: bf16 (B, S); chains: fp32 (B, S)
  float* g[2];                    // chains: (B, N / 4) gate outputs
  float* y_last;                  // P3: (B, N) fp32 product of the last step
};

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 0.999 * a + 0.001 * b with each product and the sum rounded, as the
// Pallas bodies write it (no contraction into an FMA).
__device__ __forceinline__ float blend(float a, float b) {
  return __fadd_rn(__fmul_rn(0.999f, a), __fmul_rn(0.001f, b));
}

__device__ __forceinline__ int dp4a16(const int4 a, const int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// quad_dot_bf16 (quad_dot.cuh) for int8 rows and int8 staged rows, exact
// int32 sums; K a multiple of 16.
__device__ __forceinline__ void quad_dot_i8(const int8_t* W, int K,
                                            const int8_t* xs, int nb,
                                            int (&acc)[4][kMaxB]) {
  const int lane = threadIdx.x & 31;
  const int K16 = K >> 4;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) acc[c][b] = 0;
  for (int i = lane; i < K16; i += 32) {
    int4 w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w[c] = reinterpret_cast<const int4*>(W + (size_t)c * K)[i];
#pragma unroll
    for (int b = 0; b < kMaxB; ++b) {
      if (b < nb) {
        const int4 x = reinterpret_cast<const int4*>(xs + (size_t)b * K)[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c][b] = dp4a16(w[c], x, acc[c][b]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < kMaxB; ++b)
      if (b < nb) acc[c][b] = warp_sum_i(acc[c][b]);
}

// acc[c][lane] without dynamic register indexing.
template <typename T>
__device__ __forceinline__ T pick(const T (&acc)[4][kMaxB], int c, int lane) {
  T v = 0;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b == lane) v = acc[c][b];
  return v;
}

// Input element k of dot i for batch row b: the state for dot 0, else
// h = tile(g)[:, :S], i.e. g[k % (N / 4)].
__device__ __forceinline__ float chain_input(const Params& p, int i, int cur,
                                             int b, int k) {
  if (i == 0) return static_cast<const float*>(p.state[cur])[(size_t)b * p.S + k];
  const int H4 = p.N >> 2;
  return p.g[(i - 1) & 1][(size_t)b * H4 + k % H4];
}

// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One P3 step for this block's columns [4 q0, 4 q1) on the tensor cores:
// y = state @ w, then the state update of columns < S and, at the last
// step, y itself. The weight rows (resident) and the staged state rows
// are kept with a row stride of K + kPad bf16, so the fragment loads of
// the 8 rows a warp reads fall in different banks. Warp w owns n-tile
// (8 columns) w % 4 and m-tile (16 batch rows) w / 4 of each pass of
// kMmaRows rows.
__device__ void p3_step(const Params& p, unsigned char* smem, int cur,
                        int nxt, int t, int q0, int q1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int K = p.K[0], Ks = K + kPad;
  const __nv_bfloat16* wsl =
      reinterpret_cast<const __nv_bfloat16*>(smem + p.smem_off[0]);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + p.stage_off);
  const __nv_bfloat16* s_old = static_cast<const __nv_bfloat16*>(p.state[cur]);
  __nv_bfloat16* s_new = static_cast<__nv_bfloat16*>(p.state[nxt]);
  const int ncols = 4 * (q1 - q0), mt = warp >> 2;
  const int per_row = K / 8;
  for (int b0 = 0; b0 < p.B; b0 += kMmaRows) {
    const int nb = min(kMmaRows, p.B - b0);
    // stage state rows b0 .. b0 + nb with cp.async, every 16-byte copy in
    // flight at once
    const int n16 = nb * per_row;
    for (int j = threadIdx.x; j < n16; j += kThreads) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
          xs + (size_t)(j / per_row) * Ks + (size_t)(j % per_row) * 8));
      const __nv_bfloat16* src = s_old + (size_t)(b0 + j / per_row) * p.S +
                                 (size_t)(j % per_row) * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (mt * 16 < nb) {
      for (int nt = warp & 3; nt * 8 < ncols; nt += 4) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        const __nv_bfloat16* a_lo = xs + (size_t)(mt * 16 + gid) * Ks + 2 * tig;
        const __nv_bfloat16* a_hi = a_lo + (size_t)8 * Ks;
        const __nv_bfloat16* bw = wsl + (size_t)(nt * 8 + gid) * Ks + 2 * tig;
#pragma unroll 4
        for (int k0 = 0; k0 < K; k0 += 16)
          mma_bf16(c, ld32(a_lo + k0), ld32(a_hi + k0), ld32(a_lo + k0 + 8),
                   ld32(a_hi + k0 + 8), ld32(bw + k0), ld32(bw + k0 + 8));
        // c[e]: batch row gid (+8 for e >= 2), column 2 tig (+1 if e odd)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = mt * 16 + gid + (e >> 1) * 8;
          const int col = nt * 8 + 2 * tig + (e & 1);
          if (r >= nb || col >= ncols) continue;
          const size_t row = (size_t)(b0 + r);
          const int n = 4 * q0 + col;
          if (n < p.S)
            s_new[row * p.S + n] = __float2bfloat16_rn(
                blend(__bfloat162float(s_old[row * p.S + n]), c[e]));
          if (t == p.steps - 1) p.y_last[row * p.N + n] = c[e];
        }
      }
    }
    __syncthreads();   // the staged rows are free again
  }
}

__global__ void __launch_bounds__(kThreads, 1) resident_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Q = p.N >> 2;
  const int q0 = (int)((long long)blockIdx.x * Q / p.grid);
  const int q1 = (int)((long long)(blockIdx.x + 1) * Q / p.grid);
  const size_t esize = p.body == kChainW8A8 ? 1 : 2;

  // this block's rows of every resident weight, once
  if (p.body == kP3) {
    const int per_row = p.K[0] / 8, Ks = p.K[0] + kPad;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.w[0]) + (size_t)q0 * 4 * p.K[0]);
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(smem + p.smem_off[0]);
    for (int j = threadIdx.x; j < (q1 - q0) * 4 * per_row; j += kThreads)
      reinterpret_cast<uint4*>(dst + (size_t)(j / per_row) * Ks)[j % per_row] =
          src[j];
    __syncthreads();
    for (int t = 0; t < p.steps; ++t) {
      p3_step(p, smem, t & 1, (t & 1) ^ 1, t, q0, q1);
      grid.sync();         // every block needs the whole new state
    }
    return;
  }
  for (int i = 0; i < p.n_dots; ++i) {
    if (p.smem_off[i] == (size_t)-1) continue;
    const size_t bytes = (size_t)(q1 - q0) * 4 * p.K[i] * esize;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const unsigned char*>(p.w[i]) +
        (size_t)q0 * 4 * p.K[i] * esize);
    uint4* dst = reinterpret_cast<uint4*>(smem + p.smem_off[i]);
    for (size_t j = threadIdx.x; j < bytes / 16; j += kThreads) dst[j] = src[j];
  }
  __syncthreads();

  unsigned char* stage = smem + p.stage_off;
  // W8A8: the fp32 input rows behind the int8 ones
  float* xf = reinterpret_cast<float*>(stage + (size_t)kMaxB * p.kmax);
  __shared__ float sx[kMaxB];
  __shared__ float red[kWarps][kMaxB];
  for (int t = 0; t < p.steps; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    for (int i = 0; i < p.n_dots; ++i) {
      const int K = p.K[i];
      const size_t quad_bytes = (size_t)4 * K * esize;
      const bool in_smem = p.smem_off[i] != (size_t)-1;
      for (int b0 = 0; b0 < p.B; b0 += kMaxB) {
        const int nb = min(kMaxB, p.B - b0);
        // stage the input rows b0 .. b0 + nb, kLoads loads in flight a
        // thread
        {
          // the chain's input rows, as bf16 (bf16 body) or fp32 (W8A8)
          const int total = nb * K;
          for (int j0 = threadIdx.x; j0 < total; j0 += kLoads * kThreads) {
            float v[kLoads];
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              const int j = j0 + u * kThreads;
              v[u] = j < total ? chain_input(p, i, cur, b0 + j / K, j % K) : 0.f;
            }
#pragma unroll
            for (int u = 0; u < kLoads; ++u) {
              const int j = j0 + u * kThreads;
              if (j >= total) continue;
              if (p.body == kChainBf16)
                reinterpret_cast<__nv_bfloat16*>(stage)[j] =
                    __float2bfloat16_rn(v[u]);
              else
                xf[j] = v[u];
            }
          }
        }
        if (p.body == kChainW8A8) {
          // sx per row: a block-wide max, then one fused multiply-add
          __syncthreads();
          for (int b = 0; b < nb; ++b) {
            float m = 0.f;
            for (int k = threadIdx.x; k < K; k += kThreads)
              m = fmaxf(m, fabsf(xf[(size_t)b * K + k]));
            m = warp_max(m);
            if (lane == 0) red[warp][b] = m;
          }
          __syncthreads();
          if (threadIdx.x < nb) {
            float m = red[0][threadIdx.x];
            for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w][threadIdx.x]);
            sx[threadIdx.x] = __fmaf_rn(m, kInv127, 1e-12f);
          }
          __syncthreads();
          int8_t* dst = reinterpret_cast<int8_t*>(stage);
          for (int j = threadIdx.x; j < nb * K; j += kThreads)
            dst[j] = static_cast<int8_t>(rintf(__fdiv_rn(xf[j], sx[j / K])));
        }
        __syncthreads();

        for (int q = q0 + warp; q < q1; q += kWarps) {
          const unsigned char* Wq =
              in_smem ? smem + p.smem_off[i] + (size_t)(q - q0) * quad_bytes
                      : static_cast<const unsigned char*>(p.w[i]) +
                            (size_t)q * quad_bytes;
          float y[4];
          if (p.body == kChainW8A8) {
            int acc[4][kMaxB];
            quad_dot_i8(reinterpret_cast<const int8_t*>(Wq), K,
                        reinterpret_cast<const int8_t*>(stage), nb, acc);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              y[c] = __fmul_rn(__fmul_rn(__int2float_rn(pick(acc, c, lane & 7)),
                                         sx[lane & 7]),
                               p.scale[i][4 * q + c]);
          } else {
            float acc[4][kMaxB];
            quad_dot_bf16<false>(reinterpret_cast<const __nv_bfloat16*>(Wq), K,
                                 reinterpret_cast<const __nv_bfloat16*>(stage),
                                 nb, acc);
#pragma unroll
            for (int c = 0; c < 4; ++c) y[c] = pick(acc, c, lane & 7);
          }
          if (lane < nb) {
            // lane b: unit q's gates for batch row b0 + b
            const size_t row = (size_t)(b0 + lane);
            const float g = sigmoidf(y[0]) * tanhf(y[1]) +
                            sigmoidf(y[2]) * tanhf(y[3]);
            p.g[i & 1][row * Q + q] = g;
            if (i == p.n_dots - 1) {
              const float* s_old = static_cast<const float*>(p.state[cur]);
              float* s_new = static_cast<float*>(p.state[nxt]);
              for (int j = q; j < p.S; j += Q)
                s_new[row * p.S + j] = blend(s_old[row * p.S + j], g);
            }
          }
        }
        __syncthreads();   // the staged rows are free again
      }
      grid.sync();         // every block needs this dot's whole output
    }
  }
}

}  // namespace

extern "C" {

const char* resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the cooperative launch: one per SM, at most N / 4.
int resident_grid(int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) || cudaDeviceGetAttribute(
          &sms, cudaDevAttrMultiProcessorCount, dev))
    return -1;
  return sms < N / 4 ? sms : N / 4;
}

// Bytes an access-policy window may pin in L2 on this card.
long long resident_max_persisting_l2(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxPersistingL2CacheSize, dev))
    return -1;
  return v;
}

// The scan. body 0 = P3, 1 = P4 bf16, 2 = P4 W8A8. w[i] packed (N, K[i])
// (bf16 for bodies 0, 1; int8 for 2), scale[i] (N,) fp32 packed for body
// 2. state0/state1 (B, S): state0 holds the initial state (bf16 for body
// 0, fp32 otherwise); the final state is in state[steps & 1]. g0, g1 (B,
// N / 4) fp32 for bodies 1, 2; y_last (B, N) fp32 for body 0. Writes the
// bytes of the weights kept in shared memory to *resident_bytes and
// 1 / 0 per dot to resident[i].
int resident_scan(int body, int B, int steps, int n_dots, int N, int S,
                  const int* K, const void* const* w,
                  const float* const* scale, void* state0, void* state1,
                  float* g0, float* g1, float* y_last,
                  long long* resident_bytes, int* resident,
                  void* stream_handle) {
  if (body < 0 || body > 2 || n_dots < 1 || n_dots > kMaxDots || B < 1 ||
      steps < 1 || N % 4 || (body == kP3 && n_dots != 1))
    return cudaErrorInvalidValue;
  Params p = {};
  p.body = body;
  p.B = B;
  p.steps = steps;
  p.n_dots = n_dots;
  p.N = N;
  p.S = S;
  p.grid = resident_grid(N);
  if (p.grid < 1) return cudaErrorInvalidValue;
  const int esize = body == kChainW8A8 ? 1 : 2;
  int kmax = 0;
  for (int i = 0; i < n_dots; ++i) {
    if ((K[i] * esize) % 16 || K[i] > S) return cudaErrorInvalidValue;
    p.K[i] = K[i];
    p.w[i] = w[i];
    p.scale[i] = body == kChainW8A8 ? scale[i] : nullptr;
    kmax = K[i] > kmax ? K[i] : kmax;
  }
  if (body == kP3 && (K[0] != S || K[0] % 16)) return cudaErrorInvalidValue;
  p.state[0] = state0;
  p.state[1] = state1;
  p.g[0] = g0;
  p.g[1] = g1;
  p.y_last = y_last;

  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  const int qmax = (N / 4 + p.grid - 1) / p.grid;
  p.kmax = kmax;
  // staged input rows: P3 kMmaRows padded bf16 rows; chains bf16 (bf16
  // body) or int8 and fp32 (W8A8)
  const size_t stage =
      body == kP3 ? (size_t)kMmaRows * (kmax + kPad) * 2
                  : (size_t)kMaxB * kmax * (body == kChainW8A8 ? 1 + 4 : esize);
  const size_t budget = (size_t)optin - 1024;   // static sx[], red[], slack
  size_t used = stage;
  *resident_bytes = 0;
  p.stage_off = 0;
  for (int i = 0; i < n_dots; ++i) {
    // P3's rows are padded and whole n-tiles of 8
    const size_t slice =
        body == kP3 ? (size_t)((qmax * 4 + 7) / 8 * 8) * (K[i] + kPad) * 2
                    : (size_t)qmax * 4 * K[i] * esize;
    if (used + slice <= budget) {
      p.smem_off[i] = used;
      used += slice;
      *resident_bytes += (long long)N * K[i] * esize;
      resident[i] = 1;
    } else {
      p.smem_off[i] = (size_t)-1;
      resident[i] = 0;
    }
  }
  if (body == kP3 && !resident[0]) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute((const void*)resident_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)used)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, resident_kernel, kThreads, used)))
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)resident_kernel, p.grid,
                                    kThreads, args, used,
                                    static_cast<cudaStream_t>(stream_handle));
  if (err) return err;
  return cudaGetLastError();
}

}  // extern "C"
