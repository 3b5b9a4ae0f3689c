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
// Weights come packed (ops/resident.py): (N, K_i) rows, k contiguous; for
// P4 row 4u + c holds column c * N/4 + u, so the four gate columns of one
// hidden unit u are one quad of rows, and a chain's dots lie one after
// the other in one buffer.
//
// What bounds it on an H100: for P4 at B = 1 to 8, the latency of the n
// dependent dots (each a grid barrier, a round trip to stage its input
// and one for its epilogue), then the bytes of the weights that do not
// stay in shared memory (38.8 MB of bf16 a step against ~30 MB of shared
// memory on 132 SMs: 16.8 MB from L2 every step); for P3 at B = 64, the
// 0.87 GFLOP of every step (~0.9 us at the bf16 tensor-core peak), and
// what the design adds: every SM reads the whole bf16 state from L2
// every step (213 KB, ~28 MB a step over 132 SMs) and waits at a grid
// barrier (2-3.5 us, PERF.md).
//
// P3 (B = 64, its own kernel p3_kernel): one persistent cooperative
// launch, one block per SM owning a contiguous range of row quads, its
// rows of w copied into shared memory once; on the tensor cores, its
// staging pipelined behind them: the state comes in chunks of all (up to
// 64) batch rows x kP3Chunk columns through a ring of kP3Stages cp.async
// groups, so the mma.sync m16n8k16 bf16 tiles of chunk i run while chunks
// i + 1 .. i + 3 land; each block walks the chunks from its own starting
// chunk, so the SMs do not all ask L2 for the same lines at once; each
// warp keeps 2 m-tiles x 2 n-tiles of independent fp32 accumulators over
// half of every chunk's k (A and B fragments by ldmatrix, all of a
// chunk's loaded before its products), and the two halves meet in shared
// memory in a fixed order; each thread's copy offsets are fixed a pass,
// so a chunk's copies cost a few instructions (address arithmetic would
// otherwise take more issue slots than the products); smem rows are
// padded by 16 bytes against bank conflicts; a batch above 64 rows takes
// further passes; a cooperative_groups grid sync closes each step.
//
// P4 (the chains, chain_kernel), laid out by ops/resident.py:chain_plan:
// - one persistent cooperative launch for the whole scan, one 256-thread
//   block per SM owning a contiguous range of row quads of every dot (31
//   or 32 rows at N = 4096 on 132 SMs);
// - the blocks meet at the counter barrier of csrc/grid_sync.cuh after
//   each dot (every block needs the dot's whole output; the counter is a
//   word the wrapper zeroes, its target one grid higher a barrier);
//   the last dot's blend writes the state that every block stages for
//   the next step's first dot, so it comes before the arrive; state and
//   the gate outputs are double-buffered in global memory, so no block
//   writes what another may still read;
// - the dots run on the tensor cores, the product transposed as K4's
//   (csrc/qmm.cu): y^T = W (16 rows, four units' gate quads, the mma's m)
//   x h^T (the staged batch rows, n = 8; B = 1 leaves seven columns
//   zero), mma_bf16 m16n8k16 for bf16 and mma_s8_m16n8k32 for W8A8 (exact
//   int32 sums). For each 64-byte stretch of k a lane loads 16 bytes of
//   its weight rows g = lane / 4 and g + 8 and of staged row g at 16
//   (lane % 4): the mma's k order is a permutation of those bytes, the
//   same for A and B, so each product still pairs w[n, k] with h[b, k],
//   with no repacking and no ldmatrix; two mmas a stretch. Rows in shared
//   memory lie an odd multiple of 64 bytes apart (chain_plan's
//   row_stride), so a quarter-warp's loads fill the 32 banks once;
// - warp w takes m-tile w % m_tiles and every (8 / m_tiles)-th stretch
//   into four independent accumulator chains (stretch j into chain j % 4);
//   each mma sums its tile from zero and rounded fp32 adds take it into
//   the chain (a tensor core accumulating a whole dot truncates at every
//   tile, and a chain of dots passes every bf16 rounding on: the gates
//   then left chip_smoke's bar); the k-parts' sums meet in shared memory
//   and one thread a (unit, batch row) adds them in a fixed order and
//   applies the epilogue (gates, scales, blend): no atomics, bitwise
//   repeatable;
// - each block copies its rows of every dot that fits into shared memory
//   once (in order: at N = 4096, dots 0 and 1 of bf16, all four of int8);
//   a bf16 dot that does not fit (16.8 MB: 28% of the bytes) is read from
//   L2 in the dot, rows of a ragged tile and batch rows past B reading a
//   valid row again (their sums are dropped), so the loop has no
//   predicates. Two ways to bring those rows closer were measured on the
//   H100 and taken out (PERF.md section 6): a bulk copy of a prefix of
//   each row into the rest of the shared memory behind the barrier (its
//   32 copies a dot hold up a warp: slower), and an L2 access-policy
//   window (no faster: the rows stay in L2 across steps without one);
// - the launch's parameters are copied into shared memory: a kernel
//   parameter indexed by the dot is read through its address, a round
//   trip each time;
// - staging: each block reads the input rows from L2 (16-byte loads, up to
//   8 in flight a thread) and stores them as bf16, or, for W8A8, as fp32,
//   then one warp a row takes max|h| and sx, then the block quantizes.
//   Partial maxima written by each block beside the previous dot's
//   outputs (the next dot reducing 132 partials instead of K values) were
//   measured no faster and were taken out, as was a block-wide reduction
//   of each thread's maxima with the values kept in registers (slower);
// - the last dot's old state values are loaded before its products, so
//   that the blend does not wait for them.
// What holds it (PERF.md): every dot pays a barrier (~1 us), an L2 round
// trip to stage its input and the epilogue's stores before the release:
// ~4 us a dot whatever its size.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "mma.cuh"
#include "quad_dot.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;          // chains: batch rows a pass (the mma's n)
constexpr int kMaxDots = 4;
constexpr int kStretch = 64;      // chains: bytes of k a lane quad loads
constexpr int kUnroll = 4;        // chains: stretches a warp loads ahead
constexpr int kLoads = 8;         // chains: staging loads in flight a thread
constexpr int kOld = 4;           // chains: old state values a thread loads
                                  // before the last dot's products
constexpr int kStatic = 1024;     // chains: kept for static shared memory
constexpr int kPad = 8;           // P3: bf16 of padding per smem row
constexpr int kP3Rows = 64;       // P3: batch rows a pass (four m16 tiles)
constexpr int kP3Chunk = 128;     // P3: state columns a ring stage
constexpr int kP3Stages = 4;      // P3: ring stages
constexpr int kP3Cols = 32;       // P3: output columns a block at most
constexpr int kP3XS = kP3Chunk + kPad;   // P3: staged row stride (bf16)
constexpr int kP3RS = kP3Cols + 4;       // P3: partial-sum row stride (fp32)
constexpr int kP3Step = kThreads / (kP3Chunk / 8);   // P3: rows a copy round
constexpr float kInv127 = 1.0f / 127.0f;

enum Body { kP3 = 0, kChainBf16 = 1, kChainW8A8 = 2 };

// P3's launch (one-element arrays, so that p3_kernel reads p.K[0],
// p.w[0] and p.smem_off[0] as it did when the chains shared this struct)
struct Params {
  int B, steps, N, S, grid;
  int K[1];
  const void* w[1];               // packed (N, K) bf16
  size_t smem_off[1];             // offset of the resident slice
  size_t stage_off;               // offset of the state ring
  size_t red_off;                 // offset of the k-halves' sums
  void* state[2];                 // bf16 (B, S)
  float* y_last;                  // (B, N) fp32 product of the last step
};

// A chain's launch; offsets in bytes of dynamic shared memory
// (ops/resident.py:chain_plan)
struct Chain {
  int i8, B, steps, n_dots, N, S, grid, m_tiles;
  int mt_bits, nkp;               // log2(m_tiles), k-parts: 8 / m_tiles
  int K[kMaxDots];
  int res_off[kMaxDots];          // the block's resident rows, or -1
  int stage_off, xf_off, red_off, scale_off;
  const unsigned char* w[kMaxDots];   // packed (N, K_i), bf16 or int8
  const float* scale[kMaxDots];   // (N,) packed, W8A8 only
  float* state[2];                // fp32 (B, S)
  float* g[2];                    // (B, N / 4) gate outputs
  unsigned* bar;                  // the grid barrier's counter
  long long* clock;               // or null: block 0's time at each barrier
};

// 0.999 * a + 0.001 * b with each product and the sum rounded, as the
// Pallas bodies write it (no contraction into an FMA).
__device__ __forceinline__ float blend(float a, float b) {
  return __fadd_rn(__fmul_rn(0.999f, a), __fmul_rn(0.001f, b));
}

// P3 on the tensor cores: one block a SM, its columns [4 q0, 4 q1) (at
// most kP3Cols) of w resident, and per step y = state @ w, then the state
// update of columns < S and, at the last step, y itself. The state comes
// through the ring in chunks of (up to) kP3Rows batch rows x kP3Chunk
// columns, from chunk blockIdx.x % n_chunks on. Warp w owns m-tiles
// 2 (w & 1) and + 1, n-tiles 2 ((w >> 1) & 1) and + 1, and the k-steps of
// half w >> 2 of every chunk; the weight rows and the staged rows have a
// row stride of K + kPad and kP3XS bf16, so the 8 rows of an ldmatrix
// matrix fall in different banks.
__global__ void __launch_bounds__(kThreads, 1) p3_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mw = warp & 1, nw = (warp >> 1) & 1, kw = warp >> 2;
  const int Q = p.N >> 2;
  const int q0 = (int)((long long)blockIdx.x * Q / p.grid);
  const int q1 = (int)((long long)(blockIdx.x + 1) * Q / p.grid);
  const int K = p.K[0], Ks = K + kPad, ncols = 4 * (q1 - q0);
  const int n_chunks = K / kP3Chunk, first = blockIdx.x % n_chunks;
  const int lr = threadIdx.x / (kP3Chunk / 8), lc = threadIdx.x % (kP3Chunk / 8);
  __nv_bfloat16* wsl = reinterpret_cast<__nv_bfloat16*>(smem + p.smem_off[0]);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + p.stage_off);
  float* red = reinterpret_cast<float*>(smem + p.red_off);

  // this block's rows of w, once
  {
    const int per_row = K / 8;
    const uint4* src = reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.w[0]) + (size_t)q0 * 4 * K);
    for (int j = threadIdx.x; j < ncols * per_row; j += kThreads)
      reinterpret_cast<uint4*>(wsl + (size_t)(j / per_row) * Ks)[j % per_row] =
          src[j];
  }
  __syncthreads();

  for (int t = 0; t < p.steps; ++t) {
    const __nv_bfloat16* s_old =
        static_cast<const __nv_bfloat16*>(p.state[t & 1]);
    __nv_bfloat16* s_new = static_cast<__nv_bfloat16*>(p.state[(t & 1) ^ 1]);
    for (int b0 = 0; b0 < p.B; b0 += kP3Rows) {
      const int nb = min(kP3Rows, p.B - b0);
      // stage chunk i into its ring slot (rows >= nb are left as they are:
      // a product row depends only on its own state row); this thread
      // copies 16 bytes of rows lr + kP3Step u, its offsets fixed a pass
      const __nv_bfloat16* src = s_old + (size_t)(b0 + lr) * p.S + 8 * lc;
      __nv_bfloat16* dst = ring + lr * kP3XS + 8 * lc;
      auto load = [&](int i) {
        if (i < n_chunks) {
          const int kc = first + i < n_chunks ? first + i : first + i - n_chunks;
          const __nv_bfloat16* s = src + kc * kP3Chunk;
          __nv_bfloat16* d = dst + (i % kP3Stages) * (kP3Rows * kP3XS);
#pragma unroll
          for (int u = 0; u < kP3Rows / kP3Step; ++u)
            if (lr + kP3Step * u < nb)
              cp_async16(d + kP3Step * u * kP3XS,
                         s + (size_t)kP3Step * u * p.S);
        }
        cp_async_commit();
      };
      for (int i = 0; i < kP3Stages - 1; ++i) load(i);
      float acc[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

      for (int i = 0; i < n_chunks; ++i) {
        cp_async_wait<kP3Stages - 2>();
        __syncthreads();   // chunk i landed for all; chunk i - 1 is done
        load(i + kP3Stages - 1);
        if (mw * 32 >= nb) continue;
        const __nv_bfloat16* xs =
            ring + (size_t)(i % kP3Stages) * kP3Rows * kP3XS;
        const __nv_bfloat16* wk =
            wsl + (first + i < n_chunks ? first + i : first + i - n_chunks) *
                      kP3Chunk;
        // every fragment of this warp's k-steps first, so that the loads
        // overlap, then the products
        constexpr int kSteps = kP3Chunk / 32;
        uint32_t af[kSteps][2][4], bf[kSteps][4];
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int k0 = 16 * (kw * kSteps + s);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            ldmatrix_x4<false>(af[s][mi], xs + (mw * 32 + mi * 16 + (lane & 15)) * kP3XS
                                              + k0 + 8 * (lane >> 4));
          ldmatrix_x4<false>(bf[s], wk + (size_t)(nw * 16 + (lane & 7) + 8 * (lane >> 4)) * Ks
                                        + k0 + 8 * ((lane >> 3) & 1));
        }
#pragma unroll
        for (int s = 0; s < kSteps; ++s)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            if (mw * 32 + mi * 16 >= nb) continue;
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
              mma_bf16(acc[mi][ni], af[s][mi], bf[s][2 * ni], bf[s][2 * ni + 1]);
          }
      }
      cp_async_wait<0>();
      // the second k-half's sums to the first; acc[mi][ni][e] is batch row
      // 32 mw + 16 mi + gid (+ 8 for e >= 2), column 16 nw + 8 ni + 2 tig
      // (+ 1 for odd e)
      if (kw == 1) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              *reinterpret_cast<float2*>(
                  red + (mw * 32 + mi * 16 + gid + 8 * h) * kP3RS + nw * 16 +
                  ni * 8 + 2 * tig) =
                  make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
      __syncthreads();
      if (kw == 0) {
        // every old state value first, so that their loads overlap (a
        // store to s_new may alias them for the compiler)
        float old[2][2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mw * 32 + mi * 16 + gid + (e >> 1) * 8;
              const int n = 4 * q0 + nw * 16 + ni * 8 + 2 * tig + (e & 1);
              old[mi][ni][e] =
                  r < nb && n < 4 * q1 && n < p.S
                      ? __bfloat162float(s_old[(size_t)(b0 + r) * p.S + n])
                      : 0.f;
            }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = mw * 32 + mi * 16 + gid + (e >> 1) * 8;
              const int col = nw * 16 + ni * 8 + 2 * tig + (e & 1);
              if (r >= nb || col >= ncols) continue;
              const float y = __fadd_rn(acc[mi][ni][e], red[r * kP3RS + col]);
              const size_t row = (size_t)(b0 + r);
              const int n = 4 * q0 + col;
              if (n < p.S)
                s_new[row * p.S + n] =
                    __float2bfloat16_rn(blend(old[mi][ni][e], y));
              if (t == p.steps - 1) p.y_last[row * p.N + n] = y;
            }
      }
    }
    grid.sync();           // every block needs the whole new state
  }
}

// Bytes between two rows of n bytes (a multiple of 64) in shared memory:
// an odd multiple of 64 (ops/resident.py:row_stride).
__device__ __forceinline__ int row_stride(int n) {
  return (n & 127) ? n : n + 64;
}

// c += the two mma tiles of one 64-byte stretch: a and b hold 16 bytes of
// weight rows g and g + 8, x 16 bytes of staged row g (lane g, t), the
// same bytes of k in the same order (see the note at the top). bf16: each
// tile's 16 products are summed from zero by the tensor cores and added
// to c by rounded fp32 adds (a tensor core adding into c would truncate
// at every tile, and the chain's gates pass every dot's rounding on).
__device__ __forceinline__ void mma_stretch(float (&c)[4], uint4 a, uint4 b,
                                            uint4 x) {
  const uint32_t f0[4] = {a.x, b.x, a.y, b.y}, f1[4] = {a.z, b.z, a.w, b.w};
  float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p0, f0, x.x, x.y);
  mma_bf16(p1, f1, x.z, x.w);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(__fadd_rn(c[e], p0[e]), p1[e]);
}

__device__ __forceinline__ void mma_stretch(int (&c)[4], uint4 a, uint4 b,
                                            uint4 x) {
  const uint32_t f0[4] = {a.x, b.x, a.y, b.y}, f1[4] = {a.z, b.z, a.w, b.w};
  mma_s8_m16n8k32(c, f0, x.x, x.y);
  mma_s8_m16n8k32(c, f1, x.z, x.w);
}

__device__ __forceinline__ uint32_t quantize4(float4 v, float s) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t q = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q |= (uint32_t)(uint8_t)static_cast<int8_t>(rintf(__fdiv_rn(f[e], s)))
         << (8 * e);
  return q;
}

// Stage dot i's input rows b0 .. b0 + nb - 1: h = the state (dot 0) or
// the previous dot's gates, tiled to the state's width; written by other
// blocks, so read through L2. A thread takes the 4-float vectors j = tid,
// tid + 256, ... of the nb x K / 4 and tracks their (row, column) without
// dividing, kLoads loads in flight, and stores them as bf16 or, for
// W8A8, as fp32; then one warp a row takes sx[b] = fma(max|h_b|,
// fp32(1/127), 1e-12) and the block quantizes. (Two ways to skip the fp32
// pass were measured slower on the H100 and taken out: partial maxima
// left by each block beside the previous dot's outputs, and each
// thread's maxima reduced across the block with the vectors kept in
// registers.)
__device__ __noinline__ void chain_stage(const Chain& p, int i, int cur,
                                         int b0, int nb, unsigned char* sm,
                                         float* sx) {
  const int K = p.K[i], K4 = K >> 2, Q = p.N >> 2;
  const float* src = (i == 0 ? p.state[cur] : p.g[(i - 1) & 1]) +
                     (size_t)b0 * (i == 0 ? p.S : Q);
  const int ld = i == 0 ? p.S : Q, wrap = i == 0 ? K : Q;
  const int xs = row_stride(p.i8 ? K : 2 * K), total = nb * K4;
  unsigned char* st = sm + p.stage_off;
  float* xf = reinterpret_cast<float*>(sm + p.xf_off);
  int b = threadIdx.x / K4, f = threadIdx.x - b * K4;
  for (int j0 = threadIdx.x; j0 < total; j0 += kLoads * kThreads) {
    float4 v[kLoads];
    int bs[kLoads], fs[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      bs[u] = b;
      fs[u] = f;
      if (j0 + u * kThreads < total) {
        const int k = 4 * f < wrap ? 4 * f : 4 * f % wrap;
        v[u] = __ldcg(
            reinterpret_cast<const float4*>(src + (size_t)b * ld + k));
      }
      for (f += kThreads; f >= K4; f -= K4) ++b;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j0 + u * kThreads >= total) break;
      if (p.i8) {
        *reinterpret_cast<float4*>(xf + bs[u] * K + 4 * fs[u]) = v[u];
      } else {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
        *reinterpret_cast<uint2*>(st + bs[u] * xs + 8 * fs[u]) =
            make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                       *reinterpret_cast<const uint32_t*>(&hi));
      }
    }
  }
  __syncthreads();
  if (!p.i8) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nb) {
    float m = 0.f;
    for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(xf[warp * K + k]));
    m = warp_max(m);
    if (lane == 0) sx[warp] = __fmaf_rn(m, kInv127, 1e-12f);
  }
  __syncthreads();
  for (int r = 0; r < nb; ++r)
    for (int k = 4 * threadIdx.x; k < K; k += 4 * kThreads)
      *reinterpret_cast<uint32_t*>(st + r * xs + k) = quantize4(
          *reinterpret_cast<const float4*>(xf + r * K + k), sx[r]);
  __syncthreads();
}

// The stretches s = s0, s0 + nkp, ... < s1 of a warp from weight rows at
// wa, wb and staged row xs (each already offset to the lane's 16 bytes),
// stretch j of the range into chain j % 4. (Software-pipelining the
// rounds, the next round's loads in flight during this round's mmas, was
// measured slower.)
template <typename Acc>
__device__ __forceinline__ void chain_range(Acc (&acc)[kUnroll][4],
                                            const unsigned char* wa,
                                            const unsigned char* wb,
                                            const unsigned char* xs, int s0,
                                            int s1, int nkp) {
  const int step = kStretch * nkp;
  int s = s0, off = kStretch * s0;
  for (; s + (kUnroll - 1) * nkp < s1; s += kUnroll * nkp) {
    uint4 a[kUnroll], b[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u, off += step) {
      a[u] = *reinterpret_cast<const uint4*>(wa + off);
      b[u] = *reinterpret_cast<const uint4*>(wb + off);
      x[u] = *reinterpret_cast<const uint4*>(xs + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mma_stretch(acc[u], a[u], b[u], x[u]);
  }
#pragma unroll
  for (int u = 0; u + 1 < kUnroll; ++u, s += nkp, off += step)
    if (s < s1)
      mma_stretch(acc[u], *reinterpret_cast<const uint4*>(wa + off),
                  *reinterpret_cast<const uint4*>(wb + off),
                  *reinterpret_cast<const uint4*>(xs + off));
}

// This warp's part of dot i: m-tile w % m_tiles, every (8 / m_tiles)-th
// stretch of k from stretch w / m_tiles on, from shared memory (resident)
// or global memory; its sums go to the k-part's rows of the partial sums.
// Rows past the block's (a ragged last m-tile) and batch rows past nb
// read a valid row again: their sums are dropped.
template <typename Acc>
__device__ __forceinline__ void chain_products(const Chain& p, int i, int nb,
                                               int q0, int nrows,
                                               unsigned char* sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & (p.m_tiles - 1), nkp = p.nkp, kp = warp >> p.mt_bits;
  const int kb = p.i8 ? p.K[i] : 2 * p.K[i], ns = kb / kStretch;
  const int ra = 16 * mt + g, rb = ra + 8;
  const int ca = min(ra, nrows - 1), cb = min(rb, nrows - 1);
  const bool res = p.res_off[i] >= 0;
  const unsigned char* xs =
      sm + p.stage_off + min(g, nb - 1) * row_stride(kb) + 16 * t;
  const int ws = res ? row_stride(kb) : kb;
  const unsigned char* w =
      (res ? sm + p.res_off[i] : p.w[i] + (size_t)4 * q0 * kb) + 16 * t;
  Acc acc[kUnroll][4] = {};
  chain_range(acc, w + ca * ws, w + cb * ws, xs, kp, ns, nkp);
#pragma unroll
  for (int u = 1; u < kUnroll; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][e] += acc[u][e];
  // acc[0], acc[1]: row ra, batch rows 2t, 2t + 1; acc[2], acc[3]: row rb
  Acc* red = reinterpret_cast<Acc*>(sm + p.red_off) +
             (size_t)kp * 16 * p.m_tiles * kMaxB;
  red[ra * kMaxB + 2 * t] = acc[0][0];
  red[ra * kMaxB + 2 * t + 1] = acc[0][1];
  red[rb * kMaxB + 2 * t] = acc[0][2];
  red[rb * kMaxB + 2 * t + 1] = acc[0][3];
}

// One thread a (unit, batch row): the k-parts' sums in order, W8A8's
// scales, the gates, and after the last dot the state's blend.
__device__ __forceinline__ void chain_epilogue(const Chain& p, int i, int cur,
                                               int b0, int nb, int q0, int nq,
                                               const unsigned char* sm,
                                               const float* sx,
                                               const float (&so)[kOld]) {
  const int ql = threadIdx.x >> 3, b = threadIdx.x & 7;
  if (ql >= nq || b >= nb) return;
  // k-part k's sum of row 4 ql + c, batch row b
  const int tile = 16 * p.m_tiles, at = 4 * ql * kMaxB + b;
  float y[4];
  if (p.i8) {
    const int* red = reinterpret_cast<const int*>(sm + p.red_off) + at;
    int a[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kWarps; ++k)
      if (k < p.nkp)
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] += red[(k * tile + c) * kMaxB];
    const float* sc = reinterpret_cast<const float*>(sm + p.scale_off) +
                      i * tile + 4 * ql;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      y[c] = __fmul_rn(__fmul_rn(__int2float_rn(a[c]), sx[b]), sc[c]);
  } else {
    const float* red = reinterpret_cast<const float*>(sm + p.red_off) + at;
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k)
      if (k < p.nkp)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          y[c] = __fadd_rn(y[c], red[(k * tile + c) * kMaxB]);
  }
  const float gv = sigmoidf(y[0]) * tanhf(y[1]) + sigmoidf(y[2]) * tanhf(y[3]);
  const int Q = p.N >> 2, u = q0 + ql;
  const size_t row = (size_t)(b0 + b);
  p.g[i & 1][row * Q + u] = gv;
  if (i == p.n_dots - 1) {
    const float* s_old = p.state[cur] + row * p.S;
    float* s_new = p.state[cur ^ 1] + row * p.S;
#pragma unroll
    for (int r = 0; r < kOld; ++r)
      if (u + r * Q < p.S) s_new[u + r * Q] = blend(so[r], gv);
    for (int j = u + kOld * Q; j < p.S; j += Q)
      s_new[j] = blend(s_old[j], gv);
  }
}

// The old state values the last dot's epilogue blends, loaded before the
// products so that their round trip overlaps them: thread (unit, batch
// row) of chain_epilogue, columns u, u + N / 4, ... (the first kOld).
__device__ __forceinline__ void chain_old_state(const Chain& p, int cur,
                                                int b0, int nb, int q0,
                                                int nq, float (&so)[kOld]) {
  const int ql = threadIdx.x >> 3, b = threadIdx.x & 7, Q = p.N >> 2;
  if (ql >= nq || b >= nb) return;
  const float* s_old = p.state[cur] + (size_t)(b0 + b) * p.S;
#pragma unroll
  for (int r = 0; r < kOld; ++r)
    if (q0 + ql + r * Q < p.S) so[r] = s_old[q0 + ql + r * Q];
}

__global__ void __launch_bounds__(kThreads, 1)
    chain_kernel(const __grid_constant__ Chain param) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ float sx[kMaxB];
  // the launch's parameters in shared memory: the stages index them by
  // the dot, and a kernel parameter read through its address costs a
  // round trip of its own
  __shared__ Chain p;
  if (threadIdx.x == 0) p = param;
  __syncthreads();
  const int Q = p.N >> 2;
  const int q0 = (int)((long long)blockIdx.x * Q / p.grid);
  const int nq = (int)((long long)(blockIdx.x + 1) * Q / p.grid) - q0;
  const int nrows = 4 * nq, tile = 16 * p.m_tiles;

  // this block's rows of every resident dot and W8A8's scales, once
  for (int i = 0; i < p.n_dots; ++i) {
    if (p.res_off[i] < 0) continue;
    const int kb = p.i8 ? p.K[i] : 2 * p.K[i], per = kb / 16;
    const uint4* src =
        reinterpret_cast<const uint4*>(p.w[i] + (size_t)4 * q0 * kb);
    for (int j = threadIdx.x; j < nrows * per; j += kThreads)
      *reinterpret_cast<uint4*>(sm + p.res_off[i] + (j / per) * row_stride(kb)
                                + 16 * (j % per)) = __ldg(src + j);
  }
  if (p.i8)
    for (int j = threadIdx.x; j < p.n_dots * nrows; j += kThreads)
      reinterpret_cast<float*>(sm + p.scale_off)[(j / nrows) * tile +
                                                 j % nrows] =
          p.scale[j / nrows][4 * q0 + j % nrows];
  __syncthreads();

  unsigned passed = 0;
  for (int t = 0; t < p.steps; ++t) {
    const int cur = t & 1;
    for (int i = 0; i < p.n_dots; ++i) {
      for (int b0 = 0; b0 < p.B; b0 += kMaxB) {
        const int nb = min(kMaxB, p.B - b0);
        chain_stage(p, i, cur, b0, nb, sm, sx);
        float so[kOld];
        if (i == p.n_dots - 1) chain_old_state(p, cur, b0, nb, q0, nq, so);
        if (p.i8)
          chain_products<int>(p, i, nb, q0, nrows, sm);
        else
          chain_products<float>(p, i, nb, q0, nrows, sm);
        __syncthreads();
        chain_epilogue(p, i, cur, b0, nb, q0, nq, sm, sx, so);
        if (b0 + kMaxB < p.B) __syncthreads();   // staged rows, sums free
      }
      barrier_arrive(p.bar);
      barrier_wait(p.bar, ++passed * (unsigned)p.grid);
      if (p.clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        p.clock[(size_t)t * p.n_dots + i] = gtime();
    }
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return -1;
  return sms;
}

}  // namespace

extern "C" {

const char* resident_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the cooperative launch: one per SM, at most N / 4.
int resident_grid(int N) {
  const int sms = sm_count();
  if (sms < 0) return -1;
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

// P3's scan: w[0] packed (N, K) bf16 (K == S); state0/state1 (B, S) bf16,
// state0 the initial state; the final state is in state[steps & 1]; y_last
// (B, N) fp32. ops/resident.py:p3_check checks the same shapes and names
// what fails.
int resident_scan(int B, int steps, int N, int S, int K,
                  const void* const* w, void* state0, void* state1,
                  float* y_last, void* stream_handle) {
  if (B < 1 || steps < 1 || N % 4) return cudaErrorInvalidValue;
  Params p = {};
  p.B = B;
  p.steps = steps;
  p.N = N;
  p.S = S;
  p.grid = resident_grid(N);
  if (p.grid < 1) return cudaErrorInvalidValue;
  p.K[0] = K;
  p.w[0] = w[0];
  p.state[0] = state0;
  p.state[1] = state1;
  p.y_last = y_last;
  int dev = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  const int qmax = (N / 4 + p.grid - 1) / p.grid;
  // the resident slice (kP3Cols padded rows), the ring, the k-halves' sums
  if (K != S || K % kP3Chunk || N < S || qmax * 4 > kP3Cols)
    return cudaErrorInvalidValue;
  p.smem_off[0] = 0;
  p.stage_off = (size_t)kP3Cols * (K + kPad) * 2;
  p.red_off = p.stage_off + (size_t)kP3Stages * kP3Rows * kP3XS * 2;
  const size_t used = p.red_off + (size_t)kP3Rows * kP3RS * 4;
  if (used > (size_t)optin) return cudaErrorInvalidValue;
  const void* kernel = (const void*)p3_kernel;
  if ((err = cudaFuncSetAttribute(kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)used)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, used)))
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, p.grid, kThreads, args, used,
                                    static_cast<cudaStream_t>(stream_handle));
  if (err) return err;
  return cudaGetLastError();
}

// P4's chain: body 1 = bf16, 2 = W8A8; the layout from
// ops/resident.py:chain_plan: grid blocks, m_tiles, smem dynamic bytes,
// layout = {stage_off, xf_off, red_off, scale_off}, res_off[i] per dot.
// w[i] packed (N, K[i]) bf16 or int8, scale[i] (N,) fp32 packed (W8A8).
// state0/state1 (B, S) fp32, state0 the initial state, the final one in
// state[steps & 1]; g0, g1 (B, N / 4) fp32, the last dot's gates in
// g[(n_dots - 1) & 1]. bar: one zeroed word. clock: null or (steps,
// n_dots) int64.
int resident_chain(int body, int B, int steps, int n_dots, int N, int S,
                   int grid, int m_tiles, int smem, const int* K,
                   const int* layout, const int* res_off, const void* const* w,
                   const float* const* scale, float* state0, float* state1,
                   float* g0, float* g1, long long* clock, unsigned* bar,
                   void* stream_handle) {
  const int Q = N / 4;
  if ((body != kChainBf16 && body != kChainW8A8) || n_dots < 1 ||
      n_dots > kMaxDots || B < 1 || steps < 1 || N % 16 || S % 4 ||
      grid < 1 || grid > Q || m_tiles < 1 || m_tiles > kWarps ||
      (m_tiles & (m_tiles - 1)) || 16 * m_tiles < 4 * ((Q + grid - 1) / grid))
    return cudaErrorInvalidValue;
  Chain p = {};
  p.i8 = body == kChainW8A8;
  p.B = B;
  p.steps = steps;
  p.n_dots = n_dots;
  p.N = N;
  p.S = S;
  p.grid = grid;
  p.m_tiles = m_tiles;
  p.nkp = kWarps / m_tiles;
  while ((1 << p.mt_bits) < m_tiles) ++p.mt_bits;
  const int esize = p.i8 ? 1 : 2;
  for (int i = 0; i < n_dots; ++i) {
    if ((K[i] * esize) % kStretch || K[i] > S) return cudaErrorInvalidValue;
    p.K[i] = K[i];
    p.res_off[i] = res_off[i];
    p.w[i] = static_cast<const unsigned char*>(w[i]);
    p.scale[i] = p.i8 ? scale[i] : nullptr;
  }
  p.stage_off = layout[0];
  p.xf_off = layout[1];
  p.red_off = layout[2];
  p.scale_off = layout[3];
  p.state[0] = state0;
  p.state[1] = state1;
  p.g[0] = g0;
  p.g[1] = g1;
  p.bar = bar;
  p.clock = clock;

  int dev = 0, optin = 0, sms = sm_count(), per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(
           &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if (smem + kStatic > optin) return cudaErrorInvalidValue;
  const void* kernel = (const void*)chain_kernel;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           kThreads, smem)))
    return err;
  if (per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;

  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, grid, kThreads, args, smem,
                                    static_cast<cudaStream_t>(stream_handle));
  if (err) return err;
  return cudaGetLastError();
}

}  // extern "C"
