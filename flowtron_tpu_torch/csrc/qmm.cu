// K4: the quantized matmul of the serving modes, fp32 or bf16 activations,
// on the tensor cores.
//
// Replaces flowtron_tpu/ops/qmm_pallas.py:quantized_matmul (pallas_call at
// :94) and both of its bodies:
//
//   _qmm_kernel (:31), weight-only:   out = (x @ float(q)^T) * s
//   _qmm_w8a8_kernel (:37), W8A8:     sx  = max|x_row| * fp32(1/127),
//                                           1 where 0
//                                     xq  = clip(rint(x / sx), -127, 127)
//                                     acc = xq @ q^T            (int32)
//                                     out = (float(acc) * sx) * s
//
// x is (M, K) fp32 or bf16, q is (N, K) int8 in torch's (out, in) layout
// (the Pallas kernel takes (K, N)), s is (N,) fp32, out is (M, N) in x's
// dtype (the Pallas kernel's out_dtype, which its callers set so). The
// Pallas body divides by 127.0, which XLA compiles to a multiply by the
// fp32 reciprocal; this kernel does the same, so its W8A8 output is the
// JAX kernel's to the bit (ops/qmm.py says more).
//
// What bounds it on an H100: each call's fixed latency, then bytes. On the
// decoder's per-frame path M is the batch (<= 8) and each call streams one
// int8 weight matrix once: 6.8 MB at (K, N) = (1664, 4096) against 2 * 8 *
// 1664 * 4096 = 0.11 G operations. One flow-frame's nine calls read 26.7
// MB, about 8 us at 3.35 TB/s (the published peak), and a flow's 26.7 MB
// fits the 50 MB L2; against that each call pays a launch, the wait on the
// kernel before it, and the round trips that bring x and q.
//
// One design for every body. The product is computed transposed, out^T
// (N x M) = q (N x K) x^T, so the small M is the mma's n = 8 and q,
// K-contiguous, is the row-major A operand: a warp owns 16 output columns
// (m = 16) and up to 8 tiles of 8 rows of x, and its A fragments serve
// every row tile.
// - q goes from device memory straight into the A fragments: for each
//   64-byte stretch of k, lane t of a quad loads the 16 bytes at 16 t of
//   its rows g = lane / 4 and g + 8, up to kGroup stretches in flight a
//   lane, issued before anything else; the mma's k order is a permutation
//   of those bytes, and the B fragments (x) take the same permutation, so
//   every product still pairs q[n, k] with x[m, k] and no staging of q is
//   needed;
// - x is staged once a block in shared memory while the weight loads are
//   in flight, zero past K and M, with the epilogue's scales;
// - the host (ops/qmm.py:qmm_plan) chooses the column tiles and the split
//   of K over a block's warps; partial sums meet in shared memory, each
//   output's added in split order by one thread: no atomics, bitwise
//   repeatable;
// - W8A8: mma.sync m16n8k32 s8 -> s32, exact sums in any order, so the
//   epilogue's two rounded multiplies give the plain version's bits;
// - ragged shapes: loads past K, N and M read zeros; q rows that are not
//   16-byte aligned (K % 16 != 0) are loaded byte by byte.
// By x's dtype:
// - W8A8 (either dtype): a first launch quantizes x into a zero-padded
//   int8 scratch (a row over several blocks, each taking the whole row's
//   max: then rintf(x / sx), a true division, jnp.round's
//   round-half-to-even; a bf16 x is read as fp32, as _qmm_w8a8_kernel's
//   x.astype(f32)); the product is its programmatic dependent and waits
//   only before it reads xq and sx. A one-launch form, each block
//   quantizing its own rows, was built for bf16 x and timed slower on the
//   frame's nine calls in order: every block redid the whole rows' max and
//   divisions (PERF.md);
// - fp32 weight-only: mma.sync m16n8k8 tf32 -> fp32. q is exact in tf32
//   (the 2^23-exponent trick and one subtract); x is staged as its tf32
//   pieces hi = tf32(x) and lo = tf32(x - hi), two mmas into one
//   accumulator, about 2^-22 relative error a product; with one or two row
//   tiles a warp, words of k go to 4 or 2 accumulator sets, added in order
//   at the end; s is applied once at the end, as _qmm_kernel applies it;
// - bf16 weight-only (the body the Pallas kernel runs under the JAX
//   server's --bf16): one mma.sync m16n8k16 bf16 pass; q's bytes become
//   bf16 in 1.75 instructions a byte, exactly: with b a byte and L = b &
//   0x7f, the bf16 0x4300 | L is 128 + L and 0x4300 | (b & 0x80) is 128 or
//   256, so their difference (one bf16x2 subtract) is the signed value;
//   even bytes of a word sit in the low byte of each half already, odd
//   bytes take one PRMT, so a word gives the pairs (k0, k2) and (k1, k3),
//   and x is staged with each group of 4 in that order; fp32 sums, scaled
//   by s in fp32 and rounded once, as _qmm_kernel's (acc * s).astype(bf16).
//   A producer warp feeding a shared-memory ring by bulk tensor copies, a
//   cluster splitting K, and a programmatic launch were each built for it
//   and timed slower on the frame's nine calls in order (PERF.md).
// What is left (PERF.md): the fixed cost of a call (the launch, the round
// trip for x, W8A8's second launch and ~2 us of quantize on its critical
// path), and the int8 weights re-read from L2 every frame.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int kTileN = 16;        // output columns a warp (the mma's m)
constexpr int kTileM = 8;         // rows of x a tile (the mma's n)
constexpr int kStretch = 64;      // k a quad of lanes loads at once
constexpr int kGroup = 4;         // stretches a lane keeps in flight
constexpr int kMaxWarps = 16;     // 8 with 4 or 8 row tiles a warp
constexpr int kMaxCols = kMaxWarps * kTileN;   // a block's columns
constexpr int kMaxRows = 8 * kTileM;            // a block's rows of x
// dynamic shared memory a block may take beside the staged scales
constexpr int kMaxSmem = 227 * 1024 - 4 * (kMaxCols + kMaxRows);
constexpr int kQuantThreads = 128;
constexpr int kQuantSlice = 4 * kQuantThreads;  // xq bytes a quantize block
constexpr float kInv127 = 1.0f / 127.0f;  // XLA's folded 1/127

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// x's element as fp32 (exact for bf16), and four of them from an aligned
// address (16 bytes of fp32, 8 of bf16).
__device__ __forceinline__ float as_f32(float v) { return v; }
__device__ __forceinline__ float as_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Block (p, m) quantizes bytes p * kQuantSlice .. + kQuantSlice - 1 of
// row m: every block of a row takes sx = max|x| * fp32(1/127) (1 where 0)
// over the whole row, then writes xq = clip(rint(x / sx)) for its slice,
// four bytes a thread, zero past K. Spreading a row over blocks keeps the
// true divisions few a thread at small M. A bf16 x is read as fp32, as
// _qmm_w8a8_kernel's x.astype(f32).
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
quantize_rows_kernel(const T* __restrict__ x, int K, int Kp,
                     int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float part[kQuantThreads / 32];
  // the product launch may start now: it loads its weights, then waits
  // for this grid to finish before it reads xq and sx
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int m = blockIdx.y;
  const T* row = x + (size_t)m * K;
  const bool vec = (K & 3) == 0;
  float amax = 0.f;
  if (vec) {
#pragma unroll 4
    for (int k = 4 * threadIdx.x; k < K; k += 4 * kQuantThreads) {
      const float4 v = load4(row + k);
      amax = fmaxf(fmaxf(amax, fabsf(v.x)), fmaxf(fabsf(v.y), fabsf(v.z)));
      amax = fmaxf(amax, fabsf(v.w));
    }
  } else {
    for (int k = threadIdx.x; k < K; k += kQuantThreads)
      amax = fmaxf(amax, fabsf(as_f32(row[k])));
  }
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part[0];
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  float scale = __fmul_rn(amax, kInv127);
  if (scale == 0.f) scale = 1.f;
  const int k = blockIdx.x * kQuantSlice + 4 * threadIdx.x;
  if (k < Kp) {                           // Kp % 4 == 0
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (vec && k < K) {
      const float4 f = load4(row + k);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (k + i < K) v[i] = as_f32(row[k + i]);
    }
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float r = 0.f;
      if (k + i < K) {
        r = rintf(__fdiv_rn(v[i], scale));
        r = fminf(fmaxf(r, -127.f), 127.f);
      }
      w |= (uint32_t)(uint8_t)(int8_t)r << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(xq + (size_t)m * Kp + k) = w;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sx[m] = scale;
}

__host__ __device__ __forceinline__ int padded_k(int K) {
  return (K + kStretch - 1) / kStretch * kStretch;
}

// Bytes between staged int8 rows: Kp, or Kp + 64 where Kp is a multiple
// of 128, so rows g and g + 1 lie in opposite halves of the 128-byte bank
// window.
__host__ __device__ __forceinline__ int xq_stride(int Kp) {
  return Kp % 128 == 64 ? Kp : Kp + 64;
}

// Bytes between staged bf16 rows of x: 2 Kp + 16, so that a quarter-warp's
// 16-byte loads (rows g, g + 1; 32 bytes apart along k) hit 8 distinct
// bank groups.
__host__ __device__ __forceinline__ int xb_stride(int Kp) {
  return 2 * Kp + 16;
}

// Where chunk c (4 floats) of staged fp32 row r lies: within each 16-chunk
// stretch, chunk 4 t + j moves to 4 t + (j ^ ((t ^ r) & 3)), so the four
// lanes of a quad (t = 0..3, one 64-byte piece each) and the two rows of a
// quarter-warp read 8 distinct bank groups.
__device__ __forceinline__ int x_chunk(int r, int c) {
  return (c & ~3) | ((c ^ ((c >> 2) ^ r)) & 3);
}

// 16 bytes of a q row from k on, zeros past K (or for a row past N).
template <bool kVec>
__device__ __forceinline__ int4 load_q16(const int8_t* row, bool valid, int k,
                                         int K) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!valid || k >= K) return v;
  if (kVec) return __ldg(reinterpret_cast<const int4*>(row + k));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < K)
      w[i >> 2] |= (uint32_t)(uint8_t)__ldg(row + k + i) << (8 * (i & 3));
  v.x = (int)w[0], v.y = (int)w[1], v.z = (int)w[2], v.w = (int)w[3];
  return v;
}

// x's tf32 pieces: hi = tf32(v), lo = tf32(v - hi), as fp32 bit patterns.
__device__ __forceinline__ void split_tf32(float v, float& hi, float& lo) {
  hi = __uint_as_float(tf32_rna(v));
  lo = __uint_as_float(tf32_rna(__fsub_rn(v, hi)));
}

// Rows m0 .. m0 + rows - 1 of xq (int8, padded rows) or of fp32 x (its
// tf32 hi and lo pieces, two swizzled planes of rows x Kp floats) into
// shared memory, zero past K and M; the caller's block barrier ends it.
// fp32 x is read with kStage 16-byte loads in flight a thread, then split.
template <bool kA8>
__device__ void stage_x(unsigned char* smem, const float* __restrict__ x,
                        const int8_t* __restrict__ xq, int M, int K, int Kp,
                        int m0, int rows) {
  constexpr int kStage = 8;
  if (kA8) {
    const int per_row = Kp / 16, stride = xq_stride(Kp);
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, c = i - r * per_row, m = m0 + r;
      const bool ok = m < M;
      cp_async16_zfill(smem + (size_t)r * stride + 16 * c,
                       ok ? xq + (size_t)m * Kp + 16 * c : xq, ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else if ((K & 3) == 0) {              // 16-byte pieces of x rows
    const int per_row = Kp / 4, total = rows * per_row;
    float4* hi = reinterpret_cast<float4*>(smem);
    float4* lo = hi + total;
    for (int base = threadIdx.x; base < total; base += kStage * blockDim.x) {
      float4 v[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = base + u * blockDim.x, r = i / per_row;
        const int c = i - r * per_row, m = m0 + r;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < total && m < M && 4 * c < K)
          v[u] = __ldg(reinterpret_cast<const float4*>(x + (size_t)m * K +
                                                       4 * c));
      }
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int i = base + u * blockDim.x, r = i / per_row;
        if (i >= total) break;
        const int d = r * per_row + x_chunk(r, i - r * per_row);
        float4 h, l;
        split_tf32(v[u].x, h.x, l.x);
        split_tf32(v[u].y, h.y, l.y);
        split_tf32(v[u].z, h.z, l.z);
        split_tf32(v[u].w, h.w, l.w);
        hi[d] = h;
        lo[d] = l;
      }
    }
  } else {
    float* hi = reinterpret_cast<float*>(smem);
    float* lo = hi + rows * Kp;
    for (int i = threadIdx.x; i < rows * Kp; i += blockDim.x) {
      const int r = i / Kp, k = i - r * Kp, m = m0 + r;
      const int d = 4 * (r * (Kp / 4) + x_chunk(r, k >> 2)) + (k & 3);
      split_tf32(m < M && k < K ? x[(size_t)m * K + k] : 0.f, hi[d], lo[d]);
    }
  }
}

// Byte i of u (a biased byte, b + 128) as the fp32 value b, exactly:
// 0x4B0000uu is 2^23 + uu.
__device__ __forceinline__ uint32_t byte_to_tf32(uint32_t u, int i) {
  return __float_as_uint(
      __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)),
                8388736.f));                 // 2^23 + 128
}

__device__ __forceinline__ int word(int4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t word(uint4 v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Accumulator sets a warp keeps: the weight-only bodies run dependent mmas
// back to back, so with few row tiles word j of a lane's 16 bytes goes to
// set j % sets, and the sets are added in order at the end.
template <bool kA8, int MT>
__host__ __device__ constexpr int acc_sets() {
  return kA8 ? 1 : MT == 1 ? 4 : MT == 2 ? 2 : 1;
}

// (a - b) on each bf16 half.
__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Bytes 0 and 2 of u (signed) as a bf16 pair, exactly: with L = b & 0x7f,
// 0x4300 | L is 128 + L and 0x4300 | (b & 0x80) is 128 or 256.
__device__ __forceinline__ uint32_t even_bytes_bf16x2(uint32_t u) {
  return bf16x2_sub((u & 0x007f007fu) | 0x43004300u,
                    (u & 0x00800080u) | 0x43004300u);
}

// Bytes 1 and 3 of u (signed) as a bf16 pair: one PRMT brings them to the
// low byte of each half beside 0x43, then as even_bytes_bf16x2.
__device__ __forceinline__ uint32_t odd_bytes_bf16x2(uint32_t u) {
  const uint32_t r = __byte_perm(u, 0x43434343u, 0x4341);
  return bf16x2_sub(r & 0xff7fff7fu, r & 0xff80ff80u);
}

// Eight bf16 of x row m from k on (k % 8 == 0), as bits, zeros past K and
// M: one 16-byte load where the rows are 16-byte aligned (K % 8 == 0).
__device__ __forceinline__ uint4 x_bf16_chunk(const __nv_bfloat16* x,
                                              int M, int K, int m, int k) {
  if (m >= M || k >= K) return make_uint4(0u, 0u, 0u, 0u);
  const uint16_t* p = reinterpret_cast<const uint16_t*>(x) + (size_t)m * K + k;
  if (K % 8 == 0) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t e[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = k + i < K ? __ldg(p + i) : 0u;
  return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                    e[6] | e[7] << 16);
}

// Weight-only's bf16 rows m0 .. m0 + rows - 1 of x into shared memory
// (xb_stride(Kp) bytes apart, zeros past K and M), each group of 4 as k0,
// k2, k1, k3 (the mma's pairing of q's bytes); the caller's block barrier
// ends it.
__device__ void stage_x_bf16(unsigned char* smem,
                             const __nv_bfloat16* __restrict__ x, int M,
                             int K, int Kp, int m0, int rows) {
  const int stride = xb_stride(Kp), chunks = Kp / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = i - r * chunks;
    const uint4 u = x_bf16_chunk(x, M, K, m0 + r, 8 * c);
    *reinterpret_cast<uint4*>(smem + r * stride + 16 * c) =
        make_uint4(__byte_perm(u.x, u.y, 0x5410),
                   __byte_perm(u.x, u.y, 0x7632),
                   __byte_perm(u.z, u.w, 0x5410),
                   __byte_perm(u.z, u.w, 0x7632));
  }
}

// One 64-byte stretch s of k into the accumulators of every row tile: ra
// and rb hold this lane's 16 bytes of q rows g and g + 8.
template <bool kA8, bool kBF, int MT, int kSets, typename Acc>
__device__ __forceinline__ void stretch_mma(Acc (&acc)[kSets][MT][4], int4 ra,
                                            int4 rb, const unsigned char* smem,
                                            int s, int Kp, int g, int t) {
  if constexpr (kA8) {
    // mma 0 takes bytes 0..7 of the lane's 16 (k 4t..4t+3 and 16+4t..),
    // mma 1 bytes 8..15; b: the same bytes of xq row g.
    const uint32_t a0[4] = {(uint32_t)ra.x, (uint32_t)rb.x, (uint32_t)ra.y,
                            (uint32_t)rb.y};
    const uint32_t a1[4] = {(uint32_t)ra.z, (uint32_t)rb.z, (uint32_t)ra.w,
                            (uint32_t)rb.w};
    const int stride = xq_stride(Kp);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int4 b = *reinterpret_cast<const int4*>(
          smem + (size_t)(i * kTileM + g) * stride + s * kStretch + 16 * t);
      mma_s8_m16n8k32(acc[0][i], a0, (uint32_t)b.x, (uint32_t)b.y);
      mma_s8_m16n8k32(acc[0][i], a1, (uint32_t)b.z, (uint32_t)b.w);
    }
  } else if constexpr (kBF) {
    // word j (k 16 t + 4 j .. + 3) feeds one k16 mma: bytes 0, 2 at its
    // k 2t, 2t + 1 and bytes 1, 3 at 2t + 8, 2t + 9; b: the same four of x
    // row g, staged in that order (32 bytes a lane, two loads)
    uint32_t a[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t ua = (uint32_t)word(ra, j), ub = (uint32_t)word(rb, j);
      a[j][0] = even_bytes_bf16x2(ua);
      a[j][1] = even_bytes_bf16x2(ub);
      a[j][2] = odd_bytes_bf16x2(ua);
      a[j][3] = odd_bytes_bf16x2(ub);
    }
    const int stride = xb_stride(Kp);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const uint4* px = reinterpret_cast<const uint4*>(
          smem + (size_t)(i * kTileM + g) * stride + 2 * (s * kStretch) +
          32 * t);
      const uint4 x0 = px[0], x1 = px[1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 xv = j < 2 ? x0 : x1;
        mma_bf16(acc[j % kSets][i], a[j], word(xv, 2 * (j & 1)),
                 word(xv, 2 * (j & 1) + 1));
      }
    }
  } else {
    // Word j of the lane's 16 bytes feeds two k8 mmas: bytes 0, 1 (its k
    // t and t + 4) and bytes 2, 3; b: the same floats of x row g, as
    // their staged tf32 hi and lo pieces.
    const int per_row = Kp / 4, swz = (t ^ g) & 3;
    const float4* xh = reinterpret_cast<const float4*>(smem);
    const float4* xl = xh + MT * kTileM * per_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t ua = (uint32_t)word(ra, j) ^ 0x80808080u;
      const uint32_t ub = (uint32_t)word(rb, j) ^ 0x80808080u;
      const uint32_t a0[4] = {byte_to_tf32(ua, 0), byte_to_tf32(ub, 0),
                              byte_to_tf32(ua, 1), byte_to_tf32(ub, 1)};
      const uint32_t a1[4] = {byte_to_tf32(ua, 2), byte_to_tf32(ub, 2),
                              byte_to_tf32(ua, 3), byte_to_tf32(ub, 3)};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int idx = (i * kTileM + g) * per_row + s * 16 + 4 * t + (j ^ swz);
        const float4 h = xh[idx], l = xl[idx];
        float (&c)[4] = acc[j % kSets][i];
        mma_tf32_m16n8k8(c, a0, __float_as_uint(h.x), __float_as_uint(h.y));
        mma_tf32_m16n8k8(c, a0, __float_as_uint(l.x), __float_as_uint(l.y));
        mma_tf32_m16n8k8(c, a1, __float_as_uint(h.z), __float_as_uint(h.w));
        mma_tf32_m16n8k8(c, a1, __float_as_uint(l.z), __float_as_uint(l.w));
      }
    }
  }
}

// Grid (column blocks, row blocks); block ct * ks warps. Warp w owns
// column tile w % ct of its block and part w / ct of the block's K
// stretches (part p: stretches p S / ks .. (p + 1) S / ks - 1), and MT
// row tiles. kVec: q rows are 16-byte aligned (K % 16 == 0). kBF: out is
// bf16, and so is x (W8A8 reads xq whatever x was); else both are fp32.
template <bool kA8, int MT, bool kVec, bool kBF>
__global__ void __launch_bounds__(MT >= 4 ? 256 : 512)
qmm_kernel(const void* __restrict__ x, const int8_t* __restrict__ xq,
           const float* __restrict__ sx, const int8_t* __restrict__ q,
           const float* __restrict__ s, void* __restrict__ out, int M, int K,
           int N, int ct, int ks) {
  using Acc = std::conditional_t<kA8, int, float>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wct = warp % ct, wks = warp / ct;
  const int n0 = (blockIdx.x * ct + wct) * kTileN;
  const int m0 = blockIdx.y * kTileM * MT;
  const int Kp = padded_k(K), S = Kp / kStretch;
  const int s_beg = wks * S / ks, s_end = (wks + 1) * S / ks;
  const bool va = n0 + g < N, vb = n0 + g + 8 < N;
  const int8_t* qa = q + (size_t)(va ? n0 + g : 0) * K;
  const int8_t* qb = q + (size_t)(vb ? n0 + g + 8 : 0) * K;

  // the epilogue's scales (s of the block's columns, W8A8's sx of its
  // rows) go to shared memory with the staged x, so no global load waits
  // at the end
  __shared__ float s_sh[kMaxCols], sx_sh[kMaxRows];
  const int cols = ct * kTileN, rows = MT * kTileM;
  const int c0 = blockIdx.x * cols;
  const float s_v = threadIdx.x < cols && c0 + (int)threadIdx.x < N
                        ? s[c0 + threadIdx.x] : 0.f;

  // the first group of weight loads, in flight while x is staged
  int4 ra[kGroup], rb[kGroup];
#pragma unroll
  for (int u = 0; u < kGroup; ++u) {
    const int k = (s_beg + u) * kStretch + 16 * t;
    const bool in = s_beg + u < s_end;
    ra[u] = load_q16<kVec>(qa, va && in, k, K);
    rb[u] = load_q16<kVec>(qb, vb && in, k, K);
  }
  // W8A8 starts while its quantize launch runs (a programmatic dependent
  // launch); xq and sx are read only after this wait
  if constexpr (kA8) {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    float sx_v[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = threadIdx.x + h * blockDim.x;
      if (r < rows && m0 + r < M) sx_v[h] = sx[m0 + r];
    }
    stage_x<true>(smem, nullptr, xq, M, K, Kp, m0, rows);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (threadIdx.x + h * blockDim.x < rows)
        sx_sh[threadIdx.x + h * blockDim.x] = sx_v[h];
  } else if constexpr (kBF) {
    stage_x_bf16(smem, static_cast<const __nv_bfloat16*>(x), M, K, Kp, m0,
                 rows);
  } else {
    stage_x<false>(smem, static_cast<const float*>(x), xq, M, K, Kp, m0,
                   rows);
  }
  if (threadIdx.x < cols) s_sh[threadIdx.x] = s_v;
  __syncthreads();

  constexpr int kSets = acc_sets<kA8, MT>();
  Acc sets[kSets][MT][4];
#pragma unroll
  for (int h = 0; h < kSets; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sets[h][i][c] = 0;
  for (int s0 = s_beg; s0 < s_end; s0 += kGroup) {
    if (s0 != s_beg) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = (s0 + u) * kStretch + 16 * t;
        const bool in = s0 + u < s_end;
        ra[u] = load_q16<kVec>(qa, va && in, k, K);
        rb[u] = load_q16<kVec>(qb, vb && in, k, K);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (s0 + u < s_end)
        stretch_mma<kA8, kBF, MT>(sets, ra[u], rb[u], smem, s0 + u, Kp, g,
                                  t);
  }
  Acc (&acc)[MT][4] = sets[0];
#pragma unroll
  for (int h = 1; h < kSets; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] += sets[h][i][c];

  // acc[i][c] of warp column tile wc and lane ln: column (wc * 16 + ln /
  // 4, + 8 for c >= 2) of the block's, row (8 i + 2 (ln % 4), + 1 for
  // odd c) of its rows
  auto store = [&](int wc, int i, int c, int ln, Acc v) {
    const int cn = wc * kTileN + (ln >> 2) + (c >= 2 ? 8 : 0);
    const int rm = i * kTileM + 2 * (ln & 3) + (c & 1);
    if (c0 + cn >= N || m0 + rm >= M) return;
    float y;
    if constexpr (kA8)
      y = __fmul_rn(__fmul_rn(__int2float_rn(v), sx_sh[rm]), s_sh[cn]);
    else
      y = __fmul_rn(v, s_sh[cn]);
    const size_t o = (size_t)(m0 + rm) * N + c0 + cn;
    if constexpr (kBF)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[o] = y;
  };
  if (ks == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) store(wct, i, c, lane, acc[i][c]);
    return;
  }
  // the K parts' sums meet in shared memory; each thread adds one output's
  // parts in part order
  __syncthreads();                        // every warp is done with x
  Acc* part = reinterpret_cast<Acc*>(smem);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      part[(((wks * ct + wct) * MT + i) * 4 + c) * 32 + lane] = acc[i][c];
  __syncthreads();
  const int per_part = ct * MT * 4 * 32;
  for (int e = threadIdx.x; e < per_part; e += blockDim.x) {
    Acc v = part[e];
    for (int p = 1; p < ks; ++p) v += part[p * per_part + e];
    const int ln = e & 31, c = (e >> 5) & 3, i = (e >> 7) % MT;
    store(e / (MT * 128), i, c, ln, v);
  }
}

using Kernel = void (*)(const void*, const int8_t*, const float*,
                        const int8_t*, const float*, void*, int, int, int,
                        int, int);

template <bool kA8, bool kVec, bool kBF>
Kernel pick_mt(int mt) {
  switch (mt) {
    case 1: return qmm_kernel<kA8, 1, kVec, kBF>;
    case 2: return qmm_kernel<kA8, 2, kVec, kBF>;
    case 4: return qmm_kernel<kA8, 4, kVec, kBF>;
    case 8: return qmm_kernel<kA8, 8, kVec, kBF>;
    default: return nullptr;
  }
}

template <bool kBF>
Kernel pick_bf(bool a8, bool vec, int mt) {
  if (a8)
    return vec ? pick_mt<true, true, kBF>(mt) : pick_mt<true, false, kBF>(mt);
  return vec ? pick_mt<false, true, kBF>(mt) : pick_mt<false, false, kBF>(mt);
}

Kernel pick(bool a8, bool vec, bool bf, int mt) {
  return bf ? pick_bf<true>(a8, vec, mt) : pick_bf<false>(a8, vec, mt);
}

// Shared memory (bytes) a block of the plan (ct, ks, mt) takes: the
// larger of the staged rows of x and the K parts' partial sums.
int qmm_smem_bytes(int K, int a8, int bf, int ct, int ks, int mt) {
  const int Kp = padded_k(K), rows = mt * kTileM;
  const int stage = a8 ? rows * xq_stride(Kp)
                       : bf ? rows * xb_stride(Kp) : 2 * rows * Kp * 4;
  const int part = ks > 1 ? ks * ct * mt * 4 * 32 * 4 : 0;
  return stage > part ? stage : part;
}

}  // namespace

extern "C" {

const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launches of one call: W8A8's quantize launch, then the product.
// x (M, K) fp32, or bf16 when x_bf16; q (N, K) int8, s (N,) fp32, out
// (M, N) in x's dtype, all contiguous and 16-byte aligned. a8 != 0 runs
// the W8A8 body and needs xq (M, K rounded up to 64) int8 and sx (M,)
// fp32 of scratch; otherwise both may be null. (ct, ks, mt): the plan of
// ops/qmm.py:qmm_plan, column tiles a block, warps along K a column tile,
// row tiles a warp. W8A8's product is a programmatic dependent of its
// quantize launch.
int qmm_launch(const void* x, int x_bf16, const int8_t* q, const float* s,
               void* out, int8_t* xq, float* sx, int M, int K, int N,
               int a8, int ct, int ks, int mt, void* stream_handle) {
  if (M <= 0 || K <= 0 || N <= 0 || (a8 && (!xq || !sx)) || ct < 1 ||
      ks < 1 || ct * ks > (mt >= 4 ? kMaxWarps / 2 : kMaxWarps))
    return cudaErrorInvalidValue;
  const Kernel kernel = pick(a8 != 0, K % 16 == 0, x_bf16 != 0, mt);
  const int smem = qmm_smem_bytes(K, a8, x_bf16, ct, ks, mt);
  if (!kernel || smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  cudaError_t err;
  // past what a launch may take without asking (48 KB with the kernel's
  // static shared memory beside it)
  if (smem > 44 * 1024 &&
      (err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return err;
  if (a8) {
    const dim3 qgrid((padded_k(K) + kQuantSlice - 1) / kQuantSlice, M);
    if (x_bf16)
      quantize_rows_kernel<<<qgrid, kQuantThreads, 0, stream>>>(
          static_cast<const __nv_bfloat16*>(x), K, padded_k(K), xq, sx);
    else
      quantize_rows_kernel<<<qgrid, kQuantThreads, 0, stream>>>(
          static_cast<const float*>(x), K, padded_k(K), xq, sx);
    if ((err = cudaGetLastError())) return err;
  }
  const int tiles = (N + kTileN - 1) / kTileN;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles + ct - 1) / ct,
                     (M + mt * kTileM - 1) / (mt * kTileM));
  cfg.blockDim = dim3(32 * ct * ks);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a8 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, x, (const int8_t*)xq,
                            (const float*)sx, q, s, out, M, K, N, ct, ks);
}

}  // extern "C"
