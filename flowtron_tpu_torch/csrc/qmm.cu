// K4: the quantized matmul of the serving modes, fp32 activations.
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
// x is (M, K) fp32, q is (N, K) int8 in torch's (out, in) layout (the
// Pallas kernel takes (K, N)), s is (N,) fp32, out is (M, N) fp32. The
// Pallas body divides by 127.0, which XLA compiles to a multiply by the
// fp32 reciprocal; this kernel does the same, so its W8A8 output is the
// JAX kernel's to the bit (ops/qmm.py says more).
//
// What bounds it on an H100: bytes. On the decoder's per-frame path M is
// the batch (<= 8) and each call streams one int8 weight matrix once:
// 6.8 MB at (K, N) = (1664, 4096) against 2 * 8 * 1664 * 4096 = 0.11 G
// operations, about 16 operations a byte, far below the ~590 int8
// operations a byte at which the tensor cores would be the limit. One
// flow-frame's nine calls read 26.7 MB: about 8 us at 3.35 TB/s (the
// published peak, not measured here). The key/value precompute (M = B *
// Tk <= 512, (640, 640)) is small either way.
//
// What the design does about it (a simple first version):
// - one warp owns one output column n for a tile of 8 rows, so each
//   weight byte is read from device memory once per row tile (once in
//   all at M <= 8), in 16-byte loads that neighbouring lanes issue on
//   neighbouring addresses;
// - W8A8: a first kernel quantizes each row of x into a zero-padded int8
//   scratch (one block a row: max-reduce, then rintf(x / sx): a true
//   division and jnp.round's round-half-to-even); the product kernel
//   then runs __dp4a over 4 consecutive k with int32 accumulators and a
//   shuffle reduction, so acc is exact and the epilogue's two rounded
//   multiplies give the plain version's bits;
// - weight-only: the int8 -> fp32 convert happens in registers, fp32
//   FMAs, the scale applied once at the end;
// - no padding of the operands: bounds checks replace the Pallas
//   _pad_to, and a K that is not a multiple of 16 takes a byte path.
// Tensor cores (int8 wgmma), TMA and keeping the weights in L2 across
// frames are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // output columns per block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                  // rows of x per block
constexpr float kInv127 = 1.0f / 127.0f;  // XLA's folded 1/127

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One block per row: sx = max|x| * fp32(1/127) (1 where 0), xq =
// clip(rint(x / sx)) into a row of Kp >= K bytes, zero past K.
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int K, int Kp,
                     int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float part[kWarps];
  const int m = blockIdx.x;
  const float* row = x + (size_t)m * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kThreads)
    amax = fmaxf(amax, fabsf(row[k]));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part[0];
  for (int w = 1; w < kWarps; ++w) amax = fmaxf(amax, part[w]);
  float scale = __fmul_rn(amax, kInv127);
  if (scale == 0.f) scale = 1.f;
  int8_t* out = xq + (size_t)m * Kp;
  for (int k = threadIdx.x; k < Kp; k += kThreads) {
    float v = 0.f;
    if (k < K) {
      v = rintf(__fdiv_rn(row[k], scale));
      v = fminf(fmaxf(v, -127.f), 127.f);
    }
    out[k] = static_cast<int8_t>(v);
  }
  if (threadIdx.x == 0) sx[m] = scale;
}

// Four bytes of q from k on, zero past K, packed for __dp4a.
__device__ __forceinline__ int pack4(const int8_t* p, int k, int K) {
  uint32_t w = 0;
  for (int i = 0; i < 4; ++i)
    if (k + i < K) w |= (uint32_t)(uint8_t)p[k + i] << (8 * i);
  return (int)w;
}

__device__ __forceinline__ int dp4a16(int4 a, int4 b, int acc) {
  acc = __dp4a(a.x, b.x, acc);
  acc = __dp4a(a.y, b.y, acc);
  acc = __dp4a(a.z, b.z, acc);
  return __dp4a(a.w, b.w, acc);
}

// W8A8 product: xq (M, Kp) int8 rows, sx (M,), q (N, K), s (N,).
__global__ void __launch_bounds__(kThreads)
qmm_w8a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ q, const float* __restrict__ s,
                float* __restrict__ out, int M, int K, int Kp, int N) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kRows;
  if (n >= N) return;                     // whole warps only
  const int rows = min(kRows, M - m0);
  const int8_t* qrow = q + (size_t)n * K;
  const int8_t* xrow = xq + (size_t)m0 * Kp;
  int acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0;
  if ((K & 15) == 0) {                    // 16-byte rows: Kp == K
    for (int k = lane * 16; k < K; k += 32 * 16) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(qrow + k));
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows)
          acc[r] = dp4a16(
              __ldg(reinterpret_cast<const int4*>(xrow + (size_t)r * Kp + k)),
              w, acc[r]);
    }
  } else {                                // byte path; xq is zero past K
    for (int k = lane * 4; k < K; k += 32 * 4) {
      const int w = pack4(qrow, k, K);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows)
          acc[r] = __dp4a(
              __ldg(reinterpret_cast<const int*>(xrow + (size_t)r * Kp + k)),
              w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0) {
    const float sn = s[n];
    for (int r = 0; r < rows; ++r)
      out[(size_t)(m0 + r) * N + n] =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[r]), sx[m0 + r]), sn);
  }
}

__device__ __forceinline__ float dot4(float4 a, int w, float acc) {
  acc = fmaf(a.x, (float)(int8_t)(w & 0xff), acc);
  acc = fmaf(a.y, (float)(int8_t)((w >> 8) & 0xff), acc);
  acc = fmaf(a.z, (float)(int8_t)((w >> 16) & 0xff), acc);
  return fmaf(a.w, (float)(int8_t)((w >> 24) & 0xff), acc);
}

// Weight-only product: x (M, K) fp32, q (N, K), s (N,).
__global__ void __launch_bounds__(kThreads)
qmm_w8_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ s, float* __restrict__ out, int M,
              int K, int N) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int m0 = blockIdx.y * kRows;
  if (n >= N) return;
  const int rows = min(kRows, M - m0);
  const int8_t* qrow = q + (size_t)n * K;
  const float* xrow = x + (size_t)m0 * K;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  if ((K & 15) == 0) {
    for (int k = lane * 16; k < K; k += 32 * 16) {
      const int4 w = __ldg(reinterpret_cast<const int4*>(qrow + k));
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          const float4* xr =
              reinterpret_cast<const float4*>(xrow + (size_t)r * K + k);
          float a = acc[r];
          a = dot4(__ldg(xr + 0), w.x, a);
          a = dot4(__ldg(xr + 1), w.y, a);
          a = dot4(__ldg(xr + 2), w.z, a);
          acc[r] = dot4(__ldg(xr + 3), w.w, a);
        }
      }
    }
  } else {
    for (int k = lane; k < K; k += 32) {
      const float w = (float)qrow[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < rows) acc[r] = fmaf(__ldg(xrow + (size_t)r * K + k), w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0) {
    const float sn = s[n];
    for (int r = 0; r < rows; ++r)
      out[(size_t)(m0 + r) * N + n] = __fmul_rn(acc[r], sn);
  }
}

}  // namespace

extern "C" {

const char* qmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of int8 scratch one row of x takes in the W8A8 body (K rounded
// up to 16).
int qmm_padded_k(int K) { return (K + 15) / 16 * 16; }

// x (M, K) fp32, q (N, K) int8, s (N,) fp32, out (M, N) fp32, all
// contiguous and 16-byte aligned. a8 != 0 runs the W8A8 body and needs
// xq (M, qmm_padded_k(K)) int8 and sx (M,) fp32 of scratch; otherwise
// both may be null.
int qmm_f32(const float* x, const int8_t* q, const float* s, float* out,
            int8_t* xq, float* sx, int M, int K, int N, int a8,
            void* stream_handle) {
  if (M <= 0 || K <= 0 || N <= 0 || (a8 && (!xq || !sx)))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 grid((N + kWarps - 1) / kWarps, (M + kRows - 1) / kRows);
  if (a8) {
    const int Kp = qmm_padded_k(K);
    quantize_rows_kernel<<<M, kThreads, 0, stream>>>(x, K, Kp, xq, sx);
    cudaError_t err = cudaGetLastError();
    if (err) return err;
    qmm_w8a8_kernel<<<grid, kThreads, 0, stream>>>(xq, sx, q, s, out, M, K,
                                                   Kp, N);
  } else {
    qmm_w8_kernel<<<grid, kThreads, 0, stream>>>(x, q, s, out, M, K, N);
  }
  return cudaGetLastError();
}

}  // extern "C"
