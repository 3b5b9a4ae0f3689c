// P1 and P2: the int4 dequant-matmul probe kernels.
//
// Replaces the Pallas bodies of scripts/exp_w4_kernel_bisect.py (`build`,
// pallas_call at :26: k1 :54, k2 :62, k3 :72, k4 :85, k5 :96) and of
// scripts/exp_int4_variants.py (`pallas_w4`, pallas_call at :166:
// k_w4_concat :132, k_w4_2dot :145). All take x (B, IN) bf16, q (IN/2,
// OUT) int8 packing two rows a byte, the low nibble row r, the high nibble
// row r + IN/2, both sign-extended ((q << 28) >> 28 and q >> 4 on int32),
// and write out (B, OUT) bf16 from fp32 sums. Per mode:
//
//   0 plain      out = x[:, :n_rows] @ w[:n_rows], no scale (k1: n_rows =
//                IN/2, the low nibbles only; k2: n_rows = IN)
//   1 group      w_r = bf16(w_r * bf16(s[r / G])), G = IN / NG (k3 and
//                k_w4_concat G = 128; k_w4_2dot G = 64, whose two dots on
//                the x halves are one sum here)
//   2 modulo     w_r = bf16(w_r * bf16(s[r % NG])): k4's
//                pltpu.repeat(s, G, 0) tiles the whole (NG, TN) block G
//                times, so row r meets s[r % NG], not s[r / G]
//   3 group acc  64-row partial sums in fp32, each times s[r / G] in fp32
//                before it joins the sum (k5)
//
// s is (NG, OUT) fp32. The bf16 roundings are where JAX makes them (TPU
// interpret mode on the CPU; tests/test_torch_port_probes_w4.py).
//
// What bounds it on an H100 at the probes' shape (B = 64, IN = 1664, OUT =
// 4096): operations. 0.87 GFLOP against 3.4 MB of int4 weights is ~250
// operations a byte, at the tensor cores' line; at the published bf16
// peak the product takes ~0.9 us, reading the weights ~1 us.
//
// What the design does about it (a simple first version): one thread owns
// 4 adjacent output columns (one 32-bit word of q per packed row, warps on
// neighbouring words) and 4 rows of x, staged in shared memory as fp32 in
// [row][batch] order so one 16-byte load gives the 4 rows of one k; the
// nibbles are decoded and scaled in registers and summed with fp32 FMAs;
// each thread loads 16 packed rows ahead of their use, so the loads'
// latency overlaps, and the rows are split over 4 blocks (split K: 64
// threads a block would leave an SM ~4 warps, too few to hide the loads)
// whose fp32 partial sums a second kernel adds in a fixed order.
// SIMT, no tensor cores: mma.sync / wgmma on dequantized tiles are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kCols = 4;          // output columns per thread
constexpr int kRows = 4;          // rows of x per block
constexpr int kChunk = 64;        // weight rows per partial sum
constexpr int kBatch = 16;        // packed rows loaded ahead of their use
constexpr int kSplit = 4;         // blocks along the rows (split K)

enum Mode { kPlain = 0, kGroup = 1, kModulo = 2, kGroupAcc = 3 };

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Nibble `hi` of byte j of a packed word, sign-extended.
__device__ __forceinline__ int nibble(uint32_t word, int j, int hi) {
  const int v = (int)(int8_t)(word >> (8 * j));
  return hi ? (v >> 4) : ((int)((uint32_t)v << 28) >> 28);
}

// Split z of the chunks: [begin, end) in rows.
__host__ __device__ inline void split_rows(int n_rows, int z, int* begin,
                                           int* end) {
  const int chunks = n_rows / kChunk;
  *begin = chunks * z / kSplit * kChunk;
  *end = chunks * (z + 1) / kSplit * kChunk;
}

// fp32 partial sums of split blockIdx.z into part (kSplit, B, OUT).
__global__ void __launch_bounds__(kThreads) w4_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ s, float* __restrict__ part, int B, int IN,
    int OUT, int n_rows, int NG, int G, int mode) {
  extern __shared__ __align__(16) float xs[];   // [rows of the split][kRows]
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, B - b0);
  int r_begin, r_end;
  split_rows(n_rows, blockIdx.z, &r_begin, &r_end);
  for (int i = threadIdx.x; i < (r_end - r_begin) * kRows; i += kThreads) {
    const int r = i / kRows, b = i - r * kRows;
    xs[i] = b < nb ? __bfloat162float(x[(size_t)(b0 + b) * IN + r_begin + r])
                   : 0.f;
  }
  __syncthreads();
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (n0 >= OUT) return;
  const int half = IN / 2;
  float acc[kRows][kCols];
#pragma unroll
  for (int b = 0; b < kRows; ++b)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[b][j] = 0.f;

  for (int c0 = r_begin; c0 < r_end; c0 += kChunk) {
    const int hi = c0 >= half;
    float sb[kCols] = {1.f, 1.f, 1.f, 1.f};  // the chunk's scale (modes 1, 3)
    if (mode == kGroup || mode == kGroupAcc) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          s + (size_t)(c0 / G) * OUT + n0));
      sb[0] = v.x, sb[1] = v.y, sb[2] = v.z, sb[3] = v.w;
      if (mode == kGroup)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sb[j] = bf16r(sb[j]);
    }
    float part[kRows][kCols];
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int j = 0; j < kCols; ++j) part[b][j] = 0.f;
    const int8_t* qrow = q + (size_t)(c0 - hi * half) * OUT + n0;
    for (int r0 = c0; r0 < c0 + kChunk; r0 += kBatch, qrow += kBatch * OUT) {
      uint32_t words[kBatch];        // kBatch loads in flight at once
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        words[u] = __ldg(reinterpret_cast<const uint32_t*>(qrow + (size_t)u * OUT));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int r = r0 + u;
        float sm[kCols] = {1.f, 1.f, 1.f, 1.f};
        if (mode == kModulo) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              s + (size_t)(r % NG) * OUT + n0));
          sm[0] = bf16r(v.x), sm[1] = bf16r(v.y), sm[2] = bf16r(v.z),
          sm[3] = bf16r(v.w);
        }
        float w[kCols];
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float v = (float)nibble(words[u], j, hi);
          if (mode == kGroup) v = bf16r(v * sb[j]);
          else if (mode == kModulo) v = bf16r(v * sm[j]);
          w[j] = v;
        }
        const float4 xv =
            *reinterpret_cast<const float4*>(xs + (r - r_begin) * kRows);
        const float xr[kRows] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int b = 0; b < kRows; ++b)
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            part[b][j] = fmaf(xr[b], w[j], part[b][j]);
      }
    }
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[b][j] = __fadd_rn(acc[b][j], mode == kGroupAcc
                                             ? __fmul_rn(part[b][j], sb[j])
                                             : part[b][j]);
  }
  for (int b = 0; b < nb; ++b)
    *reinterpret_cast<float4*>(
        part + ((size_t)blockIdx.z * B + b0 + b) * OUT + n0) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
}

// out = bf16(sum of the kSplit partial sums, in split order).
__global__ void w4_finish_kernel(const float* __restrict__ part,
                                 __nv_bfloat16* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = part[i];
  for (int z = 1; z < kSplit; ++z) v = __fadd_rn(v, part[(size_t)z * n + i]);
  out[i] = __float2bfloat16_rn(v);
}

}  // namespace

extern "C" {

const char* w4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, IN) bf16, q (IN / 2, OUT) int8, s (NG, OUT) fp32 (unused by mode
// 0), out (B, OUT) bf16, work w4_workspace_floats(B, OUT) fp32; all
// contiguous. n_rows = IN / 2 (k1) or IN.
// Needs IN a multiple of 128 (whole 64-row chunks in each half), OUT a
// multiple of 4, and for modes 1 and 3 IN / NG a multiple of 64.
// Floats of the partial-sum workspace w4_matmul needs.
long long w4_workspace_floats(int B, int OUT) {
  return (long long)kSplit * B * OUT;
}

int w4_matmul(const void* x, const int8_t* q, const float* s, void* out,
              float* work, int B, int IN, int OUT, int n_rows, int NG,
              int mode, void* stream_handle) {
  if (B < 1 || IN % 128 || OUT % 4 || mode < 0 || mode > 3 ||
      (n_rows != IN && n_rows != IN / 2) || (mode != kPlain && NG < 1))
    return cudaErrorInvalidValue;
  const int G = mode == kPlain ? 0 : IN / NG;
  if ((mode == kGroup || mode == kGroupAcc) && (IN % NG || G % kChunk))
    return cudaErrorInvalidValue;
  int r_begin, r_end, rows_max = 0;
  for (int z = 0; z < kSplit; ++z) {
    split_rows(n_rows, z, &r_begin, &r_end);
    rows_max = r_end - r_begin > rows_max ? r_end - r_begin : rows_max;
  }
  const size_t smem = sizeof(float) * (size_t)rows_max * kRows;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 grid((OUT / kCols + kThreads - 1) / kThreads,
                  (B + kRows - 1) / kRows, kSplit);
  w4_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), q, s, work, B, IN, OUT, n_rows,
      NG, G, mode);
  cudaError_t err = cudaGetLastError();
  if (err) return err;
  const int n = B * OUT;
  w4_finish_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      work, static_cast<__nv_bfloat16*>(out), n);
  return cudaGetLastError();
}

}  // extern "C"
