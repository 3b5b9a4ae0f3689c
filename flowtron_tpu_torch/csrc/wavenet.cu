// K2: one WaveGlow WN layer, fp32.
//
// Replaces flowtron_tpu/ops/wavenet_pallas.py:wn_layer_fused (the Pallas
// kernel _wn_layer_kernel, called at :93):
//
//   acts = [x[t-d], x[t], x[t+d]] @ W_cat + b + cond     (k=3 dilated conv)
//   z    = tanh(acts[:, :C]) * sigmoid(acts[:, C:])
//   rs   = z @ W_rs + b_rs
//   x'   = x + rs[:, :C], zero on pad rows (t >= T);  skip = rs[:, C:]
//   (last layer: W_rs is (C, C) and the layer emits only skip = rs)
//
// Rows are the flattened (B, Tp) time steps of x (B, Tp, C); cond is a
// (B, Tp, 2C) slice with row stride ldc.
//
// What bounds it on an H100: arithmetic. At C = 256 a row costs
// 2 * (768 * 512 + 256 * 512) = 1.05 MFLOP against 3 KB of row traffic,
// so it sits far above the bytes/FLOP line; one flagship layer at B=1,
// N=400 mel frames (12800 rows) is about 13.4 GFLOP. In fp32 without
// tensor cores the ceiling is the 67 TFLOP/s SIMT rate (published peak,
// not measured here).
//
// What the design does about it (a simple first version): a tiled SIMT
// GEMM. A block owns BM = 8 * 1024 / C rows and all 2C columns, so the
// gate epilogue has both halves of a channel in one thread; each thread
// keeps an 8-row x (4 + 4)-column tile of accumulators in registers.
// - The time shift happens inside the kernel: the A tile is gathered from
//   rows t - d, t, t + d of the same stream with zero fill outside
//   [0, T). The Pallas version reads three shifted copies of x from HBM.
// - z never leaves the SM: the gate epilogue writes it to shared memory
//   (over the A tile) and the res/skip product reads it from there.
// - K is walked in chunks of 16 through shared memory; no
//   double-buffering, no tensor cores (wgmma/TMA belong to later work).
// - Pad rows (t >= T) of x' are re-zeroed on the store, so a bias never
//   leaks into valid rows through the next layer's shift.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;            // K chunk
constexpr int kTileFloats = 8192;  // BM * C: the z tile, 32 KB

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void fma4(float (&acc)[8], int o, float a,
                                     float4 b) {
  acc[o + 0] = fmaf(a, b.x, acc[o + 0]);
  acc[o + 1] = fmaf(a, b.y, acc[o + 1]);
  acc[o + 2] = fmaf(a, b.z, acc[o + 2]);
  acc[o + 3] = fmaf(a, b.w, acc[o + 3]);
}

template <bool LAST>
__global__ void __launch_bounds__(kThreads)
wn_layer_kernel(const float* __restrict__ x, int d,
                const float* __restrict__ cond, int ldc,
                const float* __restrict__ w_cat,
                const float* __restrict__ b,
                const float* __restrict__ w_rs,
                const float* __restrict__ b_rs, float* __restrict__ x_out,
                float* __restrict__ skip, int M, int T, int Tp, int C) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int ngroups = C / 4;
  const int BM = kTileFloats / C;
  const int ldA = BM + 4;
  float* As = sm;                  // [kBK][ldA] during the first product
  float* Zs = sm;                  // [BM][C] after it
  float* Bs = sm + kTileFloats;    // [kBK][2C]
  const int tid = threadIdx.x;
  const int rg = tid / ngroups, j = tid - rg * ngroups;
  const int row0 = blockIdx.x * BM;
  const int N2 = 2 * C;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;

  // acts = x_shifted (BM x 3C) @ W_cat (3C x 2C)
  for (int k0 = 0; k0 < 3 * C; k0 += kBK) {
    const int tap = k0 / C;
    const int shift = (tap - 1) * d;
    const int ch0 = k0 - tap * C;
    for (int i = tid; i < kBK * BM; i += kThreads) {
      const int r = i / kBK, kk = i - r * kBK;
      const int g = row0 + r;
      float v = 0.f;
      if (g < M) {
        const int s = g / Tp;
        const int ts = g - s * Tp + shift;
        if (ts >= 0 && ts < T) v = x[((size_t)s * Tp + ts) * C + ch0 + kk];
      }
      As[kk * ldA + r] = v;
    }
    const float4* wsrc = reinterpret_cast<const float4*>(w_cat + (size_t)k0 * N2);
    for (int i = tid; i < kBK * N2 / 4; i += kThreads)
      reinterpret_cast<float4*>(Bs)[i] = __ldg(wsrc + i);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * ldA + rg * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * ldA + rg * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * N2 + 4 * j);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * N2 + C + 4 * j);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        fma4(acc[i], 0, a[i], b0);
        fma4(acc[i], 4, a[i], b1);
      }
    }
    __syncthreads();
  }

  // gate epilogue: z = tanh(acts[:C] + b + cond) * sigmoid(acts[C:] + ...)
  {
    const float4 bt = *reinterpret_cast<const float4*>(b + 4 * j);
    const float4 bs = *reinterpret_cast<const float4*>(b + C + 4 * j);
    const float bt_[4] = {bt.x, bt.y, bt.z, bt.w};
    const float bs_[4] = {bs.x, bs.y, bs.z, bs.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = rg * 8 + i;
      const int g = row0 + r;
      float ct[4] = {0.f, 0.f, 0.f, 0.f}, cs[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < M) {
        const float4 c0 = *reinterpret_cast<const float4*>(
            cond + (size_t)g * ldc + 4 * j);
        const float4 c1 = *reinterpret_cast<const float4*>(
            cond + (size_t)g * ldc + C + 4 * j);
        ct[0] = c0.x; ct[1] = c0.y; ct[2] = c0.z; ct[3] = c0.w;
        cs[0] = c1.x; cs[1] = c1.y; cs[2] = c1.z; cs[3] = c1.w;
      }
      float4 zv;
      float* zp = reinterpret_cast<float*>(&zv);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        zp[q] = tanhf(acc[i][q] + bt_[q] + ct[q])
                * sigmoid(acc[i][4 + q] + bs_[q] + cs[q]);
      *reinterpret_cast<float4*>(Zs + r * C + 4 * j) = zv;
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[i][q] = 0.f;
    }
  }
  __syncthreads();

  // rs = z (BM x C) @ W_rs (C x Nrs)
  const int Nrs = LAST ? C : N2;
  for (int k0 = 0; k0 < C; k0 += kBK) {
    const float4* wsrc = reinterpret_cast<const float4*>(w_rs + (size_t)k0 * Nrs);
    for (int i = tid; i < kBK * Nrs / 4; i += kThreads)
      reinterpret_cast<float4*>(Bs)[i] = __ldg(wsrc + i);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * Nrs + 4 * j);
      float4 b1 = b0;
      if (!LAST)
        b1 = *reinterpret_cast<const float4*>(Bs + kk * Nrs + C + 4 * j);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = Zs[(rg * 8 + i) * C + k0 + kk];
        fma4(acc[i], 0, a, b0);
        if (!LAST) fma4(acc[i], 4, a, b1);
      }
    }
    __syncthreads();
  }

  // residual / skip epilogue
  const float4 br0 = *reinterpret_cast<const float4*>(b_rs + 4 * j);
  float4 br1 = br0;
  if (!LAST) br1 = *reinterpret_cast<const float4*>(b_rs + C + 4 * j);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int g = row0 + rg * 8 + i;
    if (g >= M) continue;
    const size_t o = (size_t)g * C + 4 * j;
    const float4 rs0 = make_float4(acc[i][0] + br0.x, acc[i][1] + br0.y,
                                   acc[i][2] + br0.z, acc[i][3] + br0.w);
    if (LAST) {
      *reinterpret_cast<float4*>(skip + o) = rs0;
    } else {
      const bool valid = (g % Tp) < T;
      const float4 xv = *reinterpret_cast<const float4*>(x + o);
      *reinterpret_cast<float4*>(x_out + o) =
          valid ? make_float4(xv.x + rs0.x, xv.y + rs0.y, xv.z + rs0.z,
                              xv.w + rs0.w)
                : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(skip + o) =
          make_float4(acc[i][4] + br1.x, acc[i][5] + br1.y,
                      acc[i][6] + br1.z, acc[i][7] + br1.w);
    }
  }
}

}  // namespace

extern "C" {

const char* wavenet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, Tp, C); cond rows of 2C floats with row stride ldc; w_cat
// (3C, 2C) with taps [w[:,:,0].T; w[:,:,1].T; w[:,:,2].T]; b (2C);
// w_rs (C, 2C), or (C, C) when last; b_rs likewise. Outputs x_out
// (B, Tp, C) (unused when last) and skip (B, Tp, C). All fp32, 16-byte
// aligned; C a multiple of 64 that divides 1024.
int wn_layer_f32(const float* x, int d, const float* cond, int ldc,
                 const float* w_cat, const float* b, const float* w_rs,
                 const float* b_rs, float* x_out, float* skip, int B, int Tp,
                 int T, int C, int last, void* stream_handle) {
  if (C % 64 != 0 || 1024 % C != 0 || ldc % 4 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int M = B * Tp;
  const int BM = kTileFloats / C;
  const size_t smem = sizeof(float) * (kTileFloats + (size_t)kBK * 2 * C);
  const int grid = (M + BM - 1) / BM;
  cudaError_t err;
  if (last) {
    if ((err = cudaFuncSetAttribute(
             wn_layer_kernel<true>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    wn_layer_kernel<true><<<grid, kThreads, smem, stream>>>(
        x, d, cond, ldc, w_cat, b, w_rs, b_rs, x_out, skip, M, T, Tp, C);
  } else {
    if ((err = cudaFuncSetAttribute(
             wn_layer_kernel<false>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
      return err;
    wn_layer_kernel<false><<<grid, kThreads, smem, stream>>>(
        x, d, cond, ldc, w_cat, b, w_rs, b_rs, x_out, skip, M, T, Tp, C);
  }
  return cudaGetLastError();
}

}  // extern "C"
