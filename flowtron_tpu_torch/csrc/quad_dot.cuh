// Device helpers shared by csrc/resident.cu and csrc/fused_cost.cu: warp
// reductions, bf16 unpacking, and the bf16 dot of one warp over a quad of
// weight rows (one unit's four gate rows in the gate-interleaved layout
// of ops/_layout.py, or four consecutive output columns).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Eight bf16 of a 16-byte vector as floats.
__device__ __forceinline__ void bf16x8(const uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// One warp: acc[c][b] = dot(W[c, :K], xs[b, :K]) for the 4 rows c of a
// quad and the nb (<= NB) staged rows b; bf16 rows, K a multiple of 8,
// 16-byte aligned; lanes read neighbouring 16-byte vectors, and a
// shuffle reduction gives every lane every sum. kReadOnly reads W through
// the read-only data cache (W in global memory, unchanged while the
// kernel runs); without it W may also lie in shared memory.
template <bool kReadOnly, int NB>
__device__ __forceinline__ void quad_dot_bf16(const __nv_bfloat16* W, int K,
                                              const __nv_bfloat16* xs, int nb,
                                              float (&acc)[4][NB]) {
  const int lane = threadIdx.x & 31;
  const int K8 = K >> 3;
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[c][b] = 0.f;
  for (int i = lane; i < K8; i += 32) {
    float w[4][8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4* row = reinterpret_cast<const uint4*>(W + (size_t)c * K) + i;
      bf16x8(kReadOnly ? __ldg(row) : *row, w[c]);
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        float x[8];
        bf16x8(reinterpret_cast<const uint4*>(xs + (size_t)b * K)[i], x);
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[c][b] = fmaf(w[c][j], x[j], acc[c][b]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) acc[c][b] = warp_sum(acc[c][b]);
}

}  // namespace
