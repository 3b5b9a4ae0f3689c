// K3: additive-attention scores and their gradients, fp32 or bf16 in,
// fp32 accumulation.
//
// Replaces flowtron_tpu/ops/attention_pallas.py: the Pallas kernel
// _scores_kernel (attention_scores_pallas, called at :55) and the custom
// VJP's backward _scores_bwd (:92):
//
//   s[b, q, t] = sum_d v[d] * tanh(Q[b, q, d] + K[b, t, d]) / temp
//   dQ[b, q, d] = v[d] / temp * sum_t ds[b, q, t] * (1 - th^2)
//   dK[b, t, d] = v[d] / temp * sum_q ds[b, q, t] * (1 - th^2)
//   dv[d]       = 1 / temp * sum_{b, q, t} ds[b, q, t] * th
//   with th = tanh(Q[b, q, d] + K[b, t, d])
//
// What bounds it on an H100: the tanh. Each (b, q, t, d) costs one
// accurate tanhf (tens of instructions) and one FMA, against a few bytes
// of Q/K traffic per (b, q, d) row: far above the bytes/FLOP line, so the
// SIMT pipes set the time. At the flagship training shape (B = 6,
// Tq ~ 400 mel frames, Tk ~ 64 text ids, D = 640) that is ~98 M tanh per
// forward and twice that per backward, which recomputes th instead of
// storing the (B, Tq, Tk, D) tensor.
//
// What the design does about it (a simple first version):
// - Forward: one block per (b, 16 query rows, 32 key rows). The depth is
//   walked in chunks of 64 staged in shared memory (Q tile, K tile with a
//   padded row stride so a warp reads 32 keys without bank conflicts, and
//   v), so the (16, 32, D) intermediate never leaves the SM. Bounds checks
//   replace the Pallas version's padded copies (_pad_to).
// - Backward: one block per (b, 16 query rows, 64 depth columns) for dQ,
//   looping over all keys; one per (b, 16 key rows, 64 depth columns) for
//   dK, looping over all queries; v[d] / temp factors out of both sums.
//   dv is reduced without atomics: the dQ blocks also sum ds * th over
//   their keys and (in a fixed order) over their 16 queries into one
//   partial row per (b, query tile), and a third kernel sums those rows
//   in a fixed order. Two runs give bitwise-equal gradients.
// - Loads convert bf16 to fp32; every sum is fp32; outputs are rounded to
//   the input dtype once, at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFQ = 16;     // forward: query rows per block
constexpr int kFT = 32;     // forward: key rows per block
constexpr int kDC = 64;     // depth chunk
constexpr int kBR = 16;     // backward: owned rows per block (q for dQ, t for dK)
constexpr int kBL = 32;     // backward: rows per step of the loop over the other side
constexpr int kDJ = kDC / 16;   // depth columns per backward thread

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Tq,
                  int Tk, int D, float temp) {
  __shared__ float qs[kFQ][kDC];
  __shared__ float ks[kFT][kDC + 1];
  __shared__ float vs[kDC];
  const int b = blockIdx.z;
  const int q0 = blockIdx.y * kFQ, t0 = blockIdx.x * kFT;
  const int tid = threadIdx.x;
  const int ty = tid / kFT, tx = tid % kFT;    // ty in [0, 8): one per warp
  const T* qb = q + (size_t)b * Tq * D;
  const T* kb = k + (size_t)b * Tk * D;
  float acc0 = 0.f, acc1 = 0.f;
  for (int d0 = 0; d0 < D; d0 += kDC) {
    for (int i = tid; i < kFQ * kDC; i += kThreads) {
      const int r = i / kDC, c = i % kDC;
      const int qi = q0 + r, d = d0 + c;
      qs[r][c] = (qi < Tq && d < D) ? ld(qb, (size_t)qi * D + d) : 0.f;
    }
    for (int i = tid; i < kFT * kDC; i += kThreads) {
      const int r = i / kDC, c = i % kDC;
      const int ti = t0 + r, d = d0 + c;
      ks[r][c] = (ti < Tk && d < D) ? ld(kb, (size_t)ti * D + d) : 0.f;
    }
    if (tid < kDC) vs[tid] = (d0 + tid < D) ? ld(v, d0 + tid) : 0.f;
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kDC; ++c) {
      const float kv = ks[tx][c], vv = vs[c];
      acc0 = fmaf(vv, tanhf(qs[ty][c] + kv), acc0);
      acc1 = fmaf(vv, tanhf(qs[ty + 8][c] + kv), acc1);
    }
    __syncthreads();
  }
  const int t = t0 + tx;
  if (t < Tk) {
    const size_t row = (size_t)b * Tq + q0 + ty;
    if (q0 + ty < Tq) st(out, row * Tk + t, acc0 / temp);
    if (q0 + ty + 8 < Tq) st(out, (row + 8) * Tk + t, acc1 / temp);
  }
}

// OWN_Q: the block owns query rows and loops over keys (dQ and the dv
// partials); otherwise it owns key rows and loops over queries (dK).
template <typename T, bool OWN_Q>
__global__ void __launch_bounds__(kThreads)
scores_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ ds,
                  T* __restrict__ dx, float* __restrict__ dv_part, int Tq,
                  int Tk, int D, float temp) {
  __shared__ float ys[kBL][kDC];          // the other side's rows
  __shared__ float gs[kBR][kBL + 1];      // ds, owned row x loop row
  __shared__ float red[kBR][kDC];         // dv partials, OWN_Q only
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * kBR, d0 = blockIdx.x * kDC;
  const int tid = threadIdx.x;
  const int r = tid / 16, cj = tid % 16;  // owned row, first depth column
  const int n_own = OWN_Q ? Tq : Tk, n_loop = OWN_Q ? Tk : Tq;
  const T* own = (OWN_Q ? q + (size_t)b * Tq * D : k + (size_t)b * Tk * D);
  const T* oth = (OWN_Q ? k + (size_t)b * Tk * D : q + (size_t)b * Tq * D);
  const T* dsb = ds + (size_t)b * Tq * Tk;

  float xr[kDJ], acc[kDJ], accv[kDJ];
#pragma unroll
  for (int j = 0; j < kDJ; ++j) {
    const int d = d0 + cj + 16 * j;
    xr[j] = (r0 + r < n_own && d < D) ? ld(own, (size_t)(r0 + r) * D + d)
                                      : 0.f;
    acc[j] = 0.f;
    accv[j] = 0.f;
  }
  for (int l0 = 0; l0 < n_loop; l0 += kBL) {
    for (int i = tid; i < kBL * kDC; i += kThreads) {
      const int lr = i / kDC, c = i % kDC;
      const int li = l0 + lr, d = d0 + c;
      ys[lr][c] = (li < n_loop && d < D) ? ld(oth, (size_t)li * D + d) : 0.f;
    }
    for (int i = tid; i < kBR * kBL; i += kThreads) {
      int orow, lrow, qi, ti;
      if (OWN_Q) {           // ds rows are queries: read along keys
        orow = i / kBL; lrow = i % kBL;
        qi = r0 + orow; ti = l0 + lrow;
      } else {               // owned keys are ds columns
        lrow = i / kBR; orow = i % kBR;
        qi = l0 + lrow; ti = r0 + orow;
      }
      gs[orow][lrow] = (qi < Tq && ti < Tk) ? ld(dsb, (size_t)qi * Tk + ti)
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int lr = 0; lr < kBL; ++lr) {
      const float g = gs[r][lr];
#pragma unroll
      for (int j = 0; j < kDJ; ++j) {
        const float th = tanhf(xr[j] + ys[lr][cj + 16 * j]);
        acc[j] = fmaf(g, 1.f - th * th, acc[j]);
        if (OWN_Q) accv[j] = fmaf(g, th, accv[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kDJ; ++j) {
    const int d = d0 + cj + 16 * j;
    if (r0 + r < n_own && d < D)
      st(dx, ((size_t)b * n_own + r0 + r) * D + d, acc[j] * ld(v, d) / temp);
    if (OWN_Q) red[r][cj + 16 * j] = accv[j];
  }
  if (OWN_Q) {
    __syncthreads();
    if (tid < kDC && d0 + tid < D) {
      float s = 0.f;
      for (int i = 0; i < kBR; ++i) s += red[i][tid];
      const int n_tiles = (Tq + kBR - 1) / kBR;
      dv_part[((size_t)b * n_tiles + blockIdx.y) * D + d0 + tid] = s;
    }
  }
}

template <typename T>
__global__ void dv_reduce_kernel(const float* __restrict__ dv_part,
                                 T* __restrict__ dv, int n_rows, int D,
                                 float temp) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int i = 0; i < n_rows; ++i) s += dv_part[(size_t)i * D + d];
  st(dv, d, s / temp);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, int B, int Tq, int Tk, int D, float temp,
                       cudaStream_t stream) {
  const dim3 grid((Tk + kFT - 1) / kFT, (Tq + kFQ - 1) / kFQ, B);
  scores_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, D, temp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* ds, void* dq, void* dk, void* dv,
                       float* work, int B, int Tq, int Tk, int D, float temp,
                       cudaStream_t stream) {
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* ds_ = static_cast<const T*>(ds);
  const int n_dc = (D + kDC - 1) / kDC;
  const int n_qt = (Tq + kBR - 1) / kBR;
  cudaError_t err;
  scores_bwd_kernel<T, true><<<dim3(n_dc, n_qt, B), kThreads, 0, stream>>>(
      q_, k_, v_, ds_, static_cast<T*>(dq), work, Tq, Tk, D, temp);
  if ((err = cudaGetLastError())) return err;
  scores_bwd_kernel<T, false>
      <<<dim3(n_dc, (Tk + kBR - 1) / kBR, B), kThreads, 0, stream>>>(
          q_, k_, v_, ds_, static_cast<T*>(dk), nullptr, Tq, Tk, D, temp);
  if ((err = cudaGetLastError())) return err;
  dv_reduce_kernel<T><<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      work, static_cast<T*>(dv), B * n_qt, D, temp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of fp32 scratch attention_scores_bwd needs for its dv partials.
long long attention_bwd_workspace_floats(int B, int Tq, int D) {
  return (long long)B * ((Tq + kBR - 1) / kBR) * D;
}

// q (B, Tq, D), k (B, Tk, D), v (D), out (B, Tq, Tk); contiguous, all of
// one dtype: fp32 (bf16 = 0) or bf16 (bf16 = 1).
int attention_scores_fwd(const void* q, const void* k, const void* v,
                         void* out, int B, int Tq, int Tk, int D, float temp,
                         int bf16, void* stream_handle) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return bf16 ? launch_fwd<__nv_bfloat16>(q, k, v, out, B, Tq, Tk, D, temp,
                                          stream)
              : launch_fwd<float>(q, k, v, out, B, Tq, Tk, D, temp, stream);
}

// As attention_scores_fwd, plus ds (B, Tq, Tk) in, dq / dk / dv out in
// the same dtype, and work: attention_bwd_workspace_floats(B, Tq, D)
// floats of scratch.
int attention_scores_bwd(const void* q, const void* k, const void* v,
                         const void* ds, void* dq, void* dk, void* dv,
                         float* work, int B, int Tq, int Tk, int D,
                         float temp, int bf16, void* stream_handle) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  return bf16 ? launch_bwd<__nv_bfloat16>(q, k, v, ds, dq, dk, dv, work, B,
                                          Tq, Tk, D, temp, stream)
              : launch_bwd<float>(q, k, v, ds, dq, dk, dv, work, B, Tq, Tk,
                                  D, temp, stream);
}

}  // extern "C"
