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
// What bounds it on an H100: one tanh per (b, q, t, d), against a few
// bytes of Q/K traffic per (b, q, d) row, so the SM's pipes set the time,
// not HBM. An accurate tanhf is tens of FMA-pipe instructions with two
// special-function (MUFU) ops. Written as below, a tanh costs one
// reciprocal, which runs either as one MUFU op (16 a clock an SM) or as
// six FFMAs on the FMA pipe (128 lanes a clock); the least time shares
// the reciprocals out so that both pipes finish together, about 3 in 7
// on the FMA pipe forward and 1 in 7 backward (chip_smoke.py:k3_bound).
// The design spends one reciprocal per element:
//
//   with E_x = exp(2 x):  tanh(a + b) = 1 - 2 r,  r = 1 / (1 + E_a * E_b)
//
// E is computed once per staged Q or K element (an accurate expf); per
// element there is one FFMA (1 + E_a * E_b), one reciprocal and the sums.
// The reciprocal is rcp.approx (one MUFU op, 1 ulp), except for one
// element in four of the forward, whose reciprocal is three Newton steps
// on the FMA pipe, so that both pipes stay busy (on the card one in four
// was faster than none, one in two slower).
// - Forward: s = (sum_d v - 2 sum_d v * r) / temp. One block per (b, 16
//   query rows, 64 key rows): 512 consumer threads, each 2 x 2 outputs in
//   one of two depth groups (alternate 4-column quads, read as float4s),
//   and 256 producer threads that load and stage the next 32-deep chunk
//   (E, and the raw values for a guarded chunk) while the consumers
//   compute this one; one barrier a chunk, double-buffered. The depth
//   groups' sums meet in shared memory in group order. (A cp.async ring
//   would land raw values that still need the exp and the guard, and D or
//   a bf16 row need not be 16-byte aligned, so producers stage through
//   registers.) Staging adds (16 + 64) / (16 * 64) = 8% to the MUFU work.
// - Backward: one fused pass; each element's r feeds all three sums:
//   1 - th^2 = 4 r (1 - r) and sum g * th = sum g - 2 sum g * r, where
//   sum g (the ds) does not depend on d. One block per (b, 32 depth
//   columns: one a lane), looping over key tiles of 8 * KPT keys (one
//   tile for Tk <= 256) and, inside, over chunks of 32 query rows staged
//   as E and ds. Warp w of a query group owns keys w * KPT .. + KPT - 1
//   of the tile: their E stays in registers and dK accumulates in
//   registers across the whole query loop. With KPT = 8 two query groups
//   (16 warps) take alternate rows, for latency hiding; their dK meet in
//   group order. dQ of a query row is the sum of the 8 warps' partials,
//   taken in shared memory in warp order (over key tiles, in an fp32
//   scratch row that only this block touches). dv leaves each block as
//   one partial row per (b, slice); the last block of a slice to finish
//   (an integer ticket) sums the B rows in the order b = 0 .. B - 1. No
//   float atomics: every sum has one owner and a fixed order, so two runs
//   give bitwise-equal gradients.
// - Guard: the fast form is exact to ~2e-7 only while E_a * E_b stays a
//   finite normal float. A chunk takes it when every Q and K value the
//   block staged for it has |x| <= 20 (kFastMax); otherwise (a larger
//   value, an inf or a NaN) that chunk computes th with accurate tanhf on
//   the raw values. The flag is block-uniform, set while staging.
// - Loads convert bf16 to fp32; every sum is fp32; outputs are rounded to
//   the input dtype once, at the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFQ = 16;     // forward: query rows per block
constexpr int kFT = 64;     // forward: key rows per block
constexpr int kDC = 32;     // forward: depth columns per staged chunk
constexpr int kRS = kDC + 4;  // forward: row stride of a staged chunk
constexpr int kWarps = 8;   // backward: warps per query group, KPT keys each
constexpr int kBQ = 32;     // backward: query rows per staged chunk
constexpr int kBD = 32;     // backward: depth columns per block (one a lane)
// |x| <= 20 keeps E = exp(2x) in [e^-40, e^40], so E_a * E_b lies in
// [e^-80, e^80] (1.8e-35 .. 5.5e34): never an overflow or a denormal, and
// 1 / (1 + E_a * E_b) is a normal float.
constexpr float kFastMax = 20.f;
// The forward's block: consumers of kFwdTQ query x kFwdTK key rows each in
// kFwdFG depth groups, and kFwdP producer threads; every kFmaEvery-th
// element of a consumer takes its reciprocal on the FMA pipe
constexpr int kFwdTQ = 2, kFwdTK = 2, kFwdFG = 2, kFwdP = 256;
constexpr int kFmaEvery = 4;
constexpr int kFwdThreads = kFwdFG * (kFQ / kFwdTQ) * (kFT / kFwdTK) + kFwdP;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// One MUFU op; max error 1 ulp. x >= 1 here, so flushing denormals is moot.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 1 / x on the FMA pipe, for 1 <= x <= e^80: an integer seed within 5.1%
// of it, then three Newton steps (0.051^8 = 5e-11, then fp32 rounding).
__device__ __forceinline__ float rcp_newton(float x) {
  float r = __int_as_float(0x7ef311c3 - __float_as_int(x));
#pragma unroll
  for (int n = 0; n < 3; ++n) r = fmaf(r, fmaf(-x, r, 1.f), r);
  return r;
}

// True for |x| > kFastMax, an inf or a NaN.
__device__ __forceinline__ bool too_big(float x) {
  return !(fabsf(x) <= kFastMax);
}

// r = (1 - tanh(x)) / 2 the accurate way, for a guarded chunk.
__device__ __forceinline__ float r_of_tanh(float x) {
  return 0.5f - 0.5f * tanhf(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 1)
scores_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Tq,
                  int Tk, int D, float temp) {
  constexpr int TQ = kFwdTQ, TK = kFwdTK, FG = kFwdFG, P = kFwdP;
  constexpr int kQG = kFQ / TQ, kKG = kFT / TK;   // thread rows, columns
  constexpr int kGT = kQG * kKG;                   // threads per group
  constexpr int kN = FG * kGT;                     // consumer threads
  constexpr int kQL = kFQ * kDC / P;               // staged values a producer
  constexpr int kKL = kFT * kDC / P;
  static_assert(kQL * P == kFQ * kDC && kDC / 4 % FG == 0 && P % 32 == 0,
                "tiling");
  static_assert(FG * kFQ * kFT <= 2 * kFT * kRS, "reduction fits in ek");
  // [buffer][row][depth column], rows kRS floats apart: a staging warp
  // writes one row's 32 columns; a computing thread reads 4 columns of a
  // row as one float4, and the 8 key rows of a quarter warp fall in
  // distinct 16-byte bank groups.
  __shared__ __align__(16) float eq[2][kFQ][kRS];   // E of the staged Q
  __shared__ __align__(16) float ek[2][kFT][kRS];   // E of the staged K
  __shared__ __align__(16) float xq[2][kFQ][kRS];   // raw, for guarded chunks
  __shared__ __align__(16) float xk[2][kFT][kRS];
  __shared__ __align__(16) float vs[2][kDC];
  const int b = blockIdx.z;
  const int q0 = blockIdx.y * kFQ, t0 = blockIdx.x * kFT;
  const int tid = threadIdx.x;
  const bool producer = tid >= kN;
  const int pt = tid - kN;                         // producer index
  // a consumer: query rows TQ qg + i and key rows kg + kKG j, in the depth
  // quads grp, grp + FG, ... of each chunk
  const int grp = tid / kGT, qg = tid % kGT / kKG, kg = tid % kKG;
  const int nq = min(kFQ, Tq - q0), nk = min(kFT, Tk - t0);
  const T* qb = q + ((size_t)b * Tq + q0) * D;
  const T* kb = k + ((size_t)b * Tk + t0) * D;

  float rq[kQL], rk[kKL], rv = 0.f;
  auto load = [&](int d0) {
#pragma unroll
    for (int m = 0; m < kQL; ++m) {
      const int i = pt + P * m, r = i / kDC, d = d0 + i % kDC;
      rq[m] = (r < nq && d < D) ? ld(qb, (size_t)r * D + d) : 0.f;
    }
#pragma unroll
    for (int m = 0; m < kKL; ++m) {
      const int i = pt + P * m, r = i / kDC, d = d0 + i % kDC;
      rk[m] = (r < nk && d < D) ? ld(kb, (size_t)r * D + d) : 0.f;
    }
    if (pt < kDC) rv = (d0 + pt < D) ? ld(v, d0 + pt) : 0.f;
  };
  // writes the loaded chunk into buffer s; true if a value needs the guard
  auto stage = [&](int s) {
    bool big = false;
#pragma unroll
    for (int m = 0; m < kQL; ++m) {
      const int i = pt + P * m, r = i / kDC, c = i % kDC;
      xq[s][r][c] = rq[m];
      eq[s][r][c] = expf(2.f * rq[m]);
      big |= too_big(rq[m]);
    }
#pragma unroll
    for (int m = 0; m < kKL; ++m) {
      const int i = pt + P * m, r = i / kDC, c = i % kDC;
      xk[s][r][c] = rk[m];
      ek[s][r][c] = expf(2.f * rk[m]);
      big |= too_big(rk[m]);
    }
    if (pt < kDC) vs[s][pt] = rv;
    return big;
  };

  // acc[i][j]: sum of v * r over this consumer's depth columns
  float acc[TQ][TK] = {}, vsum = 0.f;
  const int n_chunks = (D + kDC - 1) / kDC;
  bool big = false;
  if (producer) {
    load(0);
    big = stage(0);
    if (n_chunks > 1) load(kDC);
  }
  bool guarded = __syncthreads_or(big);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s = ch & 1;
    big = false;
    if (producer) {
      // chunk ch + 1 (loaded a chunk ago) into buffer s ^ 1, last read
      // before the previous barrier; then chunk ch + 2's loads
      if (ch + 1 < n_chunks) {
        big = stage(s ^ 1);
        if (ch + 2 < n_chunks) load((ch + 2) * kDC);
      }
    } else {
#pragma unroll
      for (int h = 0; h < kDC / 4 / FG; ++h) {
        const int c0 = 4 * (grp + FG * h);
        const float4 vv = ld4(&vs[s][c0]);
        const float (*a_)[kRS] = guarded ? xq[s] : eq[s];
        const float (*b_)[kRS] = guarded ? xk[s] : ek[s];
        float4 a[TQ], bk[TK];
#pragma unroll
        for (int i = 0; i < TQ; ++i) a[i] = ld4(&a_[TQ * qg + i][c0]);
#pragma unroll
        for (int j = 0; j < TK; ++j) bk[j] = ld4(&b_[kg + kKG * j][c0]);
        vsum += vv.x + vv.y + vv.z + vv.w;
        if (!guarded) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
              for (int j = 0; j < TK; ++j) {
                const float y = fmaf(at(a[i], u), at(bk[j], u), 1.f);
                const float r = (i * TK + j) % kFmaEvery == kFmaEvery - 1
                                    ? rcp_newton(y) : rcp_approx(y);
                acc[i][j] = fmaf(at(vv, u), r, acc[i][j]);
              }
        } else {
#pragma unroll 1
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int i = 0; i < TQ; ++i)
#pragma unroll
              for (int j = 0; j < TK; ++j)
                acc[i][j] = fmaf(at(vv, u),
                                 r_of_tanh(at(a[i], u) + at(bk[j], u)),
                                 acc[i][j]);
        }
      }
    }
    guarded = __syncthreads_or(big);
  }
  // the depth groups' partials, sum v - 2 sum v * r, summed in group order
  // (the last barrier ended every read of ek)
  float* red = &ek[0][0][0];
  if (!producer) {
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j)
        red[(grp * kFQ + TQ * qg + i) * kFT + kg + kKG * j] =
            fmaf(-2.f, acc[i][j], vsum);
  }
  __syncthreads();
  for (int o = tid; o < kFQ * kFT; o += kFwdThreads) {
    const int r = o / kFT, c = o % kFT;
    if (r >= nq || c >= nk) continue;
    float sum = 0.f;
#pragma unroll
    for (int g = 0; g < FG; ++g) sum += red[(g * kFQ + r) * kFT + c];
    st(out, ((size_t)b * Tq + q0 + r) * Tk + t0 + c, sum / temp);
  }
}

// Keys per warp of a backward key tile (kWarps * KPT keys): the least of
// 8, 16, 24, 32 that covers Tk, else 32 and several tiles.
int bwd_kpt(int Tk) {
  const int per_warp = (Tk + kWarps - 1) / kWarps;
  return per_warp <= 8 ? 8 : per_warp <= 16 ? 16 : per_warp <= 24 ? 24 : 32;
}

int bwd_key_tiles(int Tk) {
  const int tile = kWarps * bwd_kpt(Tk);
  return (Tk + tile - 1) / tile;
}

// Query groups of the backward: two (16 warps) where a thread's registers
// allow it, so each scheduler has four warps to hide latency with.
constexpr int bwd_groups(int kpt) { return kpt == 8 ? 2 : 1; }

size_t bwd_smem_bytes(int kpt) {
  // E and raw values of a query chunk, its ds rows and the dQ partials,
  // each double-buffered; with two query groups, the second's dK
  return sizeof(float) * (2 * (2 * kBQ * kBD + kBQ * kWarps * kpt
                               + kBQ * kWarps * kBD)
                          + (bwd_groups(kpt) - 1) * kWarps * kpt * kBD);
}

// Scratch layout (floats): the slices' tickets (unsigned, zeroed by the
// launch; the last block of a slice resets its own), the dv partials
// (B, D), then, with several key tiles, the dQ sums (B, Tq, D). The
// kernel writes the partials and sums before it reads them.
long long bwd_workspace_floats(int B, int Tq, int Tk, int D) {
  const long long n_slices = (D + kBD - 1) / kBD;
  return n_slices + (long long)B * D
         + (bwd_key_tiles(Tk) > 1 ? (long long)B * Tq * D : 0);
}

template <typename T, int KPT, int H>
__global__ void __launch_bounds__(H * kWarps * 32, 1)
scores_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ ds,
                  T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                  unsigned* __restrict__ tickets, float* __restrict__ dv_part,
                  float* __restrict__ dq_sum, int Tq, int Tk, int D,
                  float temp) {
  constexpr int kN = H * kWarps * 32;             // threads
  constexpr int kTile = kWarps * KPT;             // keys per tile
  constexpr int kQL = kBQ * kBD / kN;             // staged Q values a thread
  constexpr int kGL = kBQ * kTile / kN;           // staged ds values a thread
  static_assert(KPT % 4 == 0 && kQL * kN == kBQ * kBD
                && kGL * kN == kBQ * kTile && kBQ % H == 0, "tiling");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float (*eqs)[kBQ][kBD] = reinterpret_cast<float (*)[kBQ][kBD]>(smem);
  float (*xqs)[kBQ][kBD] = eqs + 2;
  float (*gs)[kBQ][kTile] =
      reinterpret_cast<float (*)[kBQ][kTile]>(smem + 4 * kBQ * kBD);
  float (*red)[kBQ][kWarps][kBD] =
      reinterpret_cast<float (*)[kBQ][kWarps][kBD]>(
          smem + 4 * kBQ * kBD + 2 * kBQ * kTile);
  float (*dk_hi)[KPT][kBD] = reinterpret_cast<float (*)[KPT][kBD]>(
      smem + 4 * kBQ * kBD + 2 * kBQ * kTile + 2 * kBQ * kWarps * kBD);
  __shared__ float wsum[H * kWarps], vred[H * kWarps][kBD];
  __shared__ bool last;

  const int b = blockIdx.y, d0 = blockIdx.x * kBD;
  const int tid = threadIdx.x, lane = tid % 32;
  // warp w of query group qh: keys w * KPT .. + KPT - 1 of each tile, the
  // chunk's query rows qh, qh + H, ...
  const int w = tid / 32 % kWarps, qh = tid / 32 / kWarps;
  const int d = d0 + lane;
  const bool d_ok = d < D;
  const int n_kt = (Tk + kTile - 1) / kTile;
  const int n_qc = (Tq + kBQ - 1) / kBQ;
  const T* qb = q + (size_t)b * Tq * D;
  const T* kb = k + (size_t)b * Tk * D;
  const T* dsb = ds + (size_t)b * Tq * Tk;
  // 4 v[d] / temp scales both dQ and dK: 1 - th^2 = 4 r (1 - r)
  const float scale = d_ok ? 4.f * ld(v, d) / temp : 0.f;

  float gsum = 0.f;      // sum of the ds values this thread staged
  float dva = 0.f;       // sum over its (q, t) of ds * r, column d
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    float xk[KPT], ek[KPT], dka[KPT];
    bool kbig = false;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int t = k0 + w * KPT + j;
      xk[j] = (t < Tk && d_ok) ? ld(kb, (size_t)t * D + d) : 0.f;
      ek[j] = expf(2.f * xk[j]);
      dka[j] = 0.f;
      kbig |= too_big(xk[j]);
    }
    kbig = __syncthreads_or(kbig);

    float rq[kQL], rg[kGL];
    auto load = [&](int q0) {
#pragma unroll
      for (int m = 0; m < kQL; ++m) {
        const int i = tid + kN * m, r = i / kBD, dd = d0 + i % kBD;
        rq[m] = (q0 + r < Tq && dd < D) ? ld(qb, (size_t)(q0 + r) * D + dd)
                                        : 0.f;
      }
#pragma unroll
      for (int m = 0; m < kGL; ++m) {
        const int i = tid + kN * m, r = i / kTile, t = k0 + i % kTile;
        rg[m] = (q0 + r < Tq && t < Tk) ? ld(dsb, (size_t)(q0 + r) * Tk + t)
                                        : 0.f;
      }
    };
    auto stage = [&](int s) {
      bool big = false;
#pragma unroll
      for (int m = 0; m < kQL; ++m) {
        const int i = tid + kN * m, r = i / kBD, c = i % kBD;
        xqs[s][r][c] = rq[m];
        eqs[s][r][c] = expf(2.f * rq[m]);
        big |= too_big(rq[m]);
      }
#pragma unroll
      for (int m = 0; m < kGL; ++m) {
        const int i = tid + kN * m;
        gs[s][i / kTile][i % kTile] = rg[m];
        gsum += rg[m];
      }
      return big;
    };

    load(0);
    bool guarded = __syncthreads_or(stage(0)) || kbig;
    for (int ch = 0; ch < n_qc; ++ch) {
      const int s = ch & 1, q0 = ch * kBQ;
      if (ch + 1 < n_qc) load(q0 + kBQ);     // in flight during the math
#pragma unroll 2
      for (int ii = 0; ii < kBQ / H; ++ii) {
        const int qi = qh + H * ii;
        const float4* g4 = reinterpret_cast<const float4*>(&gs[s][qi][w * KPT]);
        // this row's sums over the warp's keys: sum p (dQ), sum ds * r (dv)
        float part = 0.f, grow = 0.f;
        if (!guarded) {
          const float e = eqs[s][qi][lane];
#pragma unroll
          for (int j4 = 0; j4 < KPT / 4; ++j4) {
            const float4 g = g4[j4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * j4 + u;
              const float r = rcp_approx(fmaf(e, ek[j], 1.f));
              const float gr = at(g, u) * r;
              const float p = fmaf(-gr, r, gr);     // ds * r * (1 - r)
              dka[j] += p;
              part += p;
              grow += gr;
            }
          }
        } else {
          const float x = xqs[s][qi][lane];
#pragma unroll
          for (int j4 = 0; j4 < KPT / 4; ++j4) {
            const float4 g = g4[j4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int j = 4 * j4 + u;
              const float r = r_of_tanh(x + xk[j]);
              const float gr = at(g, u) * r;
              const float p = fmaf(-gr, r, gr);
              dka[j] += p;
              part += p;
              grow += gr;
            }
          }
        }
        red[s][qi][w][lane] = part;
        dva += grow;
      }
      bool big = false;
      if (ch + 1 < n_qc) big = stage(s ^ 1);
      // red[s] and the next chunk are written; both buffers s ^ 1 were last
      // read before the previous barrier
      guarded = __syncthreads_or(big) || kbig;
      // dQ of the chunk's rows: the warps' partials in warp order
#pragma unroll
      for (int m = 0; m < kQL; ++m) {
        const int i = tid + kN * m, qi = i / kBD;
        const int qrow = q0 + qi;
        if (qrow >= Tq || !d_ok) continue;    // i % kBD is this lane: d
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < kWarps; ++u) sum += red[s][qi][u][lane];
        const size_t o = ((size_t)b * Tq + qrow) * D + d;
        if (n_kt > 1) {
          // this thread owns (qrow, d) in every key tile: fixed order
          if (kt > 0) sum += dq_sum[o];
          if (kt + 1 < n_kt) {
            dq_sum[o] = sum;
            continue;
          }
        }
        st(dq, o, sum * scale);
      }
    }
    // dK of the tile: the query groups' sums in group order
    if (H > 1) {
      if (qh == 1) {
#pragma unroll
        for (int j = 0; j < KPT; ++j) dk_hi[w][j][lane] = dka[j];
      }
      __syncthreads();
    }
    if (qh == 0) {
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int t = k0 + w * KPT + j;
        const float sum = H > 1 ? dka[j] + dk_hi[w][j][lane] : dka[j];
        if (t < Tk && d_ok) st(dk, ((size_t)b * Tk + t) * D + d, sum * scale);
      }
    }
  }

  // dv partial of (b, slice): sum ds - 2 sum ds * r, each in a fixed order
  float g = gsum;
#pragma unroll
  for (int off = 16; off > 0; off /= 2) g += __shfl_down_sync(~0u, g, off);
  if (lane == 0) wsum[tid / 32] = g;
  vred[tid / 32][lane] = dva;
  __syncthreads();
  if (tid < kBD) {
    float gtot = 0.f, rtot = 0.f;
    for (int u = 0; u < H * kWarps; ++u) {
      gtot += wsum[u];
      rtot += vred[u][tid];
    }
    if (d0 + tid < D) dv_part[(size_t)b * D + d0 + tid] = fmaf(-2.f, rtot, gtot);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  // the slice's last block: every partial is visible; sum them b = 0 ..
  __threadfence();
  if (tid < kBD && d0 + tid < D) {
    float sum = 0.f;
    for (int bb = 0; bb < (int)gridDim.y; ++bb)
      sum += __ldcg(dv_part + (size_t)bb * D + d0 + tid);
    st(dv, d0 + tid, sum / temp);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, int B, int Tq, int Tk, int D, float temp,
                       cudaStream_t stream) {
  const dim3 grid((Tk + kFT - 1) / kFT, (Tq + kFQ - 1) / kFQ, B);
  scores_fwd_kernel<T><<<grid, kFwdThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, D, temp);
  return cudaGetLastError();
}

template <typename T, int KPT>
cudaError_t launch_bwd_kpt(const void* q, const void* k, const void* v,
                           const void* ds, void* dq, void* dk, void* dv,
                           float* work, int B, int Tq, int Tk, int D,
                           float temp, cudaStream_t stream) {
  constexpr int H = bwd_groups(KPT);
  const size_t smem = bwd_smem_bytes(KPT);
  static bool smem_set = false;   // once, and so never inside a graph capture
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        scores_bwd_kernel<T, KPT, H>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    smem_set = true;
  }
  const int n_slices = (D + kBD - 1) / kBD;
  const cudaError_t err =
      cudaMemsetAsync(work, 0, sizeof(unsigned) * n_slices, stream);
  if (err) return err;
  scores_bwd_kernel<T, KPT, H>
      <<<dim3(n_slices, B), H * kWarps * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(ds),
          static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
          reinterpret_cast<unsigned*>(work), work + n_slices,
          work + n_slices + (size_t)B * D, Tq, Tk, D, temp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* ds, void* dq, void* dk, void* dv,
                       float* work, int B, int Tq, int Tk, int D, float temp,
                       cudaStream_t stream) {
  switch (bwd_kpt(Tk)) {
    case 8:
      return launch_bwd_kpt<T, 8>(q, k, v, ds, dq, dk, dv, work, B, Tq, Tk,
                                  D, temp, stream);
    case 16:
      return launch_bwd_kpt<T, 16>(q, k, v, ds, dq, dk, dv, work, B, Tq, Tk,
                                   D, temp, stream);
    case 24:
      return launch_bwd_kpt<T, 24>(q, k, v, ds, dq, dk, dv, work, B, Tq, Tk,
                                   D, temp, stream);
    default:
      return launch_bwd_kpt<T, 32>(q, k, v, ds, dq, dk, dv, work, B, Tq, Tk,
                                   D, temp, stream);
  }
}

}  // namespace

extern "C" {

const char* attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Floats of fp32 scratch attention_scores_bwd needs; it need not be
// cleared.
long long attention_bwd_workspace_floats(int B, int Tq, int Tk, int D) {
  return bwd_workspace_floats(B, Tq, Tk, D);
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
// the same dtype, and work: attention_bwd_workspace_floats(B, Tq, Tk, D)
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
