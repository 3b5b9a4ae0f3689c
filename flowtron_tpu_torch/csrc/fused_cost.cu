// P5: K1 stripped to its dots, its LSTM cells or its attention, for cost
// attribution.
//
// Replaces scripts/exp_fused_cost.py:run (pallas_call at :53) and its three
// bodies, each N steps of a recurrence over zero-initialised scratch h,
// h2 (B, H) and prev (B, M), bf16 weights, fp32 sums, z (N, B, M) fp32,
// kv (B, Tk, D) bf16, mel (N, B, M) fp32:
//
//   v_dots (:82)  h = tanh((prev @ w0)[:, :H] + (h @ w1)[:, :H]);
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
// Where the script slices a dot's output ([:, :H], [:, :M]) the kernel
// still computes the whole product (and all D channels of the context):
// the point of the probe is what reading every weight of a K1 frame costs
// (exp_fused_int8.py:43-44 says why a narrowed dot would not measure it).
//
// What bounds it on an H100: the weight bytes of every step (25.8 MB of
// bf16 for v_dots, 25.4 MB for v_lstm, 0.1 MB for v_attn; they stay in
// the 50 MB L2 across steps, ~8 us at 3.35 TB/s if they came from HBM)
// and the latency of the dependent stages, each a grid barrier and round
// trips to stage its inputs and to store its outputs.
//
// The design is K1's (csrc/decoder.cu) since PR 8, stripped down, so that
// the three variants' times split K1's frame:
// - one persistent cooperative launch for the whole recurrence, one
//   256-thread block a SM, the step loop inside the kernel; the blocks
//   meet at the counter barrier of csrc/grid_sync.cuh after each stage;
// - a step is a chain of dependent stages (ops/fused_cost.py:p5_plan):
//   three for v_dots and v_lstm (the first cell, the second, the head),
//   two for v_attn (the query, the attention); each stage is a list of
//   jobs, matrices whose row quads are split evenly over all blocks;
// - the recurrent halves h(t - 1) @ w1 and (v_lstm) h2(t - 1) @ w3 leave
//   the dependent chain: they run in the stage after their input is known
//   (beside w2 . h(t) and the head) and their sums wait in scratch until
//   the cell adds them, as the script adds its separate dots;
// - weights never depend on the step: right after arriving at the
//   barrier, thread 0 of each block starts one bulk (TMA) copy a job of
//   its rows of the next stage into shared memory, on an mbarrier, so the
//   transfer overlaps the barrier and the next stage's staging (all of a
//   stage's rows fit: at most ~128 KB a block); the bf16 weights are
//   streamed so every step, as K1 streams its weights, not held resident;
// - a warp owns one quad of rows (one unit's four gate rows, interleaved
//   by ops/fused_cost.py:pack_weights, or four consecutive output columns
//   of the head and query dots), reads them in 16-byte bf16 vectors
//   against the bf16 input rows staged in shared memory (SIMT fp32 FMAs,
//   csrc/quad_dot.cuh), reduces with shuffles and applies the epilogue;
// - v_attn: the attention stage spreads the scores over every warp of the
//   grid, one (batch row, key position) a slot; the next step's query
//   stage, which stages prev = ctx[:, :M] + z anyway, combines them in a
//   fixed order: each block takes the softmax of every row (the bf16
//   rounding of a_k needs the row's max and sum before any product with
//   kv, so the partial contexts of K1's slots would not give this
//   function's bits) and the first M context channels (its query input);
//   block 0 writes the mel; the other channels follow in the attention
//   stage, whose warps are mostly idle;
// - up to 8 batch rows share one pass over the weights; more rows loop
//   over groups of 8 inside each stage;
// - no floating-point atomics: every sum has one owner and a fixed order,
//   so two calls give bitwise-equal mels.
// A clock in the kernel (block 0's time at each barrier) splits a step by
// stage (ops/fused_cost.py:fused_cost_stage_split).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "quad_dot.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;          // batch rows per pass over the weights
constexpr int kMaxJobs = 2;
constexpr int kMaxStages = 3;
constexpr int kLoads = 8;         // staging loads in flight a thread
constexpr int kStatic = 2048;     // kept for static shared memory
                                  // (ops/fused_cost.py STATIC_SMEM)

enum Variant { kDots = 0, kLstm = 1, kAttn = 2 };
// what a job's epilogue does with its row quads
enum Kind { kCell, kCell2, kRec1, kRec2, kHead, kQuery };

inline int pad8(int n) { return (n + 7) & ~7; }

struct Job {
  const __nv_bfloat16* w;   // (rows, Kp) packed bf16
  int Kp, rows, kind;
};

struct Stage {
  int n_jobs;
  Job job[kMaxJobs];
};

struct Params {
  Stage st[kMaxStages];
  int n_stages, variant, N, B, M, H, D, Tk, grid;
  int wbuf_off, wcap;       // the prefetch buffer: offset, capacity (bytes)
  const int* bounds;        // (n_stages, kMaxJobs, grid + 1) quad bounds
  const float* z;
  const __nv_bfloat16* kv;
  float* mel;
  float *h, *h2, *rec1, *rec2, *q, *scores, *ctx;
  unsigned* bar;
  long long* clock;         // or null: block 0's time at each barrier
};

// This block's quads of a stage (p5_plan's bounds), numbered on locally;
// the first pre[j] of job j are prefetched into the buffer at byte
// base[j], greedily in job order. Computed once a launch.
struct Quads {
  int lo[kMaxJobs], cnt[kMaxJobs + 1], pre[kMaxJobs], base[kMaxJobs];
};

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ void block_quads(const Params& p, int si, Quads& q) {
  const Stage& s = p.st[si];
  const int* bnd = p.bounds + si * kMaxJobs * (p.grid + 1);
  q.cnt[0] = 0;
  int used = 0;
  for (int j = 0; j < s.n_jobs; ++j) {
    const int* bj = bnd + j * (p.grid + 1);
    q.lo[j] = bj[blockIdx.x];
    const int n = bj[blockIdx.x + 1] - q.lo[j], per = 8 * s.job[j].Kp;
    q.cnt[j + 1] = q.cnt[j] + n;
    q.pre[j] = max(0, min(n, (p.wcap - used) / per));
    q.base[j] = used;
    used += q.pre[j] * per;
  }
}

// Start copying this block's prefetched rows of a stage into the buffer:
// one bulk copy a job, issued by thread 0, completing on *bar (a stage
// with nothing to copy completes its phase on the arrival alone).
__device__ __noinline__ void prefetch(const Stage& s, const Quads& q,
                                      unsigned char* wb, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  unsigned bytes = 0;
  for (int j = 0; j < s.n_jobs; ++j) bytes += 8u * q.pre[j] * s.job[j].Kp;
  mbar_expect(bar, bytes);
  for (int j = 0; j < s.n_jobs; ++j)
    if (q.pre[j])
      bulk_copy(wb + q.base[j], s.job[j].w + (size_t)4 * q.lo[j] * s.job[j].Kp,
                8u * q.pre[j] * s.job[j].Kp, bar);
}

// dst[b * Kp + k] = bf16(src[b * ld + k]) for k < n, 0 for n <= k < Kp;
// src == nullptr stages zeros. Activations are written by other blocks of
// this launch, so they are read through L2: 4-float vectors (n, ld and
// Kp multiples of 4), a thread's vectors tracked by (row, column) without
// dividing, kLoads loads in flight.
__device__ void stage_rows(__nv_bfloat16* dst, int Kp, const float* src,
                           int ld, int n, int nb) {
  const int K4 = Kp >> 2, total = nb * K4;
  int b = threadIdx.x / K4, f = threadIdx.x - b * K4;
  for (int j0 = threadIdx.x; j0 < total; j0 += kLoads * kThreads) {
    float4 v[kLoads];
    int bs[kLoads], fs[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      bs[u] = b;
      fs[u] = f;
      v[u] = j0 + u * kThreads < total && src != nullptr && 4 * f < n
                 ? __ldcg(reinterpret_cast<const float4*>(
                       src + (size_t)b * ld + 4 * f))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
      for (f += kThreads; f >= K4; f -= K4) ++b;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j0 + u * kThreads >= total) break;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[u].x, v[u].y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[u].z, v[u].w);
      *reinterpret_cast<uint2*>(dst + bs[u] * Kp + 4 * fs[u]) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// acc[c][lane] without dynamic register indexing.
__device__ __forceinline__ float pick(const float (&acc)[4][kMaxB], int c,
                                      int lane) {
  float v = 0.f;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    if (b == lane) v = acc[c][b];
  return v;
}

// The epilogue of unit (or output quad) u for batch row b: y[c] is row
// 4u + c of the job's product; op (a waiting recurrent half or z) and
// hold (the LSTM's h(t - 1)) were loaded before the product.
__device__ void epilogue(const Params& p, int kind, int u, int b,
                         float (&y)[4], int t, float4 op, float hold) {
  const size_t b4 = (size_t)b * 4 * p.H + 4 * u, bh = (size_t)b * p.H + u;
  const float o[4] = {op.x, op.y, op.z, op.w};
  switch (kind) {
    case kCell:                 // + h(t - 1) . w1, waiting since last step
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] += o[c];
      if (p.variant == kDots) {
        p.h[bh] = tanhf(y[0]);
      } else {                  // gates i, f, g, o
        const float cell = sigmoidf(y[1]) * hold + sigmoidf(y[0]) * tanhf(y[2]);
        p.h[bh] = sigmoidf(y[3]) * tanhf(cell);
      }
      break;
    case kCell2:
      if (p.variant == kDots) {
        p.h2[bh] = tanhf(y[0]);
      } else {                  // + h2(t - 1) . w3
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] += o[c];
        p.h2[bh] = sigmoidf(y[0]) * tanhf(y[1]);
      }
      break;
    case kRec1:
    case kRec2:
      *reinterpret_cast<float4*>((kind == kRec1 ? p.rec1 : p.rec2) + b4) =
          make_float4(y[0], y[1], y[2], y[3]);
      break;
    case kHead:
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * u + c < p.M)
          p.mel[((size_t)t * p.B + b) * p.M + 4 * u + c] = y[c] + o[c];
      break;
    default:                    // kQuery
      *reinterpret_cast<float4*>(p.q + (size_t)b * p.D + 4 * u) =
          make_float4(y[0], y[1], y[2], y[3]);
  }
}

// The operands of that epilogue, loaded before the product so that their
// round trip overlaps it.
__device__ __forceinline__ void epilogue_operands(const Params& p, int kind,
                                                  int u, int b, int t,
                                                  float4& op, float& hold) {
  const size_t b4 = (size_t)b * 4 * p.H + 4 * u;
  if (kind == kCell || (kind == kCell2 && p.variant == kLstm))
    op = __ldcg(reinterpret_cast<const float4*>(
        (kind == kCell ? p.rec1 : p.rec2) + b4));
  if (kind == kCell && p.variant == kLstm) hold = p.h[(size_t)b * p.H + u];
  if (kind == kHead) {
    const float* z = p.z + ((size_t)t * p.B + b) * p.M + 4 * u;
    op.x = 4 * u < p.M ? __ldg(z) : 0.f;
    op.y = 4 * u + 1 < p.M ? __ldg(z + 1) : 0.f;
    op.z = 4 * u + 2 < p.M ? __ldg(z + 2) : 0.f;
    op.w = 4 * u + 3 < p.M ? __ldg(z + 3) : 0.f;
  }
}

// v_attn's shared memory (ops/fused_cost.py:p5_plan's fixed bytes): the
// staged query input (rows x M bf16), every row's softmax weights (B x
// Tk), then the partial sums of the first M context channels (8 a
// thread).
__device__ __forceinline__ float* attn_weights(const Params& p,
                                               unsigned char* sm) {
  return reinterpret_cast<float*>(sm + 2 * min(p.B, kMaxB) * p.M);
}

// Each row's softmax weights a_k = bf16(e_k / sum) for rows g0 .. g0 +
// nb - 1 of the last step's scores (one warp a row) into aw (B x Tk).
__device__ void softmax_rows(const Params& p, int g0, int nb, float* aw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < nb) {
    const float* sc = p.scores + (size_t)(g0 + warp) * p.Tk;
    float* a = aw + (size_t)(g0 + warp) * p.Tk;
#pragma unroll 4
    for (int k = lane; k < p.Tk; k += 32) a[k] = __ldcg(sc + k);
    float m = -INFINITY;
    for (int k = lane; k < p.Tk; k += 32) m = fmaxf(m, a[k]);
    m = warp_max(m);
    float sum = 0.f;
    for (int k = lane; k < p.Tk; k += 32) {
      const float e = expf(a[k] - m);
      a[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < p.Tk; k += 32) a[k] = bf16r(a[k] / sum);
  }
  __syncthreads();
}

// sum_k a[k] kv[k * D + 8 .. + 8] over keys k0, k0 + step, ... < Tk, added
// in key order, the loads of up to 8 keys in flight.
__device__ __forceinline__ void context_sum(const __nv_bfloat16* kv,
                                            const float* a, int D, int Tk,
                                            int k0, int step,
                                            float (&acc)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  for (int kb = k0; kb < Tk; kb += 8 * step) {
    uint4 v[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = kb + r * step;
      if (k < Tk)
        v[r] = __ldg(reinterpret_cast<const uint4*>(kv + (size_t)k * D));
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = kb + r * step;
      if (k >= Tk) break;
      float f[8];
      bf16x8(v[r], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = fmaf(a[k], f[e], acc[e]);
    }
  }
}

// The first M channels of the last step's context (t - 1) for rows g0 ..
// g0 + nb - 1, in every block: thread (row, key lane kl, 8 channels j)
// sums keys kl, kl + kls, ..., then one thread a (row, channel) adds the
// key lanes in order: prev = ctx[:, :M] + z[t - 1], staged as the query's
// bf16 input (xs, row stride M; null after the last step) and written to
// the mel (and ctx) by block 0.
__device__ __noinline__ void context_head(const Params& p, int t, int g0,
                                          int nb, __nv_bfloat16* xs,
                                          const float* aw, float* part) {
  const int M = p.M, chunks = M / 8, per_row = kThreads / nb;
  const int kls = per_row / chunks;
  const int b = threadIdx.x / per_row, r = threadIdx.x % per_row;
  const int j = r % chunks, kl = r / chunks;
  if (b < nb && kl < kls) {
    float acc[8];
    context_sum(p.kv + (size_t)(g0 + b) * p.Tk * p.D + 8 * j,
                aw + (size_t)(g0 + b) * p.Tk, p.D, p.Tk, kl, kls, acc);
#pragma unroll
    for (int e = 0; e < 8; ++e) part[8 * threadIdx.x + e] = acc[e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nb * M; i += kThreads) {
    const int bb = i / M, c = i % M;
    const float* pp = part + 8 * (bb * per_row + c / 8) + c % 8;
    float s = 0.f;
    for (int k = 0; k < kls; ++k) s += pp[8 * k * chunks];
    const float ctx = bf16r(s);
    const size_t o = ((size_t)(t - 1) * p.B + g0 + bb) * M + c;
    const float v = ctx + p.z[o];
    if (xs != nullptr) xs[bb * M + c] = __float2bfloat16_rn(v);
    if (blockIdx.x == 0) {
      p.mel[o] = v;
      p.ctx[(size_t)(g0 + bb) * p.D + c] = ctx;
    }
  }
}

// The context's channels >= M for every row, one warp a (row, 8
// channels) over the grid, lanes over keys; nobody reads them, but K1's
// frame computes them all.
__device__ __noinline__ void context_rest(const Params& p, const float* aw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = p.M / 8, rest = p.D / 8 - chunks;
  for (int slot = blockIdx.x * kWarps + warp; slot < p.B * rest;
       slot += p.grid * kWarps) {
    const int b = slot / rest, j = chunks + slot % rest;
    float acc[8];
    context_sum(p.kv + (size_t)b * p.Tk * p.D + 8 * j,
                aw + (size_t)b * p.Tk, p.D, p.Tk, lane, 32, acc);
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = warp_sum(acc[e]);
    if (lane == 0)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        p.ctx[(size_t)b * p.D + 8 * j + e] = bf16r(acc[e]);
  }
}

// v_attn's attention stage: one warp a (batch row, key position) slot,
// e_k = sum_d tanh(bf16(bf16(q_d) + kv_kd)), fp32 sums; every lane's
// loads in flight at once (D / 4 four-element vectors, 8 a lane a round).
__device__ __noinline__ void scores(const Params& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D4 = p.D / 4;
  for (int slot = blockIdx.x * kWarps + warp; slot < p.B * p.Tk;
       slot += p.grid * kWarps) {
    const float4* q = reinterpret_cast<const float4*>(
        p.q + (size_t)(slot / p.Tk) * p.D);
    const uint2* kv = reinterpret_cast<const uint2*>(p.kv + (size_t)slot * p.D);
    float s = 0.f;
    for (int d0 = lane; d0 < D4; d0 += 8 * 32) {
      float4 qv[8];
      uint2 kvv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int d = d0 + 32 * r;
        if (d < D4) {
          qv[r] = __ldcg(q + d);
          kvv[r] = __ldg(kv + d);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (d0 + 32 * r >= D4) break;
        const float qq[4] = {qv[r].x, qv[r].y, qv[r].z, qv[r].w};
        const uint32_t kw[2] = {kvv[r].x, kvv[r].y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t w = kw[e >> 1];
          const float kf =
              __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
          s += tanhf(bf16r(bf16r(qq[e]) + kf));
        }
      }
    }
    s = warp_sum(s);
    if (lane == 0) p.scores[slot] = s;
  }
}

__device__ void run_stage(const Params& p, int si, const Quads& q, int t,
                          unsigned char* sm, uint64_t* bar,
                          unsigned& phase) {
  const Stage& s = p.st[si];
  if (s.n_jobs == 0) {        // v_attn's attention
    mbar_wait(bar, phase & 1);
    ++phase;
    scores(p);
    if (t > 0) context_rest(p, attn_weights(p, sm));   // of step t - 1
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Job& j0 = s.job[0];
  const int Kp = j0.Kp, nq = q.cnt[s.n_jobs];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sm);
  const unsigned char* wb = sm + p.wbuf_off;
  for (int g0 = 0; g0 < p.B; g0 += kMaxB) {
    const int nb = min(kMaxB, p.B - g0);
    // every job of a stage reads the same input rows
    if (j0.kind == kQuery && t > 0) {   // the last step's context
      float* aw = attn_weights(p, sm);
      softmax_rows(p, g0, nb, aw);
      context_head(p, t, g0, nb, xs, aw, aw + (size_t)p.B * p.Tk);
    } else if (j0.kind == kQuery || (j0.kind == kCell && t == 0)) {
      stage_rows(xs, Kp, nullptr, 0, 0, nb);
    } else if (j0.kind == kCell) {   // prev = the last step's mel
      stage_rows(xs, Kp, p.mel + ((size_t)(t - 1) * p.B + g0) * p.M, p.M,
                 p.M, nb);
    } else {
      const float* src = j0.kind == kCell2 ? p.h : p.h2;
      stage_rows(xs, Kp, src + (size_t)g0 * p.H, p.H, p.H, nb);
    }
    if (g0 == 0) {            // this stage's prefetched rows
      mbar_wait(bar, phase & 1);
      ++phase;
    }
    __syncthreads();
    for (int qq = warp; qq < nq; qq += kWarps) {
      int j = 0;
      while (qq >= q.cnt[j + 1]) ++j;
      const int l = qq - q.cnt[j], u = q.lo[j] + l, kind = s.job[j].kind;
      float4 op = make_float4(0.f, 0.f, 0.f, 0.f);
      float hold = 0.f;
      if (lane < nb) epilogue_operands(p, kind, u, g0 + lane, t, op, hold);
      float acc[4][kMaxB];
      if (l < q.pre[j])
        quad_dot_bf16<false>(reinterpret_cast<const __nv_bfloat16*>(
                                 wb + q.base[j]) + (size_t)l * 4 * Kp,
                             Kp, xs, nb, acc);
      else
        quad_dot_bf16<true>(s.job[j].w + (size_t)u * 4 * Kp, Kp, xs, nb, acc);
      if (lane < nb) {
        float y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = pick(acc, c, lane);
        epilogue(p, kind, u, g0 + lane, y, t, op, hold);
      }
    }
    __syncthreads();          // the staged rows are free again
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    p5_kernel(const __grid_constant__ Params param) {
  extern __shared__ __align__(128) unsigned char sm[];
  __shared__ uint64_t bar;
  __shared__ Quads sq[kMaxStages];
  // the launch's parameters in shared memory: the stages index them, and
  // a kernel parameter read through its address costs a round trip
  __shared__ Params p;
  if (threadIdx.x == 0) p = param;
  __syncthreads();
  if (threadIdx.x < p.n_stages) block_quads(p, threadIdx.x, sq[threadIdx.x]);
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  unsigned char* wb = sm + p.wbuf_off;
  unsigned passed = 0, phase = 0;
  prefetch(p.st[0], sq[0], wb, &bar);
  for (int t = 0; t < p.N; ++t) {
    for (int s = 0; s < p.n_stages; ++s) {
      run_stage(p, s, sq[s], t, sm, &bar, phase);
      barrier_arrive(p.bar);
      // the next stage's rows, while this block waits for the others
      const int next = s + 1 < p.n_stages ? s + 1 : 0;
      if (s + 1 < p.n_stages || t + 1 < p.N)
        prefetch(p.st[next], sq[next], wb, &bar);
      barrier_wait(p.bar, ++passed * (unsigned)p.grid);
      if (p.clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        p.clock[(size_t)t * p.n_stages + s] = gtime();
    }
  }
  if (p.variant == kAttn) {   // the last step's context and mel
    float* aw = attn_weights(p, sm);
    for (int g0 = 0; g0 < p.B; g0 += kMaxB) {
      const int nb = min(kMaxB, p.B - g0);
      softmax_rows(p, g0, nb, aw);
      context_head(p, p.N, g0, nb, nullptr, aw, aw + (size_t)p.B * p.Tk);
      __syncthreads();
    }
    context_rest(p, aw);
  }
}

int smem_bytes() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev))
    return -1;
  return (optin - kStatic) & ~127;
}

}  // namespace

extern "C" {

const char* fused_cost_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of the kernel that can be resident at once on this card (the
// most its cooperative launch may take) when a block needs `fixed` bytes
// beside its prefetch buffer, or -1.
int fused_cost_coresident_blocks(int fixed) {
  int dev = 0, sms = 0, per_sm = 0;
  const int smem = smem_bytes();
  if (smem < fixed || cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaFuncSetAttribute((const void*)p5_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, (const void*)p5_kernel, kThreads, smem))
    return -1;
  return per_sm * sms;
}

// Floats of workspace fused_cost_f32 needs (the caller allocates it; the
// entry zeroes it: h and h2 start at zero, as the Pallas scratch does).
long long fused_cost_workspace_floats(int B, int H, int D, int Tk) {
  return (long long)B * (10LL * H + 2LL * D + Tk);
}

// N steps of `variant` (0 v_dots, 1 v_lstm, 2 v_attn), one cooperative
// launch of n_blocks blocks. z (N, B, M) fp32, kv (B, Tk, D) bf16
// (v_attn only), mel (N, B, M) fp32 out. w: the packed bf16 weights
// (ops/fused_cost.py:pack_weights), each (N_i, P(K_i)) with P(n) = n
// rounded up to 8:
//   v_dots: w0 (4H, P(M)), w1, w2 (4H, P(H)) interleaved, w3 (Nc, P(H)) in
//           column order (Nc = 4H);
//   v_lstm: w0 (4H, P(M)), w1, w2, w3 (4H, P(H)) interleaved, w4 (Nc,
//           P(H)) in column order (Nc = 128 when M = 80);
//   v_attn: w0 (D, P(M)) in column order; H = 0.
// work: fused_cost_workspace_floats(B, H, D, Tk) floats; bar: one zeroed
// word; bounds: (stages, 2, n_blocks + 1) int32 on the device from
// ops/fused_cost.py:p5_plan, whose stage and job order this entry
// repeats; fixed: the plan's bytes beside the prefetch buffer; clock: null
// or (N, stages) int64.
int fused_cost_f32(int variant, const float* z, const void* kv,
                   const void* const* w, float* mel, float* work,
                   unsigned* bar, const int* bounds, long long* clock,
                   int n_blocks, int fixed, int N, int B, int M, int H,
                   int D, int Tk, int Nc, void* stream_handle) {
  if (variant < 0 || variant > 2 || N < 1 || B < 1 || n_blocks < 1 ||
      Nc % 4 || D % 4 ||
      (variant == kAttn && (D < M || M % 8 || D % 8 || M > 256)) ||
      (variant != kAttn && (Nc < M || H < 4 || H % 4 || M % 4)))
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int Mp = pad8(M), Hp = pad8(H);
  const __nv_bfloat16* const* W =
      reinterpret_cast<const __nv_bfloat16* const*>(w);
  Params p = {};
  auto add = [&p](int s, const __nv_bfloat16* wt, int Kp, int rows,
                  int kind) {
    Job j = {wt, Kp, rows, kind};
    p.st[s].job[p.st[s].n_jobs++] = j;
  };
  if (variant == kAttn) {
    add(0, W[0], Mp, D, kQuery);   // stage 1: the attention, no jobs
    p.n_stages = 2;
  } else {
    add(0, W[0], Mp, 4 * H, kCell);
    add(1, W[2], Hp, 4 * H, kCell2);
    add(1, W[1], Hp, 4 * H, kRec1);
    if (variant == kDots) {
      add(2, W[3], Hp, Nc, kHead);
    } else {
      add(2, W[4], Hp, Nc, kHead);
      add(2, W[3], Hp, 4 * H, kRec2);
    }
    p.n_stages = 3;
  }
  p.variant = variant;
  p.N = N;
  p.B = B;
  p.M = M;
  p.H = H;
  p.D = D;
  p.Tk = Tk;
  p.grid = n_blocks;
  p.bounds = bounds;
  p.z = z;
  p.kv = static_cast<const __nv_bfloat16*>(kv);
  p.mel = mel;
  float* f = work;
  auto take = [&f](size_t n) { float* r = f; f += n; return r; };
  p.h = take((size_t)B * H);
  p.h2 = take((size_t)B * H);
  p.rec1 = take((size_t)B * 4 * H);
  p.rec2 = take((size_t)B * 4 * H);
  p.q = take((size_t)B * D);
  p.scores = take((size_t)B * Tk);
  p.ctx = take((size_t)B * D);
  p.bar = bar;
  p.clock = clock;

  const int smem = smem_bytes();
  p.wbuf_off = (fixed + 127) & ~127;
  p.wcap = smem - p.wbuf_off;
  if (smem < 0 || p.wcap < 0) return cudaErrorInvalidValue;
  const int most = fused_cost_coresident_blocks(fixed);
  if (most < 0) return cudaErrorInvalidValue;
  if (n_blocks > most) return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err;
  if ((err = cudaMemsetAsync(work, 0,
                             sizeof(float) * fused_cost_workspace_floats(
                                 B, H, D, Tk), stream)))
    return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)p5_kernel, n_blocks,
                                    kThreads, args, smem, stream);
  return err ? err : cudaGetLastError();
}

}  // extern "C"
