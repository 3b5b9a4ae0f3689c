// K1: one flow's whole inverse autoregressive scan, fp32 or bf16 weights,
// in one persistent cooperative launch.
//
// Replaces flowtron_tpu/ops/decoder_pallas.py:fused_flow_infer (the Pallas
// kernel _make_kernel, called at :334), with the semantics of :136-223:
// per frame, the attention-LSTM cell on the previous output frame, the
// query, additive attention (v . tanh(q + k) / temperature, key mask to
// -1e9, max-subtracted softmax, context), the gate sigmoid on
// [h_att, ctx] (last flow only), n decoder LSTM cells, the tanh dense
// stack, the coupling head and out = (z - b) * exp(-log_s).
//
// What bounds it on an H100: weight bytes, and the chain of dependent
// stages a frame. One flagship flow holds about 26.8 M fp32 parameters
// (107 MB), more than the 50 MB L2, so every frame streams them from HBM:
// about 32 us a flow-frame at 3.35 TB/s. A frame is a chain of 4 +
// n_layers + n_dense stages (8 at flagship width), each needing the whole
// output of the one before: each pays a grid barrier (~1 us), a round
// trip to stage its inputs and one for its epilogue.
//
// The design:
// - One cooperative launch a flow, one 256-thread block a SM; the frame
//   loop runs inside the kernel. Between stages a grid barrier: each block
//   adds one to a counter in global memory (release), one thread spins on
//   an acquire load, then __syncthreads (csrc/grid_sync.cuh; chip_smoke.py
//   times it against cooperative_groups' grid sync, ~10% slower).
// - Each stage is a list of jobs, matrices whose row quads (four rows,
//   one LSTM unit's four gates) are split evenly over all blocks, so each
//   block streams 1 / grid of every stage's bytes (ops/decoder.py:k1_plan).
//   A warp takes a quad (ks warps split its k when a block has fewer
//   quads than warps, and sum in a fixed order in shared memory), reads
//   its rows with 16-byte loads and applies the epilogue (LSTM cell, bias,
//   tanh, coupling) itself; the epilogue's operands are loaded with the
//   stage's inputs, so their round trip overlaps it.
// - The recurrent halves W_hh . h(t - 1) of the three LSTMs (3 x 16.8 MB,
//   half of a frame) depend only on state already known, so they leave
//   the dependent chain: the attention LSTM's runs in the attention stage
//   (after h_att(t) is known, for frame t + 1), decoder layer 0's in the
//   query stage, the other layers' in the attention-LSTM stage, and their
//   sums wait in scratch until the cell. The stages then stream about att
//   18.1 MB, query 19.4, attention 17, LSTM 0 27.3, LSTM 1 16.8, dense
//   4.2 + 4.2, head 0.65. The packed LSTM halves are separate matrices,
//   so a block's rows of a job are one contiguous range.
// - Weights never depend on the frame: once a block has read its rows of
//   stage s, thread 0 starts one bulk (TMA) copy a job of its rows of
//   stage s + 1 into shared memory (all that fits, ~210 KB at B = 1), on
//   an mbarrier, right after arriving at the barrier; the transfer
//   overlaps the barrier and the next stage's staging. Rows that do not
//   fit (part of LSTM 0 at B = 8) are read from HBM.
// - Attention is spread over the blocks in slots (row b, key range j,
//   channel slice c): each slot computes its keys' scores, a local max
//   and exp sum, and its channels of the unnormalised partial context.
//   The next stage, which stages [h_att ; ctx] for decoder layer 0
//   anyway, combines the partials in a fixed order into ctx, the
//   normalised attention row and (block 0) the gate, with no barrier of
//   their own. Partials a row: 16 at B = 1, fewer for more rows, since
//   every block reads them all.
// - Up to 8 batch rows share one pass over the weights; more rows loop
//   over groups of 8 inside each stage.
// - No floating-point atomics: every sum has one owner and a fixed order,
//   so two calls give bitwise-equal outputs.
// - Early exit: block 0 sets a stream's done flag in the stage that
//   computes the gate (gate fired, or t + 1 >= n_valid_in). At the start
//   of each frame every block reads the flags; once all are set, the
//   blocks write mel = 0, attn = 0, gate = 1 for the remaining frames and
//   return together (decoder_pallas.py:216-223 does the same per chunk;
//   here the granularity is one frame).
// - Code size matters: a frame runs every stage's code once, so the
//   instruction cache is cold for each; the helpers that run once a stage
//   are not inlined and one loop serves every stage's quads.
//
// The fp32 body keeps no weight resident in shared memory across frames
// (the buffer is the prefetch's), and its math is plain SIMT fp32.
//
// The bf16 body (fused_flow_infer_launch's bf16 flag; the body the Pallas
// kernel runs when the JAX server casts the params with --bf16, "compute
// dtype (bf16 in serving)" at decoder_pallas.py:267) runs on the K1 pack
// (ops/decoder.py:k1_pack), k_proj and vals bf16. State, softmax, gate and
// the affine inversion stay fp32, as in the Pallas body. Activations are
// rounded to bf16 where that body casts them: every dot's input when it is
// staged (:121, :136, :141, :160, :171, :177, :180), q + k_proj and its
// tanh (:145-146), and the context attn . vals (:154-155), summed in fp32
// over the partials and rounded once. A flagship flow's bf16 matrices
// (53.7 MB) are half of the fp32 ones, and 132 SMs hold 30 MB of shared
// memory, so this body keeps what fits on chip, as the Pallas kernel keeps
// every weight in VMEM for the whole scan (decoder_pallas.py:269-279):
// - the K1 pack: every job's rows padded to 64 bytes (one stretch of k,
//   below), then to an odd multiple of 64 bytes (wstride: a quarter-warp's
//   16-byte loads of two neighbouring rows then fill the 32 banks once),
//   laid out by ops/decoder.py:k1_resident_layout: each block's resident
//   rows, then each block's streamed rows stage by stage, so that a flow's
//   streamed rows are one contiguous range;
// - residency (ops/decoder.py:k1_resident_plan): of each block's quads
//   of every stage the first ones stay in its shared memory for the whole
//   launch, copied in once by one bulk copy at its start, on the
//   prefetch's mbarrier with the first stage's ring; the stages that would
//   stream the most give up rows first, until every stage streams at most
//   the same bytes, which the ring holds. The budget is what the staged
//   inputs leave at min(B, 8) rows, so a flow holds one K1 pack for each
//   layout that its launches' B need (ops/decoder.py:k1_pack_for; one plan
//   at 8 rows for every B ran B=1 7% slower on the H100);
// - the rest of a stage's rows are bulk-copied into that ring while the
//   block waits at the barrier before the stage, as the fp32 body's
//   prefetch; rows past the ring (widths that leave no room) are read from
//   the pack in the dot. (An L2 access-policy window of persisting hits
//   over the streamed range, released after each launch, was timed on the
//   H100 in turns and taken out: within 1% either way, and the fp32 body
//   ran 1.3% slower beside it; PERF.md section 6);
// - the dots on the tensor cores, as P4's chains (csrc/resident.cu):
//   mma.sync m16n8k16, bf16 in, fp32 out, the weight rows in A (an m-tile
//   is four quads of one job), up to 8 staged batch rows in B. For each
//   64-byte stretch of k a lane loads 16 bytes of its weight rows g = lane
//   / 4 and g + 8 and of staged row g at 16 (lane % 4): the mma's k order
//   is a permutation of those bytes, the same for A and B. Each mma sums
//   its 16 exact products from zero, and rounded fp32 adds take them into
//   one of four chains (stretch j into chain j % 4), summed in order; ks
//   warps split an m-tile's stretches when a block has fewer m-tiles than
//   warps, and their sums meet in shared memory in a fixed order. The
//   epilogues stay with the quads' owners: one lane a (quad, batch row).
//   The staged inputs are bf16 rows of the same stride.
// The grid barrier, the stage list, k1_plan's split, the attention slots
// and partials and early exit are the fp32 body's; a slot keeps kSlot16
// scores in shared memory at every Tk, so that the plan does not depend on
// the text, and a longer slot's scores live in global memory (slot_sc).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;          // batch rows per pass over the weights
constexpr int kMaxLayers = 4;     // decoder LSTM layers
constexpr int kMaxDense = 4;      // dense layers
constexpr int kMaxJobs = kMaxLayers;   // the attention-LSTM stage's jobs
constexpr int kMaxStages = 4 + kMaxLayers + kMaxDense;
constexpr int kMaxParts = 16;     // attention partials (ops/decoder.py)
constexpr float kMaskValue = -1e9f;

constexpr int kStretch = 64;      // bf16: bytes of k a lane quad loads
constexpr int kUnroll = 4;        // bf16: stretches a warp loads ahead
constexpr int kTab = 16;          // bf16: ints of the table a (stage, block)
constexpr int kStatic16 = 8192;   // bf16: bytes kept for static shared memory
constexpr int kSlot16 = 512;      // bf16: floats of a slot's scores kept in
                                  // shared memory (a longer slot's in
                                  // global memory, slot_sc)

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
// a weight row's length: fp32 4 elements (16 bytes); the bf16 body's K1
// pack 32 (one 64-byte stretch)
__host__ __device__ inline int padk(int n, bool bf) {
  return bf ? (n + 31) & ~31 : pad4(n);
}
// bf16: bytes between two rows of kp weights (a multiple of 32) in shared
// memory and in the K1 pack, an odd multiple of 64 (ops/decoder.py:
// _k1_row_bytes)
__host__ __device__ inline int wstride(int kp) {
  return (2 * kp) & 127 ? 2 * kp : 2 * kp + 64;
}

// x rounded to bf16 (nearest even), as fp32
__device__ __forceinline__ float rnd_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// a read-only weight or projection, through the read-only cache, as fp32
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

// what a job's epilogue does with its row quads
enum Kind { kAttIH, kRec, kQuery, kIH, kDense, kHead };

struct Job {
  const void* w;       // fp32: (rows, Kp), rows padded to 16 bytes (padk)
  const float* bias;
  int Kp, rows, kind, layer;   // layer: LSTM (-1 = attention), dense
};

struct Stage {
  int n_jobs, attention;
  Job job[kMaxJobs];
};

struct Params {
  Stage st[kMaxStages];
  int n_stages;
  const int* bounds;   // (n_stages, kMaxJobs, grid + 1) quad boundaries
  const float *z, *mask, *v_w, *gate_w, *gate_b;
  const void *kp, *vals;      // (B, Tk, D) of the weights' type
  const int* nvin;
  float *mel, *attn, *gates;
  float *h_att, *c_att, *q, *scores, *pm, *ps, *pc;
  float* slot_sc;   // bf16, a slot past kSlot16 keys: (grid, gslot) scores
  float* h[kMaxLayers];
  float* c[kMaxLayers];
  float* rec[kMaxLayers + 1];   // (B, 4H): [0] attention LSTM, [1 + l]
  float* y[2];                  // dense outputs, ping-pong
  int* done;
  unsigned* bar;
  long long* clock;   // or null: block 0's globaltimer after each stage
  int N, B, M, H, D, Tk, n_layers, n_dense, parts, grid, early_exit;
  int slices;           // channel slices of each attention partial
  int rows;             // batch rows a pass: min(B, kMaxB)
  int Dp, kslot, xs_floats;   // kslot: the slot's floats in shared memory
  int gslot;                  // bf16: a slot's keys, padded (slot_sc)
  int wbuf_off, wcap;   // the prefetch buffer: offset, capacity (floats);
                        // bf16: the resident rows' offset
  float temperature, threshold;
  const unsigned char* pack;   // bf16: the K1 pack
  const int* tab;              // bf16: (n_stages, grid, kTab) where rows lie
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// dst[b * Kp + off + k] = src[b * ld + k] for k < n, 0 for n <= k < npad;
// src == nullptr stages zeros. Activations are written by other blocks of
// this launch, so they are read through L2 (__ldcg), kLoads a thread in
// flight. kRound: rounded to bf16 (the bf16 body's dot inputs).
constexpr int kLoads = 8;
template <bool kRound>
__device__ void stage_rows(float* dst, int Kp, int off, const float* src,
                           int ld, int n, int npad, int nb) {
  const int total = nb * npad;
  for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      const int b = i / npad, k = i - b * npad;
      v[u] = (i < total && src != nullptr && k < n)
                 ? __ldcg(src + (size_t)b * ld + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      const int b = i / npad, k = i - b * npad;
      if (i < total) dst[b * Kp + off + k] = kRound ? rnd_bf16(v[u]) : v[u];
    }
  }
}

// bf16 rows: dst[b * ldx + k] = src[b * ld + k] rounded to bf16 for k <
// n, 0 for n <= k < npad; src == nullptr stages zeros. As stage_rows.
__device__ void stage_rows_bf(__nv_bfloat16* dst, int ldx, const float* src,
                              int ld, int n, int npad, int nb) {
  const int total = nb * npad;
  for (int i0 = threadIdx.x; i0 < total; i0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      const int b = i / npad, k = i - b * npad;
      v[u] = (i < total && src != nullptr && k < n)
                 ? __ldcg(src + (size_t)b * ld + k) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * blockDim.x;
      const int b = i / npad, k = i - b * npad;
      if (i < total) dst[b * ldx + k] = __float2bfloat16_rn(v[u]);
    }
  }
}

// One warp: acc[r][b] = sum over 16-byte columns [i0, i1) (4 weights
// each) of W[r * Kp + .] . xs[b * Kp + .], for r < 4, b < nb; every lane
// gets the sums. W is in shared memory (the prefetch buffer) or in HBM.
// Rows r >= nrows (a ragged last quad) read row nrows - 1, and the caller
// drops their sums. Two 16-byte pieces of each row in flight a lane.
__device__ __forceinline__ float dot4(float a, float4 w, float4 x) {
  a = fmaf(w.x, x.x, a);
  a = fmaf(w.y, x.y, a);
  a = fmaf(w.z, x.z, a);
  return fmaf(w.w, x.w, a);
}

template <int NB>
__device__ __forceinline__ void quad_dot(const float* W, int nrows, int Kp,
                                         int i0, int i1, const float* xs,
                                         int nb, float (&acc)[4][NB]) {
  const int lane = threadIdx.x & 31;
  const int K4 = Kp >> 2;
  const float4* WV = reinterpret_cast<const float4*>(W);
  const float4* x4 = reinterpret_cast<const float4*>(xs);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;
  for (int i = i0 + lane; i < i1; i += 64) {
    const bool two = i + 32 < i1;
    const int i2 = two ? i + 32 : i;
    float4 w0[4], w1[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4* row = WV + (size_t)min(r, nrows - 1) * K4;
      w0[r] = row[i];
      if (two) {
        w1[r] = row[i2];
      } else {
        float4 z = {};
        w1[r] = z;
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b < nb) {
        const float4 x0 = x4[b * K4 + i], x1 = x4[b * K4 + i2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[r][b] = dot4(dot4(acc[r][b], w0[r], x0), w1[r], x1);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nb) acc[r][b] = warp_sum(acc[r][b]);
}

// acc[r][lane] without dynamic register indexing.
template <int NB>
__device__ __forceinline__ float pick(const float (&acc)[4][NB], int r,
                                      int lane) {
  float v = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if (b == lane) v = acc[r][b];
  return v;
}

// The quad's sums for lanes < nb: y[r] of batch row lane. One batch row
// (B = 1, the single caller's case) and up to four have their own smaller
// bodies: a frame runs every stage's code once, so the instruction cache
// is cold each time and code size costs time.
__device__ __forceinline__ void quad_sums(const float* W, int nrows, int Kp,
                                          int i0, int i1, const float* xs,
                                          int nb, float (&y)[4]) {
  const int lane = threadIdx.x & 31;
  if (nb == 1) {
    float acc[4][1];
    quad_dot<1>(W, nrows, Kp, i0, i1, xs, nb, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) y[r] = acc[r][0];
  } else if (nb <= 4) {
    float acc[4][4];
    quad_dot<4>(W, nrows, Kp, i0, i1, xs, nb, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) y[r] = pick(acc, r, lane);
  } else {
    float acc[4][kMaxB];
    quad_dot<kMaxB>(W, nrows, Kp, i0, i1, xs, nb, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) y[r] = pick(acc, r, lane);
  }
}

// bf16: c += the two mma tiles of one 64-byte stretch: a and b hold 16
// bytes of weight rows g and g + 8, x 16 bytes of staged row g (lane g,
// t), the same bytes of k in the same order. Each tile's 16 products are
// summed from zero by the tensor cores and added to c by rounded fp32 adds
// (as csrc/resident.cu:mma_stretch).
__device__ __forceinline__ void mma_stretch(float (&c)[4], uint4 a, uint4 b,
                                            uint4 x) {
  const uint32_t f0[4] = {a.x, b.x, a.y, b.y}, f1[4] = {a.z, b.z, a.w, b.w};
  float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(p0, f0, x.x, x.y);
  mma_bf16(p1, f1, x.z, x.w);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(__fadd_rn(c[e], p0[e]), p1[e]);
}

// bf16: one warp's part of an m-tile's dot: stretches s0, s0 + step, ...
// < s1 of weight rows wa, wb and staged row xr (each already at the lane's
// 16 bytes), stretch j of the part into chain j % kUnroll, the chains
// summed in order into c: c[0], c[1] row g, batch rows 2t, 2t + 1; c[2],
// c[3] row g + 8. The rows lie in shared memory or in the pack.
__device__ __forceinline__ void mma_range(float (&c)[4],
                                          const unsigned char* wa,
                                          const unsigned char* wb,
                                          const unsigned char* xr, int s0,
                                          int s1, int step) {
  float acc[kUnroll][4] = {};
  int s = s0;
  for (; s + (kUnroll - 1) * step < s1; s += kUnroll * step) {
    uint4 a[kUnroll], b[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int off = kStretch * (s + u * step);
      a[u] = *reinterpret_cast<const uint4*>(wa + off);
      b[u] = *reinterpret_cast<const uint4*>(wb + off);
      x[u] = *reinterpret_cast<const uint4*>(xr + off);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mma_stretch(acc[u], a[u], b[u], x[u]);
  }
#pragma unroll
  for (int u = 0; u + 1 < kUnroll; ++u, s += step)
    if (s < s1) {
      const int off = kStretch * s;
      mma_stretch(acc[u], *reinterpret_cast<const uint4*>(wa + off),
                  *reinterpret_cast<const uint4*>(wb + off),
                  *reinterpret_cast<const uint4*>(xr + off));
    }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    c[e] = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][e], acc[1][e]), acc[2][e]),
                     acc[3][e]);
}

struct In {
  const float* src;   // (B, ld) rows; nullptr stages zeros
  int ld, n;
};

// What a job's rows are dotted with at frame t (decoder layer 0 also
// takes the context behind h_att, which combine adds).
__device__ In job_input(const Params& p, const Job& j, int t) {
  switch (j.kind) {
    case kAttIH:
      return {t ? p.mel + (size_t)(t - 1) * p.B * p.M : nullptr, p.M, p.M};
    case kRec:
      return {j.layer < 0 ? p.h_att : p.h[j.layer], p.H, p.H};
    case kQuery:
      return {p.h_att, p.H, p.H};
    case kIH:
      return {j.layer ? p.h[j.layer - 1] : p.h_att, p.H, p.H};
    case kDense:
      return {j.layer ? p.y[(j.layer - 1) & 1] : p.h[p.n_layers - 1], p.H,
              p.H};
    default:   // kHead
      return {p.n_dense ? p.y[(p.n_dense - 1) & 1] : p.h[p.n_layers - 1],
              p.H, p.H};
  }
}

// The operands of a quad's epilogue besides its sums, loaded before its
// dot so that their round trip overlaps it.
struct Ops {
  float bias[4], rec[4], c, z[2];
};

__device__ void epi_load(const Params& p, const Job& j, int u, int row,
                         int t, Ops& o) {
  const int H = p.H;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o.bias[i] = j.bias != nullptr && 4 * u + i < j.rows
                    ? __ldg(j.bias + 4 * u + i) : 0.f;
  if (j.kind == kAttIH || j.kind == kIH) {
    const bool att = j.kind == kAttIH;
    const float* rec =
        p.rec[att ? 0 : 1 + j.layer] + (size_t)row * 4 * H + 4 * u;
#pragma unroll
    for (int i = 0; i < 4; ++i) o.rec[i] = __ldcg(rec + i);
    o.c = __ldcg((att ? p.c_att : p.c[j.layer]) + (size_t)row * H + u);
  } else if (j.kind == kHead) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      o.z[k] = 2 * u + k < p.M
                   ? p.z[((size_t)t * p.B + row) * p.M + 2 * u + k] : 0.f;
  }
}

// Quad u of job j for batch row `row`: y[r] = its rows' sums.
__device__ void epi_apply(const Params& p, const Job& j, int u, int row,
                          const float (&y)[4], const Ops& o, int t) {
  const int H = p.H;
  switch (j.kind) {
    case kAttIH:
    case kIH: {   // the LSTM cell of unit u, gates (i, f, g, o)
      const bool att = j.kind == kAttIH;
      float g[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = (y[i] + o.rec[i]) + o.bias[i];
      const size_t k = (size_t)row * H + u;
      const float c_new = sigmoid(g[1]) * o.c + sigmoid(g[0]) * tanhf(g[2]);
      (att ? p.c_att : p.c[j.layer])[k] = c_new;
      (att ? p.h_att : p.h[j.layer])[k] = sigmoid(g[3]) * tanhf(c_new);
      break;
    }
    case kRec:
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p.rec[j.layer + 1][(size_t)row * 4 * H + 4 * u + i] = y[i];
      break;
    case kQuery:
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * u + i < j.rows)
          p.q[(size_t)row * p.D + 4 * u + i] = y[i] + o.bias[i];
      break;
    case kDense:
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * u + i < j.rows)
          p.y[j.layer & 1][(size_t)row * H + 4 * u + i] =
              tanhf(y[i] + o.bias[i]);
      break;
    default:   // kHead: rows (2m, 2m + 1) = (log_s_m, b_m)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int m = 2 * u + k;
        if (m >= p.M) break;
        const float log_s = y[2 * k] + o.bias[2 * k];
        const float bb = y[2 * k + 1] + o.bias[2 * k + 1];
        p.mel[((size_t)t * p.B + row) * p.M + m] = (o.z[k] - bb) * expf(-log_s);
      }
  }
}

// Shared memory beside the prefetch buffer (floats, in this order; the
// host sizes it in k1_fixed_floats).
struct Smem {
  float *xs, *qs, *sc, *cw, *ms, *vw, *gw, *wb;
};

__device__ Smem smem_map(const Params& p, float* sm) {
  Smem m;
  m.xs = sm;
  m.qs = m.xs + p.xs_floats;
  m.sc = m.qs + p.Dp;
  m.cw = m.sc + p.kslot;
  m.ms = m.cw + 2 * kMaxB * kMaxParts;
  m.vw = m.ms + 2 * kMaxB;
  m.gw = m.vw + p.Dp;
  m.wb = sm + p.wbuf_off;
  return m;
}

// This block's attention slots, round robin over the B x parts x slices
// of them: slot (b, j, c) takes keys [j Tk / parts, (j + 1) Tk / parts)
// of row b, all their scores, and channels [c D / slices, (c + 1) D /
// slices) of the unnormalised partial context. The c = 0 slot writes the
// scores, their max and the sum of their exps. bf16 (TW): k_proj and vals
// bf16, q + k and its tanh rounded to bf16, as the Pallas body's.
template <typename TW>
__device__ __noinline__ void attention(const Params& p, const Smem& m) {
  constexpr bool kBF = sizeof(TW) == 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = p.D, Tk = p.Tk, B = p.B;
  const int per_row = p.parts * p.slices;
  float* sc = m.sc;
  if constexpr (kBF)   // a text too long for the slot kept in shared memory
    if (p.slot_sc != nullptr) sc = p.slot_sc + (size_t)blockIdx.x * p.gslot;
  for (int sl = blockIdx.x; sl < B * per_row; sl += p.grid) {
    const int b = sl / per_row, j = (sl / p.slices) % p.parts;
    const int c = sl % p.slices;
    const int k0 = j * Tk / p.parts, nk = (j + 1) * Tk / p.parts - k0;
    stage_rows<kBF>(m.qs, D, 0, p.q + (size_t)b * D, D, D, D, 1);
    __syncthreads();
    for (int kk = warp; kk < nk; kk += kWarps) {
      const size_t bk = (size_t)b * Tk + k0 + kk;
      const TW* krow = static_cast<const TW*>(p.kp) + bk * D;
      float s = 0.f;
#pragma unroll 20
      for (int d = lane; d < D; d += 32) {
        if constexpr (kBF)
          s += m.vw[d] * rnd_bf16(tanhf(rnd_bf16(m.qs[d]
                                                 + ldg_f32(krow + d))));
        else
          s += m.vw[d] * tanhf(m.qs[d] + ldg_f32(krow + d));
      }
      s = warp_sum(s);
      if (lane == 0) {
        s = s / p.temperature;
        s = __ldg(p.mask + bk) > 0.5f ? s : kMaskValue;
        sc[kk] = s;
        if (c == 0) p.scores[bk] = s;
      }
    }
    __syncthreads();
    if (warp == 0) {
      float mx = -INFINITY;
      for (int k = lane; k < nk; k += 32) mx = fmaxf(mx, sc[k]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int k = lane; k < nk; k += 32) {
        const float e = expf(sc[k] - mx);
        sc[k] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0 && c == 0) {
        p.pm[(size_t)j * B + b] = mx;
        p.ps[(size_t)j * B + b] = sum;
      }
    }
    __syncthreads();
    const int d1 = (c + 1) * D / p.slices;
    for (int d = c * D / p.slices + threadIdx.x; d < d1; d += blockDim.x) {
      const TW* v = static_cast<const TW*>(p.vals) + ((size_t)b * Tk + k0) * D
                    + d;
      float acc = 0.f;
#pragma unroll 8
      for (int k = 0; k < nk; ++k) acc += sc[k] * ldg_f32(v + (size_t)k * D);
      p.pc[((size_t)j * B + b) * D + d] = acc;
    }
    __syncthreads();   // qs and sc are free again
  }
}

// Decoder layer 0's stage, before its quads: the partials' max and exp
// sums combined (ms) into the weights cw = exp(m_j - max) / sum, this
// block's share of the attention row, the context behind the staged
// h_att (when this block needs the input: row b at xs[b * ldx], Kp
// columns; bf16 rows in the bf16 body) and (block 0) the gate and the
// done flags.
template <typename TX>
__device__ __noinline__ void combine(const Params& p, int t, int g0, int nb,
                                     TX* xs, int ldx, int Kp,
                                     bool need_input, const Smem& m) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int H = p.H, D = p.D, Tk = p.Tk, B = p.B, P = p.parts;
  float* cw = m.cw;            // (nb, kMaxParts): max, then weights
  float* cs = cw + kMaxB * kMaxParts;   // (nb, kMaxParts): scaled sums
  float* ms = m.ms;            // (nb, 2): max, sum
  const bool owner = threadIdx.x < nb * P;   // partial (b, j) of the group
  const int ob = threadIdx.x / P, oj = threadIdx.x % P;
  // one round trip: this thread's first score of the attention row and,
  // for the owners, their partial's max and exp sum
  const int e0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int stride = p.grid * blockDim.x;
  const float s0 =
      e0 < nb * Tk ? __ldcg(p.scores + (size_t)g0 * Tk + e0) : 0.f;
  float mj = 0.f, sj = 0.f;
  if (owner) {
    mj = __ldcg(p.pm + (size_t)oj * B + g0 + ob);
    sj = __ldcg(p.ps + (size_t)oj * B + g0 + ob);
    cw[ob * kMaxParts + oj] = mj;
  }
  __syncthreads();
  if (threadIdx.x < nb) {
    float mx = -INFINITY;
    for (int j = 0; j < P; ++j) mx = fmaxf(mx, cw[threadIdx.x * kMaxParts + j]);
    ms[2 * threadIdx.x] = mx;
  }
  __syncthreads();
  const float wgt = owner ? expf(mj - ms[2 * ob]) : 0.f;
  if (owner) cs[ob * kMaxParts + oj] = sj * wgt;
  __syncthreads();
  if (threadIdx.x < nb) {
    float s = 0.f;
    for (int j = 0; j < P; ++j) s += cs[threadIdx.x * kMaxParts + j];
    ms[2 * threadIdx.x + 1] = s;
  }
  __syncthreads();
  if (owner) cw[ob * kMaxParts + oj] = wgt / ms[2 * ob + 1];
  for (int e = e0; e < nb * Tk; e += stride) {
    const int b = e / Tk;
    const float s = e == e0 ? s0 : __ldcg(p.scores + (size_t)g0 * Tk + e);
    p.attn[((size_t)t * B + g0) * Tk + e] =
        expf(s - ms[2 * b]) / ms[2 * b + 1];
  }
  __syncthreads();   // cw is final
  if (need_input) {
    const int w = Kp - H;
    for (int e = threadIdx.x; e < nb * w; e += blockDim.x) {
      const int b = e / w, d = e - b * w;
      float c[kMaxParts];   // every partial's channel d at once
#pragma unroll
      for (int j = 0; j < kMaxParts; ++j)
        c[j] = j < P && d < D
                   ? __ldcg(p.pc + ((size_t)j * B + g0 + b) * D + d) : 0.f;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxParts; ++j)
        if (j < P) v += cw[b * kMaxParts + j] * c[j];
      if constexpr (sizeof(TX) == 2)
        xs[b * ldx + H + d] = __float2bfloat16_rn(v);
      else
        xs[b * ldx + H + d] = v;
    }
  }
  if (blockIdx.x != 0) return;
  __syncthreads();   // the context is staged
  for (int b = warp; b < nb; b += kWarps) {
    float gate = 0.f;
    if (p.gate_w != nullptr) {
      float g = 0.f;
      for (int k = lane; k < H + D; k += 32)
        g += m.gw[k] * to_f32(xs[b * ldx + k]);
      gate = sigmoid(warp_sum(g) + p.gate_b[0]);
    }
    if (lane == 0) {
      p.gates[(size_t)t * B + g0 + b] = gate;
      if (p.early_exit &&
          (gate > p.threshold || t + 1 >= p.nvin[g0 + b]))
        p.done[g0 + b] = 1;
    }
  }
}

// This block's quads of a stage: a range of each job (k1_plan), numbered
// on locally; the first pre[j] of job j are prefetched into the buffer at
// base[j] (floats), 4 Kp weights a quad, greedily in job order. Computed
// once a launch into shared memory.
struct Quads {
  int lo[kMaxJobs], cnt[kMaxJobs + 1], pre[kMaxJobs], base[kMaxJobs];
};

__device__ __noinline__ void block_quads(const Params& p, int si, Quads& q) {
  const Stage& s = p.st[si];
  const int* bnd = p.bounds + si * kMaxJobs * (p.grid + 1);
  q.cnt[0] = 0;
  int used = 0;
  for (int j = 0; j < s.n_jobs; ++j) {
    const int* bj = bnd + j * (p.grid + 1);
    q.lo[j] = bj[blockIdx.x];
    const int n = bj[blockIdx.x + 1] - q.lo[j];
    const int per = 4 * s.job[j].Kp;   // floats a quad
    q.cnt[j + 1] = q.cnt[j] + n;
    q.pre[j] = max(0, min(n, (p.wcap - used) / per));
    q.base[j] = used;
    used += q.pre[j] * per;
  }
}

// Start copying this block's prefetched rows of a stage into the buffer:
// one bulk (TMA) copy a job (its rows are one contiguous range), issued by
// thread 0, completing on *bar. The weights never depend on the frame, so
// this runs before the barrier that the stage waits for, and no thread
// waits on the copies until the stage reads them.
__device__ __noinline__ void prefetch(const Stage& s, const Quads& q,
                                      float* wb, uint64_t* bar) {
  if (threadIdx.x != 0) return;
  unsigned bytes = 0;
  for (int j = 0; j < s.n_jobs; ++j)
    bytes += 4u * max(0, min(4 * (q.lo[j] + q.pre[j]), s.job[j].rows)
                             - 4 * q.lo[j]) * s.job[j].Kp;
  mbar_expect(bar, bytes);
  for (int j = 0; j < s.n_jobs; ++j) {
    const Job& jb = s.job[j];
    const unsigned n = 4u * max(0, min(4 * (q.lo[j] + q.pre[j]), jb.rows)
                                       - 4 * q.lo[j]) * jb.Kp;
    if (n)
      bulk_copy(wb + q.base[j],
                static_cast<const float*>(jb.w) + (size_t)4 * q.lo[j] * jb.Kp,
                n, bar);
  }
}

__device__ void run_stage(const Params& p, int si, const Quads& q, int t,
                          const Smem& m, float (*red)[4][kMaxB],
                          uint64_t* bar, unsigned& phase) {
  const Stage& s = p.st[si];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int xoff[kMaxJobs];
  for (int j = 0, xo = 0; j < s.n_jobs; ++j) {
    xoff[j] = xo;
    xo += p.rows * s.job[j].Kp;
  }
  const int nq = q.cnt[s.n_jobs];
  const bool ih0 = s.job[0].kind == kIH && s.job[0].layer == 0;
  const int ks = (nq >= kWarps || nq == 0) ? 1 : kWarps / nq;
  if (s.attention) attention<float>(p, m);

  // ks warps take each quad, splitting its k (ks > 1 when the block has
  // fewer quads than warps), kWarps / ks quads a round; the first of the
  // ks sums the parts in order and applies the epilogue
  const int per_round = kWarps / ks, qi = warp / ks, part = warp - qi * ks;
  for (int g0 = 0; g0 < p.B; g0 += kMaxB) {
    const int nb = min(kMaxB, p.B - g0);
    // the epilogue operands of this warp's first quad, in flight with
    // the staged inputs
    Ops o;
    if (qi < nq && part == 0 && lane < nb) {
      int j = 0;
      while (qi >= q.cnt[j + 1]) ++j;
      epi_load(p, s.job[j], q.lo[j] + qi - q.cnt[j], g0 + lane, t, o);
    }
    bool staged0 = false;
    for (int j = 0; j < s.n_jobs; ++j) {
      const Job& jb = s.job[j];
      if (q.cnt[j + 1] == q.cnt[j] && !(ih0 && j == 0 && blockIdx.x == 0))
        continue;
      if (j == 0) staged0 = true;
      const In in = job_input(p, jb, t);
      stage_rows<false>(m.xs + xoff[j], jb.Kp, 0,
                        in.src ? in.src + (size_t)g0 * in.ld : nullptr,
                        in.ld, in.n, ih0 && j == 0 ? p.H : jb.Kp, nb);
    }
    if (ih0)
      combine<float>(p, t, g0, nb, m.xs, s.job[0].Kp, s.job[0].Kp, staged0,
                     m);
    if (g0 == 0) {        // this stage's prefetched rows
      mbar_wait(bar, phase & 1);
      ++phase;
    }
    __syncthreads();

    for (int r0 = 0; r0 < nq; r0 += per_round) {
      const int qq = r0 + qi;
      const bool active = qq < nq;
      int j = 0, u = 0;
      float y[4];
      if (active) {
        while (qq >= q.cnt[j + 1]) ++j;
        const Job& jb = s.job[j];
        const int l = qq - q.cnt[j];
        const int KV = jb.Kp / 4;   // 16-byte columns
        u = q.lo[j] + l;
        if (r0 > 0 && part == 0 && lane < nb)
          epi_load(p, jb, u, g0 + lane, t, o);
        quad_sums(l < q.pre[j]
                      ? m.wb + q.base[j] + (size_t)l * 4 * jb.Kp
                      : static_cast<const float*>(jb.w)
                            + (size_t)4 * u * jb.Kp,
                  min(4, jb.rows - 4 * u), jb.Kp, part * KV / ks,
                  (part + 1) * KV / ks, m.xs + xoff[j], nb, y);
        if (ks > 1 && lane < nb)
#pragma unroll
          for (int r = 0; r < 4; ++r) red[warp][r][lane] = y[r];
      }
      if (ks > 1) {
        __syncthreads();
        if (active && part == 0 && lane < nb)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            y[r] = red[warp][r][lane];
            for (int pp = 1; pp < ks; ++pp) y[r] += red[warp + pp][r][lane];
          }
      }
      if (active && part == 0 && lane < nb)
        epi_apply(p, s.job[j], u, g0 + lane, y, o, t);
    }
    __syncthreads();   // the staged rows and red are free again
  }
}

// bf16: this block's quads of a stage and where their rows lie (the
// table of ops/decoder.py:k1_resident_layout): of job j's range from quad
// lo[j], the first nres[j] in the resident rows at byte roff[j], the rest
// from byte soff[j] of the stage's streamed range, which begins at byte
// sbase of the pack and whose first `ring` bytes are copied into the
// ring; mt[j] the m-tiles (four quads) before job j.
struct QuadsBF {
  int lo[kMaxJobs], cnt[kMaxJobs + 1], mt[kMaxJobs + 1];
  int nres[kMaxJobs], roff[kMaxJobs], soff[kMaxJobs];
  int sbase, ring;
};

__device__ __noinline__ void block_quads_bf(const Params& p, int si,
                                            QuadsBF& q) {
  const Stage& s = p.st[si];
  const int* bnd = p.bounds + si * kMaxJobs * (p.grid + 1);
  const int* tb = p.tab + ((size_t)si * p.grid + blockIdx.x) * kTab;
  q.cnt[0] = q.mt[0] = 0;
  for (int j = 0; j < s.n_jobs; ++j) {
    const int* bj = bnd + j * (p.grid + 1);
    q.lo[j] = bj[blockIdx.x];
    const int n = bj[blockIdx.x + 1] - q.lo[j];
    q.cnt[j + 1] = q.cnt[j] + n;
    q.mt[j + 1] = q.mt[j] + (n + 3) / 4;
    q.nres[j] = tb[j];
    q.roff[j] = tb[4 + j];
    q.soff[j] = tb[8 + j];
  }
  q.sbase = tb[12];
  q.ring = tb[13];
}

// bf16: copy the first bytes of this block's streamed rows of a stage
// into the ring (one bulk copy, thread 0), and with `res` bytes of
// resident rows at launch, on one phase of *bar.
__device__ __noinline__ void prefetch_bf(const Params& p, const QuadsBF& q,
                                         unsigned char* ring, uint64_t* bar,
                                         unsigned char* res, int res_off,
                                         int res_bytes) {
  if (threadIdx.x != 0) return;
  mbar_expect(bar, (unsigned)(q.ring + res_bytes));
  if (res_bytes) bulk_copy(res, p.pack + res_off, res_bytes, bar);
  if (q.ring) bulk_copy(ring, p.pack + q.sbase, q.ring, bar);
}

// bf16: row r of quad l of job j (the block's numbering), where it lies.
__device__ __forceinline__ const unsigned char* row_at(
    const Params& p, const QuadsBF& q, int j, int l, int r, int ws,
    const unsigned char* res, const unsigned char* ring) {
  if (l < q.nres[j]) return res + q.roff[j] + (4 * l + r) * ws;
  const int off = q.soff[j] + (4 * (l - q.nres[j]) + r) * ws;
  return off < q.ring ? ring + off : p.pack + q.sbase + off;
}

// bf16: a stage on the tensor cores. The block's quads of each job form
// m-tiles of four; ks warps split an m-tile's stretches when the block has
// fewer m-tiles than warps. After the products one lane a (quad, batch
// row) of the m-tile's first warp sums the parts in order and applies the
// epilogue.
__device__ void run_stage_bf(const Params& p, int si, const QuadsBF& q,
                             int t, const Smem& m, float (*red)[16][kMaxB],
                             uint64_t* bar, unsigned& phase,
                             const unsigned char* res,
                             const unsigned char* ring) {
  const Stage& s = p.st[si];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // the mma's fragment lanes
  const int eq = lane >> 3, eb = lane & 7;  // the epilogue's quad, row
  unsigned char* xs = reinterpret_cast<unsigned char*>(m.xs);
  int xoff[kMaxJobs];
  for (int j = 0, xo = 0; j < s.n_jobs; ++j) {
    xoff[j] = xo;
    xo += p.rows * wstride(s.job[j].Kp);
  }
  const int nu = q.mt[s.n_jobs];
  const bool ih0 = s.job[0].kind == kIH && s.job[0].layer == 0;
  const int ks = (nu >= kWarps || nu == 0) ? 1 : kWarps / nu;
  if (s.attention) attention<__nv_bfloat16>(p, m);

  const int per_round = kWarps / ks, ui = warp / ks, part = warp - ui * ks;
  for (int g0 = 0; g0 < p.B; g0 += kMaxB) {
    const int nb = min(kMaxB, p.B - g0);
    Ops o;
    if (ui < nu && part == 0 && eb < nb) {
      int j = 0;
      while (ui >= q.mt[j + 1]) ++j;
      const int l = 4 * (ui - q.mt[j]) + eq;
      if (l < q.cnt[j + 1] - q.cnt[j])
        epi_load(p, s.job[j], q.lo[j] + l, g0 + eb, t, o);
    }
    bool staged0 = false;
    for (int j = 0; j < s.n_jobs; ++j) {
      const Job& jb = s.job[j];
      if (q.cnt[j + 1] == q.cnt[j] && !(ih0 && j == 0 && blockIdx.x == 0))
        continue;
      if (j == 0) staged0 = true;
      const In in = job_input(p, jb, t);
      stage_rows_bf(reinterpret_cast<__nv_bfloat16*>(xs + xoff[j]),
                    wstride(jb.Kp) / 2,
                    in.src ? in.src + (size_t)g0 * in.ld : nullptr, in.ld,
                    in.n, ih0 && j == 0 ? p.H : jb.Kp, nb);
    }
    if (ih0)
      combine<__nv_bfloat16>(
          p, t, g0, nb, reinterpret_cast<__nv_bfloat16*>(xs + xoff[0]),
          wstride(s.job[0].Kp) / 2, s.job[0].Kp, staged0, m);
    if (g0 == 0) {        // the ring (and at launch the resident rows)
      mbar_wait(bar, phase & 1);
      ++phase;
    }
    __syncthreads();

    for (int r0 = 0; r0 < nu; r0 += per_round) {
      const int uu = r0 + ui;
      const bool active = uu < nu;
      int j = 0, l0 = 0, n = 0;
      if (active) {
        while (uu >= q.mt[j + 1]) ++j;
        const Job& jb = s.job[j];
        const int ws = wstride(jb.Kp);
        n = q.cnt[j + 1] - q.cnt[j];
        l0 = 4 * (uu - q.mt[j]);
        if (r0 > 0 && part == 0 && eb < nb && l0 + eq < n)
          epi_load(p, jb, q.lo[j] + l0 + eq, g0 + eb, t, o);
        // rows g and g + 8 of the m-tile; a quad past the job's last reads
        // that one again (its sums are dropped), as does a batch row past
        // nb
        const unsigned char* wa =
            row_at(p, q, j, min(l0 + (g >> 2), n - 1), g & 3, ws, res, ring);
        const unsigned char* wb =
            row_at(p, q, j, min(l0 + 2 + (g >> 2), n - 1), g & 3, ws, res,
                   ring);
        const unsigned char* xr = xs + xoff[j] + min(g, nb - 1) * ws;
        float c[4];
        mma_range(c, wa + 16 * tq, wb + 16 * tq, xr + 16 * tq, part,
                  2 * jb.Kp / kStretch, ks);
        red[warp][g][2 * tq] = c[0];
        red[warp][g][2 * tq + 1] = c[1];
        red[warp][g + 8][2 * tq] = c[2];
        red[warp][g + 8][2 * tq + 1] = c[3];
      }
      if (ks > 1)
        __syncthreads();
      else
        __syncwarp();
      if (active && part == 0 && eb < nb && l0 + eq < n) {
        float y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          y[r] = red[warp][4 * eq + r][eb];
          for (int pp = 1; pp < ks; ++pp) y[r] += red[warp + pp][4 * eq + r][eb];
        }
        epi_apply(p, s.job[j], q.lo[j] + l0 + eq, g0 + eb, y, o, t);
      }
      __syncwarp();   // red[warp] is free again (ks > 1: one round)
    }
    __syncthreads();   // the staged rows and red are free again
  }
}

// Every stream finished before frame t: mel = 0, attn = 0, gate = 1 for
// frames t .. N - 1, split over the grid.
__device__ __noinline__ void zero_tail(const Params& p, int t) {
  const size_t stride = (size_t)p.grid * blockDim.x;
  const size_t first = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t rows = (size_t)(p.N - t) * p.B;
  for (size_t i = first; i < rows * p.M; i += stride)
    p.mel[(size_t)t * p.B * p.M + i] = 0.f;
  for (size_t i = first; i < rows * p.Tk; i += stride)
    p.attn[(size_t)t * p.B * p.Tk + i] = 0.f;
  for (size_t i = first; i < rows; i += stride)
    p.gates[(size_t)t * p.B + i] = 1.f;
}

// Both bodies' start: v_w, and on block 0 the gate row, into shared memory.
__device__ void load_vectors(const Params& p, const Smem& m) {
  for (int d = threadIdx.x; d < p.D; d += blockDim.x) m.vw[d] = p.v_w[d];
  if (blockIdx.x == 0 && p.gate_w != nullptr)
    for (int k = threadIdx.x; k < p.H + p.D; k += blockDim.x)
      m.gw[k] = p.gate_w[k];
}

// Every stream done before frame t (early exit): true once the block has
// written its share of the tail, the copies in flight landed first.
__device__ __forceinline__ bool finished(const Params& p, int t,
                                         uint64_t* bar, unsigned phase) {
  if (!p.early_exit || t == 0) return false;
  int all = 1;
  for (int b = 0; b < p.B; ++b) all &= __ldcg(p.done + b);
  if (!all) return false;
  mbar_wait(bar, phase & 1);
  zero_tail(p, t);
  return true;
}

__global__ void __launch_bounds__(kThreads, 1)
    k1_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kWarps][4][kMaxB];
  __shared__ uint64_t bar;
  __shared__ Quads sq[kMaxStages];
  const Smem m = smem_map(p, reinterpret_cast<float*>(smem4));
  if (threadIdx.x < p.n_stages) block_quads(p, threadIdx.x, sq[threadIdx.x]);
  if (threadIdx.x == 0) mbar_init(&bar);
  load_vectors(p, m);
  __syncthreads();
  unsigned passed = 0, phase = 0;
  prefetch(p.st[0], sq[0], m.wb, &bar);
  for (int t = 0; t < p.N; ++t) {
    if (finished(p, t, &bar, phase)) return;
    for (int s = 0; s < p.n_stages; ++s) {
      run_stage(p, s, sq[s], t, m, red, &bar, phase);
      barrier_arrive(p.bar);
      // the next stage's first rows, while this block waits for the others
      const int next = s + 1 < p.n_stages ? s + 1 : 0;
      if (s + 1 < p.n_stages || t + 1 < p.N)
        prefetch(p.st[next], sq[next], m.wb, &bar);
      barrier_wait(p.bar, ++passed * (unsigned)p.grid);
      if (p.clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        p.clock[(size_t)t * p.n_stages + s] = gtime();
    }
  }
}

// The bf16 body: the fp32 body's frame loop on resident rows, the ring and
// the tensor cores. The resident rows arrive once, with stage 0's ring,
// before the first frame; early exit waits for the copies in flight as the
// fp32 body does.
__global__ void __launch_bounds__(kThreads, 1)
    k1_bf16_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kWarps][16][kMaxB];
  __shared__ uint64_t bar;
  __shared__ QuadsBF sq[kMaxStages];
  const Smem m = smem_map(p, reinterpret_cast<float*>(smem4));
  const int* tb = p.tab + (size_t)blockIdx.x * kTab;   // stage 0's entry
  const int res_off = tb[14], res_bytes = tb[15];
  unsigned char* res = reinterpret_cast<unsigned char*>(m.wb);
  unsigned char* ring = res + res_bytes;
  if (threadIdx.x < p.n_stages)
    block_quads_bf(p, threadIdx.x, sq[threadIdx.x]);
  if (threadIdx.x == 0) mbar_init(&bar);
  load_vectors(p, m);
  __syncthreads();
  unsigned passed = 0, phase = 0;
  prefetch_bf(p, sq[0], ring, &bar, res, res_off, res_bytes);
  for (int t = 0; t < p.N; ++t) {
    if (finished(p, t, &bar, phase)) return;
    for (int s = 0; s < p.n_stages; ++s) {
      run_stage_bf(p, s, sq[s], t, m, red, &bar, phase, res, ring);
      barrier_arrive(p.bar);
      const int next = s + 1 < p.n_stages ? s + 1 : 0;
      if (s + 1 < p.n_stages || t + 1 < p.N)
        prefetch_bf(p, sq[next], ring, &bar, nullptr, 0, 0);
      barrier_wait(p.bar, ++passed * (unsigned)p.grid);
      if (p.clock != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
        p.clock[(size_t)t * p.n_stages + s] = gtime();
    }
  }
}

// `iters` grid barriers: mode 0 the kernel's own, 1 cooperative_groups'.
__global__ void __launch_bounds__(kThreads, 1)
    barrier_bench_kernel(unsigned* bar, int iters, int mode) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 1; i <= iters; ++i) {
    if (mode == 0) {
      barrier_arrive(bar);
      barrier_wait(bar, (unsigned)i * gridDim.x);
    }
    else
      grid.sync();
  }
}

// Shared memory floats beside the prefetch buffer: the widest stage's
// staged inputs (attention LSTM + recurrent halves of layers 1.., query +
// layer 0's, decoder layer 0), the attention slot's query row and
// scores, the combine's weights, scaled sums, max and sums, v_w and
// gate_w (Smem, smem_map). bf: the bf16 body's rows (padk).
// bf16: the staged rows are bf16 at wstride bytes a row, the slot keeps
// kSlot16 floats of its scores at every Tk (a longer slot's go to global
// memory, slot_sc), and the whole is rounded up to 128 bytes
// (ops/decoder.py:k1_fixed_bytes).
int k1_fixed_floats(int B, int M, int H, int D, int Tk, int n_layers,
                    int parts, bool bf) {
  const int Hp = padk(H, bf), Mp = padk(M, bf), Lp = padk(H + D, bf);
  const int slot = pad4((Tk + parts - 1) / parts);
  if (bf) {
    const int Hs = wstride(Hp), Ms = wstride(Mp), Ls = wstride(Lp);
    int w = Ms + (n_layers - 1) * Hs;
    w = w > 2 * Hs ? w : 2 * Hs;
    w = w > Ls ? w : Ls;
    const int f = (B < kMaxB ? B : kMaxB) * w / 4 + 2 * pad4(D) + kSlot16
                  + 2 * kMaxB * kMaxParts + 2 * kMaxB + pad4(H + D);
    return (f + 31) & ~31;
  }
  int w = Mp + (n_layers - 1) * Hp;
  w = w > 2 * Hp ? w : 2 * Hp;
  w = w > Lp ? w : Lp;
  return (B < kMaxB ? B : kMaxB) * w + pad4(D) + slot +
         2 * kMaxB * kMaxParts + 2 * kMaxB + pad4(D) + pad4(H + D);
}

int smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev))
    return -1;
  return optin;
}

// A block's dynamic shared memory: all that the card lets one block have
// beside the static red, bar and sq (fp32: the rest is the prefetch
// buffer; bf16: beside kStatic16 bytes, the resident rows and the ring).
int k1_smem_bytes(bool bf) {
  const int optin = smem_optin();
  if (optin < 0) return -1;
  static_assert(sizeof(float) * kWarps * 16 * kMaxB + 16
                    + sizeof(QuadsBF) * kMaxStages <= kStatic16,
                "the bf16 body's static shared memory");
  if (bf) return optin - kStatic16;
  const int fixed = (int)(sizeof(float) * kWarps * 4 * kMaxB + 16
                         + sizeof(Quads) * kMaxStages);   // red, bar, sq
  return (optin - fixed) & ~15;
}

int coresident_blocks(const void* kernel, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (smem < 0 || cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem))
    return -1;
  return per_sm * sms;
}

const void* k1_kernel_of(bool bf) {
  return bf ? (const void*)k1_bf16_kernel : (const void*)k1_kernel;
}

// bf16: a slot's keys when they pass the kSlot16 kept in shared memory
// (slot_sc in global memory), else 0.
int long_slot(bool bf, int Tk, int parts) {
  const int slot = pad4((Tk + parts - 1) / parts);
  return bf && slot > kSlot16 ? slot : 0;
}

// Floats of workspace (fp32 state, scores and partials; bf16 with a slot
// past kSlot16, every block's scores).
long long workspace_floats(int B, int H, int D, int Tk, int n_layers,
                           int parts, bool bf, int n_blocks) {
  return (long long)B * (2LL * H + D + Tk + 2LL * n_layers * H
                         + 4LL * (n_layers + 1) * H + 2LL * H
                         + (long long)parts * (2 + D))
         + (long long)n_blocks * long_slot(bf, Tk, parts);
}

// One flow's inverse scan (fused_flow_infer_launch below).
int run_flow(bool bf, const float* z, const void* kp, const void* vals,
             const float* key_mask, const int* n_valid_in,
             const void* att_wi, const void* att_wh, const float* att_b,
             const void* q_w, const float* q_b, const float* v_w,
             const void* const* lstm_wi, const void* const* lstm_wh,
             const float* const* lstm_b, int n_layers,
             const void* const* dense_w, const float* const* dense_b,
             int n_dense, const void* head_w, const float* head_b,
             const float* gate_w, const float* gate_b, float* mel,
             float* attn, float* gates, float* work, int* iwork,
             const int* bounds, int n_blocks, int parts, int slices,
             long long* clock, int N, int B, int M, int H, int D, int Tk,
             float temperature, float gate_threshold, int early_exit,
             const void* pack, const int* tab, void* stream_handle) {
  if (n_layers < 1 || n_layers > kMaxLayers || n_dense < 0 ||
      n_dense > kMaxDense || parts < 1 || parts > kMaxParts || parts > Tk ||
      slices < 1 || slices > D || n_blocks < 1 || N < 1 || B < 1)
    return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int Hp = padk(H, bf), Mp = padk(M, bf), Lp = padk(H + D, bf);
  Params p = {};
  auto job = [](const void* w, const float* bias, int Kp, int rows,
                int kind, int layer) {
    Job j = {w, bias, Kp, rows, kind, layer};
    return j;
  };
  auto kxp = [&](int l) { return l ? Hp : Lp; };
  int s = 0;
  // the attention LSTM's input half; decoder layers 1..'s recurrent halves
  p.st[s].job[p.st[s].n_jobs++] =
      job(att_wi, att_b, Mp, 4 * H, kAttIH, -1);
  for (int l = 1; l < n_layers; ++l)
    p.st[s].job[p.st[s].n_jobs++] =
        job(lstm_wh[l], nullptr, Hp, 4 * H, kRec, l);
  ++s;
  // the query; decoder layer 0's recurrent half
  p.st[s].job[p.st[s].n_jobs++] = job(q_w, q_b, Hp, D, kQuery, 0);
  p.st[s].job[p.st[s].n_jobs++] =
      job(lstm_wh[0], nullptr, Hp, 4 * H, kRec, 0);
  ++s;
  // attention partials; the attention LSTM's recurrent half
  p.st[s].attention = 1;
  p.st[s].job[p.st[s].n_jobs++] =
      job(att_wh, nullptr, Hp, 4 * H, kRec, -1);
  ++s;
  for (int l = 0; l < n_layers; ++l, ++s)   // the decoder cells
    p.st[s].job[p.st[s].n_jobs++] =
        job(lstm_wi[l], lstm_b[l], kxp(l), 4 * H, kIH, l);
  for (int i = 0; i < n_dense; ++i, ++s)
    p.st[s].job[p.st[s].n_jobs++] =
        job(dense_w[i], dense_b[i], Hp, H, kDense, i);
  p.st[s].job[p.st[s].n_jobs++] = job(head_w, head_b, Hp, 2 * M, kHead, 0);
  p.n_stages = s + 1;
  int xs = 0;
  for (int i = 0; i < p.n_stages; ++i) {
    int w = 0;
    for (int j = 0; j < p.st[i].n_jobs; ++j)
      w += (B < kMaxB ? B : kMaxB) *
           (bf ? wstride(p.st[i].job[j].Kp) / 4 : p.st[i].job[j].Kp);
    xs = w > xs ? w : xs;
  }

  p.bounds = bounds;
  p.z = z;
  p.kp = kp;
  p.vals = vals;
  p.mask = key_mask;
  p.v_w = v_w;
  p.gate_w = gate_w;
  p.gate_b = gate_b;
  p.nvin = n_valid_in;
  p.mel = mel;
  p.attn = attn;
  p.gates = gates;
  float* f = work;
  auto take = [&f](size_t n) { float* r = f; f += n; return r; };
  p.h_att = take((size_t)B * H);
  p.c_att = take((size_t)B * H);
  p.q = take((size_t)B * D);
  p.scores = take((size_t)B * Tk);
  for (int l = 0; l < n_layers; ++l) {
    p.h[l] = take((size_t)B * H);
    p.c[l] = take((size_t)B * H);
  }
  for (int l = 0; l <= n_layers; ++l) p.rec[l] = take((size_t)B * 4 * H);
  p.y[0] = take((size_t)B * H);
  p.y[1] = take((size_t)B * H);
  p.pm = take((size_t)parts * B);
  p.ps = take((size_t)parts * B);
  p.pc = take((size_t)parts * B * D);
  p.gslot = long_slot(bf, Tk, parts);
  p.slot_sc = p.gslot ? take((size_t)n_blocks * p.gslot) : nullptr;
  p.done = iwork;
  p.bar = reinterpret_cast<unsigned*>(iwork + B);
  p.clock = clock;
  p.N = N;
  p.B = B;
  p.M = M;
  p.H = H;
  p.D = D;
  p.Tk = Tk;
  p.n_layers = n_layers;
  p.n_dense = n_dense;
  p.parts = parts;
  p.slices = slices;
  p.rows = B < kMaxB ? B : kMaxB;
  p.grid = n_blocks;
  p.early_exit = early_exit;
  p.Dp = pad4(D);
  p.kslot = pad4((Tk + parts - 1) / parts);
  p.xs_floats = xs;
  p.temperature = temperature;
  p.threshold = gate_threshold;
  p.pack = static_cast<const unsigned char*>(pack);
  p.tab = tab;
  if (bf) p.kslot = kSlot16;

  const int smem = k1_smem_bytes(bf);
  const int fixed = k1_fixed_floats(B, M, H, D, Tk, n_layers, parts, bf);
  int used = xs + 2 * p.Dp + p.kslot + kMaxB * (2 * kMaxParts + 2)
             + pad4(H + D);
  if (bf) used = (used + 31) & ~31;
  if (smem < 0 || used != fixed || (bf && (pack == nullptr || !tab)))
    return cudaErrorInvalidValue;
  p.wbuf_off = fixed;
  p.wcap = (smem / 4 - fixed) & ~3;
  if (p.wcap < 0) return cudaErrorInvalidValue;
  const void* kernel = k1_kernel_of(bf);
  const int most = coresident_blocks(kernel, smem);
  if (most < 0) return cudaErrorInvalidValue;
  if (n_blocks > most) return cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err;
  if ((err = cudaMemsetAsync(work, 0,
                             sizeof(float) * workspace_floats(
                                 B, H, D, Tk, n_layers, parts, bf,
                                 n_blocks), stream)))
    return err;
  if ((err = cudaMemsetAsync(iwork, 0, sizeof(int) * (B + 1), stream)))
    return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kernel, n_blocks, kThreads, args, smem,
                                    stream);
  return err ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decoder_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Blocks of K1 (the fp32 body, or with bf16 != 0 the bf16 one) that can
// be resident at once on this card (the most its cooperative launch may
// take), or -1.
int decoder_coresident_blocks(int bf16) {
  return coresident_blocks(k1_kernel_of(bf16 != 0), k1_smem_bytes(bf16 != 0));
}

// Bytes of shared memory a block beside the staged inputs: fp32 the
// prefetch buffer, bf16 the resident rows and the ring; a negative number
// when the widths leave none.
long long decoder_prefetch_bytes(int B, int M, int H, int D, int Tk,
                                 int n_layers, int parts, int bf16) {
  const int smem = k1_smem_bytes(bf16 != 0);
  if (smem < 0) return -1;
  return 4LL * ((smem / 4 - k1_fixed_floats(B, M, H, D, Tk, n_layers, parts,
                                            bf16 != 0))
                & ~3);
}

// The bf16 body's dynamic shared memory before its resident rows at B
// batch rows, the same at every Tk (bytes; ops/decoder.py:k1_fixed_bytes
// computes the same).
long long decoder_fixed_bytes(int B, int M, int H, int D, int n_layers) {
  return 4LL * k1_fixed_floats(B, M, H, D, 1, n_layers, 1, true);
}

// The card's opt-in shared memory a block, or -1.
int decoder_smem_optin(void) { return smem_optin(); }

// Floats of workspace fused_flow_infer_launch needs (the caller
// allocates it; the entry zeroes it), and ints of integer workspace.
long long decoder_workspace_floats(int B, int H, int D, int Tk,
                                   int n_layers, int parts, int bf16,
                                   int n_blocks) {
  return workspace_floats(B, H, D, Tk, n_layers, parts, bf16 != 0,
                          n_blocks);
}

int decoder_workspace_ints(int B) { return B + 1; }

// `iters` grid barriers of `mode` (0 = K1's own, 1 = cooperative_groups')
// over n_blocks blocks; counter: one zeroed unsigned.
int decoder_barrier_bench(int mode, int iters, int n_blocks,
                          unsigned* counter, void* stream_handle) {
  void* args[] = {&counter, &iters, &mode};
  cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)barrier_bench_kernel, n_blocks, kThreads, args, 0,
      static_cast<cudaStream_t>(stream_handle));
  return err ? err : cudaGetLastError();
}

// One flow's inverse scan over N frames, one cooperative launch. Shapes
// (contiguous):
//   z (N, B, M) fp32; kp, vals (B, Tk, D); key_mask (B, Tk) fp32;
//   n_valid_in (B,) int32; outputs mel (N, B, M), attn (N, B, Tk),
//   gates (N, B), fp32.
// Packed weights (ops/decoder.py:pack_flow_weights), with P(n) = n
// rounded up to a multiple of 4 (fp32) or 8 (bf16):
//   att_wi (4H, P(M)), att_wh (4H, P(H)), att_b (4H)   interleaved LSTM rows
//   q_w (D, P(H)), q_b (D), v_w (D)
//   lstm_wi[l] (4H, P(K_l)), lstm_wh[l] (4H, P(H)), lstm_b[l] (4H),
//     K_0 = H + D, K_l = H
//   dense_w[i] (H, P(H)), dense_b[i] (H)
//   head_w (2M, P(H)), head_b (2M)              interleaved (log_s, b)
//   gate_w (H + D), gate_b (1), or both null when the flow has no gate.
// bf16 = 0: every tensor fp32; pack and tab null. bf16 != 0, the body the
// Pallas kernel runs on bf16 params: kp and vals bf16, the vectors of a
// bf16 pack_flow_weights (the matrices are not read); its matrices in
// `pack` (ops/decoder.py:k1_pack: the K1 pack, bf16), laid out as `tab`
// (int32 on the device, (n_stages, n_blocks, 16), k1_resident_layout)
// says; z, the outputs and the workspace fp32. lstm_wi, lstm_wh, lstm_b, dense_w,
// dense_b are host arrays of device pointers.
// bounds: (4 + n_layers + n_dense, 4, n_blocks + 1) int32 on the device,
// each job's quad boundaries from ops/decoder.py:k1_plan (k1_bounds_array),
// whose stage and job order this entry repeats; parts: the attention partials
// (ops/decoder.py:k1_attn_parts). clock: null, or (N, n_stages) int64
// that receives the ns time at which block 0 passes each stage's barrier.
int fused_flow_infer_launch(
    int bf16, const float* z, const void* kp, const void* vals,
    const float* key_mask, const int* n_valid_in, const void* att_wi,
    const void* att_wh, const float* att_b, const void* q_w,
    const float* q_b, const float* v_w, const void* const* lstm_wi,
    const void* const* lstm_wh, const float* const* lstm_b, int n_layers,
    const void* const* dense_w, const float* const* dense_b, int n_dense,
    const void* head_w, const float* head_b, const float* gate_w,
    const float* gate_b, float* mel, float* attn, float* gates, float* work,
    int* iwork, const int* bounds, int n_blocks, int parts, int slices,
    long long* clock, int N, int B, int M, int H, int D, int Tk,
    float temperature, float gate_threshold, int early_exit,
    const void* pack, const int* tab, void* stream_handle) {
  return run_flow(bf16 != 0, z, kp, vals, key_mask, n_valid_in, att_wi,
                  att_wh, att_b, q_w, q_b, v_w, lstm_wi, lstm_wh, lstm_b,
                  n_layers, dense_w, dense_b, n_dense, head_w, head_b,
                  gate_w, gate_b, mel, attn, gates, work, iwork, bounds,
                  n_blocks, parts, slices, clock, N, B, M, H, D, Tk,
                  temperature, gate_threshold, early_exit, pack, tab,
                  stream_handle);
}

}  // extern "C"
