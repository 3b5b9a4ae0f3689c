// P1 and P2: the int4 dequant-matmul probe kernels, on the tensor cores.
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
// 4096): 0.87 GFLOP against 3.4 MB of int4 weights, ~0.9 us at the bf16
// tensor-core peak (mma.sync reaches about half of it) and ~1.3 us for
// the bytes from HBM; what a block must add on top is decoding the
// nibbles into bf16 tiles and reading x, which every column tile needs
// whole (213 KB at B = 64), and summing the split rows.
//
// The design:
// - a block owns a column tile of kTN = 64 outputs, every batch row (64 a
//   pass as four m16 tiles, more in further passes; a ragged pass is
//   masked) and a range of 64-packed-row chunks; so each byte of q is read
//   and decoded once a pass;
// - warp specialisation: 8 producer warps stage chunk j + 2 with cp.async
//   (16 bytes a copy, neighbouring threads on neighbouring addresses, each
//   thread's offsets fixed for the call) into a ring of kStages slots and
//   decode chunk j into one of two bf16 tiles, while 8 consumer warps
//   multiply chunk j - 1 out of the other; one block barrier a chunk;
//   a chunk is q's 64 x 64 bytes and the two 64-column pieces of x that
//   its low and high nibbles meet;
// - each byte is decoded once into its two rows: the nibbles of a 32-bit
//   word go into the low bytes of bf16 2^7-exponent words (0x43 in the
//   high byte: the value 128 + nibble, offset by flipping the sign bit),
//   and one bf16x2 subtract of 136 gives the signed value exactly, two
//   columns an instruction; modes 1 and 2 then multiply by bf16(s) in
//   bf16x2, one rounding of the exact product, as JAX rounds it; the rows
//   go to a bf16 tile [k][n] that ldmatrix.trans turns into B fragments;
// - x's pieces are bf16 in shared memory and give A fragments by ldmatrix
//   (those of the next k-step load while this one multiplies); the
//   products are mma.sync m16n8k16 bf16 -> fp32, each consumer warp a
//   16 x 32 tile (4 independent accumulators); k5 keeps a second set for
//   the 64-row chunk in flight and adds it, times s in fp32, after it;
// - the block stages its (NG, kTN) fp32 scale tile once, with the first
//   chunk; shared-memory rows are padded by 16 bytes against bank
//   conflicts in ldmatrix;
// - the rows are split over up to 8 blocks, a thread block cluster; the
//   host (ops/w4.py:w4_plan) takes the largest split whose blocks make one
//   wave and whose clusters the card runs all at once (w4_max_clusters:
//   clusters must fit inside the card's GPCs, so fewer large clusters
//   than SMs / split may run at once, and a split whose clusters do not
//   all fit takes two waves); each block sums its share of the
//   tile from all of the cluster's blocks through distributed shared
//   memory in split order, so a call is one launch with a fixed order of
//   sums (bitwise repeatable, no atomics).
// What holds it back (PERF.md): a block's rounds run at about half of
// mma.sync's rate while the decode competes for issue slots, and the
// first chunk's latency and the cluster's wait and sum add ~2-3 us.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 8;           // warps 0-7 multiply
constexpr int kProducers = 256;              // threads 256-511 stage, decode
constexpr int kThreads = kConsumerWarps * 32 + kProducers;
constexpr int kTN = 64;                      // output columns per block
constexpr int kBM = 64;                      // batch rows per pass
constexpr int kWarpsN = kTN / 32;            // consumer warps along n
constexpr int kWarpRows = kBM * kWarpsN / kConsumerWarps;   // rows a warp
constexpr int kMT = kWarpRows / 16;          // m16 tiles a consumer warp
constexpr int kKP = 64;                      // packed rows per chunk
constexpr int kStages = 4;                   // chunks in the ring
constexpr int kAhead = 2;                    // chunks staged ahead
constexpr int kQStep = kProducers / (kTN / 16);   // q rows a copy round
constexpr int kXS = 2 * kKP + 8;             // x row stride (bf16)
constexpr int kWS = kTN + 8;                 // decoded row stride (bf16)
constexpr int kRS = kTN + 8;                 // partial-sum row stride (fp32)
constexpr int kMaxNG = 64;
constexpr int kMaxSplit = 8;
constexpr size_t kXBytes = (size_t)kBM * kXS * 2;
constexpr size_t kQBytes = (size_t)kKP * kTN;
constexpr size_t kStageBytes = kXBytes + kQBytes;
constexpr size_t kWBytes = (size_t)2 * kKP * kWS * 2;   // a decoded tile
static_assert(kWBytes >= (size_t)kBM * kRS * 4, "partials alias tile 0");
static_assert(kStages >= kAhead + 2, "a slot is refilled two rounds on");

enum Mode { kPlain = 0, kGroup = 1, kModulo = 2, kGroupAcc = 3 };

// Two signed nibbles (offset by 8 in the low bytes of `bits`, 0x43 in the
// high bytes) as exact bf16x2.
__device__ __forceinline__ __nv_bfloat162 nib2(uint32_t bits) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&bits);
  return __hsub2(v, __float2bfloat162_rn(136.f));
}

// Barrier `id` for `count` threads (the producers' own, beside
// __syncthreads' barrier 0).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The four bf16 scales of a thread's columns as two bf16x2 pairs (modes 1
// and 2: bf16(s), as JAX rounds it).
__device__ __forceinline__ void scale_pairs(const float* p,
                                            __nv_bfloat162 (&s)[2]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  s[0] = __floats2bfloat162_rn(v.x, v.y);
  s[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The four columns of one packed word (row p of the chunk) as bf16 rows:
// the low nibbles to w_lo, the high ones to w_hi (unless null), each
// times its scales s[0] and s[1] in modes 1 and 2, 8 bytes a row.
template <int kMode>
__device__ __forceinline__ void decode_word(uint32_t word,
                                            const __nv_bfloat162 (&s)[2][2],
                                            __nv_bfloat16* w_lo,
                                            __nv_bfloat16* w_hi) {
  const uint32_t t = word ^ 0x88888888u;   // two's complement -> offset 8
  const uint32_t nib[2] = {t & 0x0F0F0F0Fu, (t >> 4) & 0x0F0F0F0Fu};
  __nv_bfloat16* dst[2] = {w_lo, w_hi};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (dst[h] == nullptr) continue;
    __nv_bfloat162 a = nib2(__byte_perm(nib[h], 0x43434343u, 0x4140));
    __nv_bfloat162 b = nib2(__byte_perm(nib[h], 0x43434343u, 0x4342));
    if (kMode == kGroup || kMode == kModulo) {
      a = __hmul2(a, s[h][0]);
      b = __hmul2(b, s[h][1]);
    }
    *reinterpret_cast<uint2*>(dst[h]) = make_uint2(as_u32(a), as_u32(b));
  }
}

struct Args {
  const __nv_bfloat16* x;
  const int8_t* q;
  const float* s;
  __nv_bfloat16* out;
  int B, IN, OUT, NG, G, half_only;
};

// Block (column tile blockIdx.x, split blockIdx.z); the cluster is the
// split blocks of one column tile. Warps 0-7 multiply, warps 8-15 stage
// and decode: in round j the producers decode chunk j into tile j % 2
// while the consumers multiply chunk j - 1 out of tile (j - 1) % 2.
template <int kMode>
__global__ void __launch_bounds__(kThreads, 1) w4_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.z, z = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool producer = warp >= kConsumerWarps;
  const int pt = threadIdx.x - kConsumerWarps * 32;   // producer thread
  const int gid = lane >> 2, tig = lane & 3;
  // consumer warp tile: kWarpRows batch rows x 32 columns
  const int wm = warp % (kConsumerWarps / kWarpsN);
  const int wn = warp / (kConsumerWarps / kWarpsN);
  const int n0 = blockIdx.x * kTN, half = a.IN / 2;
  const int n_chunks = a.IN / (2 * kKP);
  const int c_begin = n_chunks * z / split, c_end = n_chunks * (z + 1) / split;
  const int n_local = c_end - c_begin;
  const int kin = a.half_only ? kKP : 2 * kKP;   // x columns of a chunk
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(
      smem + kStages * kStageBytes);
  float* red = reinterpret_cast<float*>(ws);
  float* sc = reinterpret_cast<float*>(smem + kStages * kStageBytes +
                                       2 * kWBytes);
  // a producer's copies of a chunk, fixed for the call: 16 bytes of x
  // rows xr + x_step u at column xcol (+ the chunk's first row), and of q
  // rows qr + kQStep u at byte 16 qc of the tile
  const int per_row = kin / 8, x_step = kProducers / per_row;
  const int xr = pt / per_row, xc = pt % per_row;
  const int xcol = xc < kKP / 8 ? 8 * xc : half + 8 * (xc - kKP / 8);
  const int qr = pt / (kTN / 16), qc = pt % (kTN / 16);

  for (int b0 = 0; b0 < a.B; b0 += kBM) {
    const int nb = min(kBM, a.B - b0);
    // producers: stage chunk i into its ring slot, one copy group (rows
    // >= nb are left as they are: a product row depends only on its own
    // x row)
    const __nv_bfloat16* xsrc = a.x + (size_t)(b0 + xr) * a.IN + xcol;
    const int8_t* qsrc = a.q + (size_t)qr * a.OUT + n0 + 16 * qc;
    auto load = [&](int i) {
      if (i < n_local) {
        const int p0 = (c_begin + i) * kKP;
        unsigned char* st = smem + (i % kStages) * kStageBytes;
        __nv_bfloat16* xs =
            reinterpret_cast<__nv_bfloat16*>(st) + xr * kXS + 8 * xc;
        for (int r = 0; xr + r < nb; r += x_step)
          cp_async16(xs + r * kXS, xsrc + (size_t)r * a.IN + p0);
        int8_t* qs = reinterpret_cast<int8_t*>(st + kXBytes) + qr * kTN + 16 * qc;
#pragma unroll
        for (int u = 0; u < kKP / kQStep; ++u)
          cp_async16(qs + u * kQStep * kTN,
                     qsrc + (size_t)(p0 + u * kQStep) * a.OUT);
      }
      cp_async_commit();
    };
    if (producer) {
      // the scale tile, with the first chunk's group (scale_pairs rounds
      // it to bf16 for modes 1 and 2)
      if (kMode != kPlain && b0 == 0)
        for (int i = pt; i < a.NG * (kTN / 4); i += kProducers)
          cp_async16(sc + 4 * i, a.s + (size_t)(i / (kTN / 4)) * a.OUT + n0 +
                                     4 * (i % (kTN / 4)));
      for (int i = 0; i < kAhead; ++i) load(i);
    }

    float acc[kMT][4][4], part[kMT][4][4];
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = part[mi][ni][e] = 0.f;

    for (int j = 0; j <= n_local; ++j) {
      if (producer && j < n_local) {
        load(j + kAhead);
        cp_async_wait<kAhead>();   // chunk j (and the scales) landed
        named_sync(1, kProducers);
        const unsigned char* st = smem + (j % kStages) * kStageBytes;
        const uint32_t* qs = reinterpret_cast<const uint32_t*>(st + kXBytes);
        __nv_bfloat16* wt = ws + (size_t)(j & 1) * (kWBytes / 2);
        const int p0 = (c_begin + j) * kKP;
        // this thread's words: columns c4 .. c4 + 3 of rows r0 + 8 u, so
        // modes 1 and 3 (a chunk lies in one group) need one scale row
        // pair a chunk, mode 2 one a row
        constexpr int kRowStep = kProducers / (kTN / 4);
        constexpr int kWords = kKP / kRowStep;
        const int r0 = pt / (kTN / 4), c4 = 4 * (pt % (kTN / 4));
        uint32_t words[kWords];   // every load first, so that they overlap
#pragma unroll
        for (int u = 0; u < kWords; ++u)
          words[u] = qs[(r0 + kRowStep * u) * (kTN / 4) + c4 / 4];
        __nv_bfloat162 s2[2][2];   // [lo / hi][column pair]
        if (kMode == kGroup) {
          scale_pairs(sc + (size_t)(p0 / a.G) * kTN + c4, s2[0]);
          scale_pairs(sc + (size_t)((half + p0) / a.G) * kTN + c4, s2[1]);
        }
        int m_lo = 0, m_hi = 0;   // mode 2: row r0 + 8 u meets s[r % NG]
        if (kMode == kModulo) {
          m_lo = (p0 + r0) % a.NG;
          m_hi = (half + p0 + r0) % a.NG;
        }
#pragma unroll
        for (int u = 0; u < kWords; ++u) {
          const int r = r0 + kRowStep * u;
          if (kMode == kModulo) {
            scale_pairs(sc + (size_t)m_lo * kTN + c4, s2[0]);
            scale_pairs(sc + (size_t)m_hi * kTN + c4, s2[1]);
            for (m_lo += kRowStep; m_lo >= a.NG;) m_lo -= a.NG;
            for (m_hi += kRowStep; m_hi >= a.NG;) m_hi -= a.NG;
          }
          decode_word<kMode>(words[u], s2, wt + r * kWS + c4,
                             a.half_only ? nullptr : wt + (kKP + r) * kWS + c4);
        }
      } else if (!producer && j > 0 && wm * kWarpRows < nb) {
        const int i = j - 1;
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(
            smem + (i % kStages) * kStageBytes);
        const __nv_bfloat16* wt = ws + (size_t)(i & 1) * (kWBytes / 2);
        const int p0 = (c_begin + i) * kKP;
        const int k_steps = kin / 16;
        // the fragments of k-step ks + 1 load while k-step ks multiplies
        uint32_t af[2][kMT][4], bf[2][2][4];
        auto frags = [&](int ks, int buf) {
          const int k0 = 16 * ks;
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
            ldmatrix_x4<false>(af[buf][mi],
                               xs + (wm * kWarpRows + mi * 16 + (lane & 15)) * kXS
                                   + k0 + 8 * (lane >> 4));
#pragma unroll
          for (int nj = 0; nj < 2; ++nj)
            ldmatrix_x4<true>(bf[buf][nj], wt + (k0 + (lane & 15)) * kWS
                                               + wn * 32 + nj * 16 + 8 * (lane >> 4));
        };
        frags(0, 0);
#pragma unroll
        for (int ks = 0; ks < 2 * kKP / 16; ++ks) {
          if (ks >= k_steps) break;
          const int cur = ks & 1;
          if (ks + 1 < k_steps) frags(ks + 1, cur ^ 1);
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi) {
            if (wm * kWarpRows + mi * 16 >= nb) continue;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const uint32_t b0 = bf[cur][ni >> 1][2 * (ni & 1)];
              const uint32_t b1 = bf[cur][ni >> 1][2 * (ni & 1) + 1];
              if constexpr (kMode == kGroupAcc)
                mma_bf16(part[mi][ni], af[cur][mi], b0, b1);
              else
                mma_bf16(acc[mi][ni], af[cur][mi], b0, b1);
            }
          }
          if (kMode == kGroupAcc && (ks + 1) % (kKP / 16) == 0) {
            // a 64-row chunk is complete: acc += part * s[r / G] in fp32
            const int g = (ks < kKP / 16 ? p0 : half + p0) / a.G;
            const float* srow = sc + (size_t)g * kTN + wn * 32;
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
              const float s0 = srow[ni * 8 + 2 * tig];
              const float s1 = srow[ni * 8 + 2 * tig + 1];
#pragma unroll
              for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  acc[mi][ni][e] = __fadd_rn(
                      acc[mi][ni][e],
                      __fmul_rn(part[mi][ni][e], (e & 1) ? s1 : s0));
                  part[mi][ni][e] = 0.f;
                }
            }
          }
        }
      }
      __syncthreads();   // tile j is decoded; tile j - 1 and its x are free
    }
    cp_async_wait<0>();   // (only empty groups can be left)

    // this split's partial tile, then each block sums its share of the
    // cluster's tiles in split order
    if (!producer) {
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                red + (wm * kWarpRows + mi * 16 + gid + 8 * h) * kRS + wn * 32 +
                ni * 8 + 2 * tig) =
                make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
    cluster.sync();
    const int total = nb * (kTN / 4);
    for (int i = total * z / split + threadIdx.x; i < total * (z + 1) / split;
         i += kThreads) {
      const int r = i / (kTN / 4), c4 = 4 * (i % (kTN / 4));
      float4 u[kMaxSplit];   // every rank's value first: the loads overlap
#pragma unroll
      for (int k = 0; k < kMaxSplit; ++k)
        if (k < split)
          u[k] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(red, k) + r * kRS + c4);
      float4 v = u[0];
#pragma unroll
      for (int k = 1; k < kMaxSplit; ++k)
        if (k < split)
          v = make_float4(__fadd_rn(v.x, u[k].x), __fadd_rn(v.y, u[k].y),
                          __fadd_rn(v.z, u[k].z), __fadd_rn(v.w, u[k].w));
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(a.out + (size_t)(b0 + r) * a.OUT + n0 + c4) =
          make_uint2(as_u32(lo), as_u32(hi));
    }
    cluster.sync();    // the partial tiles are free again
  }
}

size_t smem_bytes(int mode, int NG) {
  return kStages * kStageBytes + 2 * kWBytes +
         (mode == kPlain ? 0 : (size_t)NG * kTN * sizeof(float));
}

// The launch of mode kMode: the grid, and the split blocks of a column
// tile as one cluster. The opt-in to the largest tile's shared memory is
// made once, outside any CUDA graph capture (the first call of a mode is
// never captured: callers warm up first).
template <int kMode>
cudaError_t configure(const Args& a, int split, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMode, kMaxNG));
    if (err) return err;
    opted_in = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(a.OUT / kTN, 1, split);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem_bytes(kMode, a.NG);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = split;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int kMode>
cudaError_t launch(const Args& a, int split, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kMode>(a, split, &cfg, &attr);
  if (err) return err;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, w4_kernel<kMode>, a);
  if (err) return err;
  return cudaGetLastError();
}

template <int kMode>
cudaError_t max_clusters(const Args& a, int split, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = configure<kMode>(a, split, &cfg, &attr);
  if (err) return err;
  return cudaOccupancyMaxActiveClusters(n, w4_kernel<kMode>, &cfg);
}

}  // namespace

extern "C" {

const char* w4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Clusters of `split` blocks that the card can run at once for mode
// `mode` with NG scale rows (one wave of column tiles needs OUT / 64 of
// them), or minus a CUDA error.
int w4_max_clusters(int mode, int NG, int split) {
  if (mode < 0 || mode > 3 || split < 1 || split > kMaxSplit ||
      (mode != kPlain && (NG < 1 || NG > kMaxNG)))
    return -(int)cudaErrorInvalidValue;
  Args a = {};
  a.OUT = kTN;
  a.NG = mode == kPlain ? 0 : NG;
  int n = 0;
  cudaError_t err;
  switch (mode) {
    case kPlain: err = max_clusters<kPlain>(a, split, &n); break;
    case kGroup: err = max_clusters<kGroup>(a, split, &n); break;
    case kModulo: err = max_clusters<kModulo>(a, split, &n); break;
    default: err = max_clusters<kGroupAcc>(a, split, &n); break;
  }
  return err ? -(int)err : n;
}

// x (B, IN) bf16, q (IN / 2, OUT) int8, s (NG, OUT) fp32 (unused by mode
// 0), out (B, OUT) bf16; all contiguous. n_rows = IN / 2 (k1) or IN;
// split blocks along the rows, a cluster. ops/w4.py:w4_plan checks the
// shapes first and names the constraint; the same constraints here
// return cudaErrorInvalidValue: IN a multiple of 128, OUT of 64, split
// in 1 .. min(8, IN / 128), NG in 1 .. 64 for modes 1-3, and IN / NG a
// multiple of 64 for modes 1 and 3.
int w4_matmul(const void* x, const int8_t* q, const float* s, void* out,
              int B, int IN, int OUT, int n_rows, int NG, int mode, int split,
              void* stream_handle) {
  if (B < 1 || IN < 128 || IN % 128 || OUT < kTN || OUT % kTN || mode < 0 ||
      mode > 3 || (n_rows != IN && n_rows != IN / 2) ||
      (n_rows == IN / 2 && mode != kPlain) || split < 1 ||
      split > kMaxSplit || split > IN / 128 ||
      (mode != kPlain && (NG < 1 || NG > kMaxNG)))
    return cudaErrorInvalidValue;
  const int G = mode == kPlain ? 0 : IN / NG;
  if ((mode == kGroup || mode == kGroupAcc) && (IN % NG || G % kKP))
    return cudaErrorInvalidValue;
  const Args a = {static_cast<const __nv_bfloat16*>(x), q, s,
                  static_cast<__nv_bfloat16*>(out), B, IN, OUT,
                  mode == kPlain ? 0 : NG, G, n_rows == IN / 2};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  switch (mode) {
    case kPlain: return launch<kPlain>(a, split, stream);
    case kGroup: return launch<kGroup>(a, split, stream);
    case kModulo: return launch<kModulo>(a, split, stream);
    default: return launch<kGroupAcc>(a, split, stream);
  }
}

}  // extern "C"
