// K2's bf16 body (wn_layer_launch's bf16 flag; included by
// csrc/wavenet.cu): one WaveGlow WN layer with every tensor bf16, the body
// the Pallas kernel _wn_layer_kernel (flowtron_tpu/ops/wavenet_pallas.py:
// 32-54, pallas_call at :93) runs under the JAX server's --bf16:
//
//   acts = [x[t-d], x[t], x[t+d]] @ W_cat + b + cond   bf16 products, fp32 sums
//   z    = bf16(tanh(acts[:, :C]) * sigmoid(acts[:, C:]))   the gate in fp32
//   rs   = z @ W_rs + b_rs
//   x'   = bf16(x + rs[:, :C]), zero on pad rows;  skip = bf16(rs[:, C:])
//   (last layer: skip = bf16(rs))
//
// Its bound on an H100: tensor-core operations. At C = 256 a row is
// 2 (768 * 512 + 256 * 512) = 1.05 M bf16 operations against 2.6 KB of
// its own traffic (x, cond, x', skip), ~400 operations a byte, above the
// card's ridge of ~295: a flagship layer at B=1 (12800 rows) is 13.4
// GFLOP, 0.0136 ms at 989 TFLOP/s, against 0.010 ms of bytes.
//
// The design (Hopper's usual shape):
// - Warp specialisation. A block is NWG consumer warpgroups of 64 rows
//   each (BM = 64 NWG rows a tile) and one producer warpgroup, of which
//   one thread issues every copy; setmaxnreg moves the registers to the
//   consumers. The main loop has no block-wide barrier: a ring of S
//   slots, each with a full and an empty mbarrier, is the only handoff.
// - A tile is a list of stages, the same for the producer and the
//   consumers: for each acts pass h (N1 packed columns, 2C / N1 passes),
//   3C / 64 k stages (x box BM x 64 channels + W_cat box N1 x 64, four
//   wgmma m64nN1k16 a warpgroup), then cond's tanh half and its sigmoid
//   half (a stage each); then for each rs pass p, C / 64 stages of W_rs
//   (N1 x 64) and two output stages of N1 / 2 columns each. K is walked
//   64 rows a stage, not 16, so a stage hands over four k-steps.
// - x by TMA, the shift in the tensor map: x is a 3-D map (C, T, B) whose
//   time extent is T, not Tp, with batch stride Tp C, so TMA fills every
//   tap row outside [0, T) with zeros, as wn_layer_reference's xv =
//   where(valid, x, 0). The three taps are the same box at time t0 - d,
//   t0 and t0 + d; a tile is BM time steps of one stream, so a box never
//   crosses into another stream.
// - Every box is 64 bf16 (128 bytes) wide with the 128-byte swizzle that
//   wgmma's shared-memory descriptors read: A (x or z) and B (the
//   weights, packed transposed by ops/wavenet.py:wn_pack_weights so that
//   both operands are K-major) need no shuffling. W_cat's columns keep
//   the fp32 body's pairing (tanh 8 | sigmoid 8 per group of 8 channels),
//   so n-blocks 2q and 2q + 1 of an accumulator are the tanh and the
//   sigmoid input of the same (row, channel) in the same thread: the gate
//   is thread-local.
// - cond off the critical path: the producer brings a pass's cond into L2
//   as the pass starts and queues its two stages behind the pass's last k
//   stage; the gate reads them from shared memory (swizzled: no bank
//   conflicts).
// - z never leaves the SM: the gate rounds it once to bf16 into shared
//   memory in the layout the rs product reads as A. The rs product
//   streams W_rs through the same ring.
// - The epilogue in the ring too: x' stages bring x's rows for the
//   residual by TMA, skip stages come empty; the warpgroup writes its
//   rows of x' (zero on pad rows) or skip into the slot and one thread
//   stores them by TMA (rows past Tp dropped). The next tile's x is
//   brought into L2 while the rs passes run.
// - The gate runs tanh.approx (one special-function op) and sigmoid(a) =
//   0.5 tanh(a / 2) + 0.5: two special-function ops a z. Its error (PTX:
//   ~2^-11 relative) is under z's bf16 rounding (2^-9); the CPU tests
//   hold the body within 1e-2 of the Pallas kernel with every tanh off by
//   that much.
// - A persistent grid (one block a SM walking tiles) or one block a tile,
//   as ops/wavenet.py:wn_bf16_plan says, which also picks 128- or 64-row
//   tiles by their measured cost (64 at a stream window of 2560 rows: 40
//   tiles, not 20, on 132 SMs). The ring's phases run on across tiles.
// - Every sum has one owner and a fixed order (no atomics): two calls,
//   and every build and grid, are bitwise equal.
//
// What holds it (H100 80GB HBM3 at 700 W; PERF.md, K2 bf16): layer 3 at
// B=1 runs 0.036 ms, 2.6x its bound and level with bf16 cuBLAS's two
// bare products on the same shapes (0.035 ms; chip_smoke.py --k2-bf16).
// scripts/k2_bf16_study.py takes one part out at a time: without the
// gate 0.028 ms, without the epilogue 0.029, without both 0.019, without
// any x or weight load 0.033 (B=8: the whole 0.249, then 0.224, 0.200,
// 0.145, 0.230).
// So the copies are hidden; the products alone run at 1.4x their bound,
// near what shared memory feeds (two warpgroups' SS wgmma reads and the
// TMA writes ask ~127 of its ~128 bytes a cycle at the tensor cores'
// rate), and the gate and the epilogue run after them with the tensor
// cores idle. The gate runs at about a quarter of the special-function
// rate, though tanh.approx is its fastest form: what holds it is open.
// Overlapping them with the products is the next step; it needs another
// accumulator or another tile's products in flight, and shared memory
// has no room for a second W stream.
// Tried and dropped: the gate as ex2 and reciprocals (four special-
// function ops a z) or tanh with an ex2 sigmoid, both slower
// (scripts/k2_bf16_study.py's gate variants; PERF.md); 64-row tiles at
// 400 frames, slower (builds_ms in chip_smoke.py's k2_bf16 lines); and,
// timed while this body was built but not kept in a committed script, a
// 2-block cluster multicasting the weight boxes, z kept in registers as
// wgmma's A operand for a fourth ring slot, deferring the TMA store's
// read-wait, and loading the gate's and the epilogue's shared values
// ahead of their stores: each tied.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {
namespace wn16 {

constexpr int kBK = 64;          // k rows a stage: one 128-byte row of bf16
constexpr int kRow = 128;        // bytes of a swizzled box row
constexpr int kMaxSmem = 232448;
// error codes past CUDA's own (wavenet_error_string names them)
constexpr int kErrNoEncoder = 100001, kErrEncode = 100002;

// C channels; NWG consumer warpgroups (BM = 64 NWG rows a tile); N1
// packed acts columns a pass (also the rs columns a pass); S ring slots
template <int C_, int NWG_, int N1_, int S_>
struct Cfg {
  static constexpr int C = C_, NWG = NWG_, N1 = N1_, S = S_;
  static constexpr int BM = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int NH = 2 * C / N1;        // acts passes
  static constexpr int K1S = 3 * C / kBK;      // k stages of an acts pass
  static constexpr int K2S = C / kBK;          // k stages of an rs pass
  static constexpr int XB = BM * kRow;         // an x box
  static constexpr int WB = N1 * kRow;         // a weight box
  static constexpr int CBOX = N1 / 128;        // cond boxes a half
  static constexpr int CB = CBOX * XB;         // a cond half
  static constexpr int SLOT = XB + WB;
  static constexpr int ZB = (C / kBK) * XB;    // z, C / 64 boxes of BM rows
  // the ring, z, the full and empty barriers, and room to align to 1024
  static constexpr int SMEM = 1024 + S * SLOT + ZB + 2 * S * 8;
  static_assert(C % kBK == 0 && N1 % 128 == 0 && (2 * C) % N1 == 0,
                "tiling");
  static_assert(CB <= SLOT && S >= 3, "ring");
  static_assert(SMEM <= kMaxSmem, "shared memory");
};

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

__device__ __forceinline__ uint32_t ldg32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float tanh_approx(float a) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(a));
  return y;
}

// tanh(at) * sigmoid(as), sigmoid(a) = 0.5 tanh(a / 2) + 0.5
__device__ __forceinline__ float gate(float at, float as) {
  return tanh_approx(at) * fmaf(0.5f, tanh_approx(0.5f * as), 0.5f);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// waits for the phase of parity `parity` to complete; a wait that lasts
// 2^26 tries (seconds) traps, so a broken handoff fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma2(uint32_t dst, const CUtensorMap* map,
                                     int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma3(uint32_t dst, const CUtensorMap* map,
                                     int c0, int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// a box from shared memory to the tensor, elements outside it dropped;
// the issuing thread waits with store_wait_read before reusing the source
__device__ __forceinline__ void tma_store3(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(map), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;\n"
               "cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// a box brought into L2 ahead of its load
__device__ __forceinline__ void prefetch3(const CUtensorMap* map, int c0,
                                          int c1, int c2) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global.tile [%0, {%1, %2, %3}];\n"
      :: "l"(map), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand in 128-byte
// swizzled rows, 8-row groups 1024 bytes apart (SBO), layout B128
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across a
// wgmma that is still in flight
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N, this thread's N / 2 values) += A (64 x 16) B (16 x N), A and
// B by shared-memory descriptor; acc = 0: d = A B
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

// The tensor maps of a launch: x (C, T, B) and cond (2C, Tp, B) in boxes
// of BM rows, the packs w1 (3C, 2C) and w2 (C, n_rs) in boxes of N1 rows,
// x' and skip (C, Tp, B) in boxes of 64 rows (a warpgroup's stores)
struct Maps {
  CUtensorMap x, cond, w1, w2, x_out, skip;
};

template <class K, bool LAST>
__global__ void __launch_bounds__(K::THREADS, 1)
wn16_kernel(const __grid_constant__ Maps m,
            const __nv_bfloat16* __restrict__ b,
            const __nv_bfloat16* __restrict__ b_rs, int d, int T, int Tp,
            int n_tiles) {
  constexpr int C = K::C, BM = K::BM, S = K::S, N1 = K::N1;
  constexpr int NRS = LAST ? C : 2 * C;          // rs columns
  constexpr int NP2 = (NRS + N1 - 1) / N1;       // rs passes
  constexpr int HALF = N1 / 2;                   // columns an output stage
  extern __shared__ unsigned char smem_raw[];
  // the ring and z, 1024-aligned as the 128-byte swizzle wants; the
  // barriers behind them
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  unsigned char* const ring_p = smem_raw + (ring - raw);
  const uint32_t zs = ring + S * K::SLOT;
  unsigned char* const z_p = ring_p + S * K::SLOT;
  const uint32_t full = zs + K::ZB, empty = full + 8 * S;
  const int per_stream = (Tp + BM - 1) / BM;     // tiles a stream

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's arrival
      mbar_init(empty + 8 * s, 4 * K::NWG);      // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == K::NWG) {
    // the producer: one thread walks the tiles' stages
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == K::NWG * 128) {
      asm volatile("prefetch.tensormap [%0];\n"
                   "prefetch.tensormap [%1];\n"
                   "prefetch.tensormap [%2];\n"
                   "prefetch.tensormap [%3];\n"
                   :: "l"(&m.x), "l"(&m.cond), "l"(&m.w1), "l"(&m.w2)
                   : "memory");
      int slot = 0;
      uint32_t phase = 0;
      // the next free slot, its full barrier told to expect `bytes` (0:
      // a slot handed over empty, for the consumers' output)
      auto next = [&](uint32_t bytes, uint32_t& dst, uint32_t& bar) {
        mbar_wait(empty + 8 * slot, phase ^ 1);
        dst = ring + slot * K::SLOT;
        bar = full + 8 * slot;
        if (bytes) mbar_expect(bar, bytes);
        else mbar_arrive(bar);
        if (++slot == S) slot = 0, phase ^= 1;
      };
      uint32_t dst, bar;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int bi = tile / per_stream, t0 = (tile - bi * per_stream) * BM;
        for (int h = 0; h < K::NH; ++h) {
          // this pass's cond into L2 while its k stages run
          for (int i = 0; i < 2 * K::CBOX; ++i)
            prefetch3(&m.cond, (i / K::CBOX) * C + h * HALF
                      + 64 * (i % K::CBOX), t0, bi);
          for (int kc = 0; kc < K::K1S; ++kc) {
            const int k = kc * kBK, tap = k / C;
            next(K::XB + K::WB, dst, bar);
            tma3(dst, &m.x, k - tap * C, t0 + (tap - 1) * d, bi, bar);
            tma2(dst + K::XB, &m.w1, k, h * N1, bar);
          }
          for (int half = 0; half < 2; ++half) {   // cond: tanh, sigmoid
            next(K::CB, dst, bar);
            for (int i = 0; i < K::CBOX; ++i)
              tma3(dst + i * K::XB, &m.cond, half * C + h * HALF + 64 * i,
                   t0, bi, bar);
          }
        }
        // the next tile's x into L2 while this tile's rs passes run
        const int nt = tile + gridDim.x;
        if (nt < n_tiles) {
          const int nb = nt / per_stream, n0 = (nt - nb * per_stream) * BM;
          for (int k = 0; k < 3 * C; k += kBK)
            prefetch3(&m.x, k % C, n0 + (k / C - 1) * d, nb);
        }
        for (int p = 0; p < NP2; ++p) {
          for (int kc = 0; kc < K::K2S; ++kc) {
            next(K::WB, dst, bar);
            tma2(dst, &m.w2, kc * kBK, p * N1, bar);
          }
          // the output stages: x's rows for the residual where the
          // columns are x', else an empty slot
          for (int e = 0; e < 2; ++e) {
            const int c0 = p * N1 + e * HALF;
            if (!LAST && c0 < C) {
              next(K::CB, dst, bar);
              for (int i = 0; i < K::CBOX; ++i)
                tma3(dst + i * K::XB, &m.x, c0 + 64 * i, t0, bi, bar);
            } else {
              next(0, dst, bar);
            }
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int w = (threadIdx.x >> 5) & 3, l = threadIdx.x & 31;
    // this thread's tile rows rt and rt + 8 (wgmma's accumulator layout:
    // rows 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4) (+ 1)); rt % 8,
    // the swizzle's row phase, is l / 4 for both
    const int rt = 64 * wg + 16 * w + (l >> 2), sw = l >> 2;
    const int c2 = 2 * (l & 3);
    int slot = 0;
    uint32_t phase = 0;
    auto wait_full = [&]() {
      mbar_wait(full + 8 * slot, phase);
      const int s = slot;
      if (++slot == S) slot = 0, phase ^= 1;
      return s;
    };
    auto release = [&](int s) {
      __syncwarp();
      if (l == 0) mbar_arrive(empty + 8 * s);
    };
    // byte offset of (row r, column 8 j + c2) in a stage of 64-column
    // boxes of BM swizzled rows
    auto at = [&](int r, int j) {
      return (j >> 3) * K::XB + r * kRow + (((j & 7) ^ sw) << 4) + 2 * c2;
    };
    float acc[N1 / 2];
    // the k stages of one product: A at a_at(kc) + this warpgroup's rows,
    // B at b_off in the stage's slot; one wgmma group stays in flight and
    // a slot is released once its group is done
    auto product = [&](int stages, auto a_at, uint32_t b_off) {
      int prev = -1;
      for (int kc = 0; kc < stages; ++kc) {
        const int s = wait_full();
        const uint32_t st = ring + s * K::SLOT;
        const uint32_t a = a_at(kc, st) + wg * 64 * kRow;
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kBK / 16; ++ks)
          wgmma_ss<N1>(acc, desc(a + 32 * ks), desc(st + b_off + 32 * ks),
                       kc | ks);
        wgmma_commit();
        if (prev >= 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      release(prev);
    };

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int bi = tile / per_stream, t0 = (tile - bi * per_stream) * BM;
      for (int h = 0; h < K::NH; ++h) {
        product(K::K1S, [](int, uint32_t st) { return st; }, K::XB);
        // the gate of pass h: channels h N1 / 2 + 8 q + c2 (+ 1), tanh
        // from n-block 2 q and cond's tanh half, sigmoid from 2 q + 1 and
        // the sigmoid half; z rounded once into z's box of its channel
        const int sa = wait_full(), sb = wait_full();
        const unsigned char* ct = ring_p + sa * K::SLOT;
        const unsigned char* cs = ring_p + sb * K::SLOT;
#pragma unroll
        for (int q = 0; q < N1 / 16; ++q) {
          const int ch = h * HALF + 8 * q + c2;
          const float2 bt = unpack(ldg32(b + ch));
          const float2 bs = unpack(ldg32(b + C + ch));
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int r = rt + 8 * hr;
            const float2 vt = unpack(
                *reinterpret_cast<const uint32_t*>(ct + at(r, q)));
            const float2 vs = unpack(
                *reinterpret_cast<const uint32_t*>(cs + at(r, q)));
            const float z0 = gate(acc[8 * q + 2 * hr] + bt.x + vt.x,
                                  acc[8 * q + 4 + 2 * hr] + bs.x + vs.x);
            const float z1 = gate(acc[8 * q + 2 * hr + 1] + bt.y + vt.y,
                                  acc[8 * q + 5 + 2 * hr] + bs.y + vs.y);
            *reinterpret_cast<uint32_t*>(z_p + at(r, ch >> 3)) =
                bf16x2(z0, z1);
          }
        }
        // cond's slots go back to the copy engine; z's stores become
        // visible to wgmma's (async) reads
        fence_proxy_async();
        release(sa);
        release(sb);
      }
      // every warp's rows of z are in before the warpgroup reads them
      wg_sync(wg);
      for (int p = 0; p < NP2; ++p) {
        product(K::K2S, [&](int kc, uint32_t) { return zs + kc * K::XB; },
                0);
        // res/skip of rs pass p, half e at a time: columns c0 + 8 j + c2
        // (+ 1) written into the output stage's slot (x' over the x rows
        // that came in it), then stored by TMA, 64 rows a warpgroup
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c0 = p * N1 + e * HALF;
          const bool xprime = !LAST && c0 < C;
          const int s = wait_full();
          unsigned char* const o = ring_p + s * K::SLOT;
#pragma unroll
          for (int j = 0; j < HALF / 8; ++j) {
            const int col = c0 + 8 * j + c2;
            const float2 br = NRS % N1 == 0 || col < NRS
                ? unpack(ldg32(b_rs + col)) : make_float2(0.f, 0.f);
            const int n = 4 * e * HALF / 8;   // this half's n-blocks
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              uint32_t* const q = reinterpret_cast<uint32_t*>(
                  o + at(rt + 8 * hr, j));
              const float v0 = acc[n + 4 * j + 2 * hr] + br.x;
              const float v1 = acc[n + 4 * j + 2 * hr + 1] + br.y;
              if (xprime) {
                const float2 xv = unpack(*q);
                *q = t0 + rt + 8 * hr < T ? bf16x2(xv.x + v0, xv.y + v1)
                                          : 0u;
              } else {
                *q = bf16x2(v0, v1);
              }
            }
          }
          fence_proxy_async();
          wg_sync(wg);
          if ((threadIdx.x & 127) == 0) {
            const CUtensorMap* map = xprime ? &m.x_out : &m.skip;
            for (int i = 0; i < K::CBOX; ++i)
              tma_store3(map, ring + s * K::SLOT + i * K::XB
                              + wg * 64 * kRow,
                         c0 - (xprime || LAST ? 0 : C) + 64 * i,
                         t0 + 64 * wg, bi);
            store_wait_read();
          }
          release(s);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry
// point (no -lcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static const EncodeFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q)
            != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeFn>(p);
  }();
  return fn;
}

// a bf16 map of rank 2 or 3 (dims innermost first, strides in bytes of
// dims 1 ..), boxes of 64 x rows (x 1), 128-byte swizzle, zeros outside
int encode(CUtensorMap* m, const void* ptr, int rank, const cuuint64_t* dims,
           const cuuint64_t* strides, cuuint32_t rows) {
  const EncodeFn fn = encoder();
  if (!fn) return kErrNoEncoder;
  const cuuint32_t box[3] = {kBK, rows, 1}, one[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(ptr), dims, strides, box, one,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0 : kErrEncode;
}

struct Args {
  const void *x, *cond, *b, *b_rs, *w1, *w2;
  void *x_out, *skip;
  int d, ldc, B, T, Tp, grid;
};

// x (B, Tp, C) as (C, T, B): rows t >= T read as zeros; cond rows of 2C
// (row stride ldc) as (2C, Tp, B); w1 (2C, 3C) and w2 (n_rs, C), the
// transposed packs of ops/wavenet.py:wn_pack_weights; x' and skip (B, Tp,
// C) as (C, Tp, B), rows past Tp dropped
template <class K, bool LAST>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int C = K::C;
  constexpr cuuint64_t E = 2;                    // bytes a bf16
  Maps m;
  const cuuint64_t xd[3] = {C, (cuuint64_t)a.T, (cuuint64_t)a.B};
  const cuuint64_t od[3] = {C, (cuuint64_t)a.Tp, (cuuint64_t)a.B};
  const cuuint64_t xs[2] = {C * E, (cuuint64_t)a.Tp * C * E};
  const cuuint64_t cd[3] = {2 * C, (cuuint64_t)a.Tp, (cuuint64_t)a.B};
  const cuuint64_t cstr[2] = {(cuuint64_t)a.ldc * E,
                              (cuuint64_t)a.Tp * a.ldc * E};
  const cuuint64_t w1d[2] = {3 * C, 2 * C}, w1s[1] = {3 * C * E};
  const cuuint64_t w2d[2] = {C, LAST ? C : 2 * C}, w2s[1] = {C * E};
  int err = encode(&m.x, a.x, 3, xd, xs, K::BM);
  if (!err) err = encode(&m.cond, a.cond, 3, cd, cstr, K::BM);
  if (!err) err = encode(&m.w1, a.w1, 2, w1d, w1s, K::N1);
  if (!err) err = encode(&m.w2, a.w2, 2, w2d, w2s, K::N1);
  if (!err) err = encode(&m.skip, a.skip, 3, od, xs, 64);
  if (!err) err = encode(&m.x_out, LAST ? a.skip : a.x_out, 3, od, xs, 64);
  if (err) return err;
  auto* k = wn16_kernel<K, LAST>;
  // the shared-memory opt-in, once a device (and so never inside a graph
  // capture: callers warm up first); past 64 devices, every launch
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if (dev >= 64 || !smem_set[dev]) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             K::SMEM);
    if (e) return e;
    if (dev < 64) smem_set[dev] = true;
  }
  const int n_tiles = a.B * ((a.Tp + K::BM - 1) / K::BM);
  k<<<a.grid, K::THREADS, K::SMEM, stream>>>(
      m, static_cast<const __nv_bfloat16*>(a.b),
      static_cast<const __nv_bfloat16*>(a.b_rs), a.d, a.T, a.Tp, n_tiles);
  return cudaGetLastError();
}

template <class K>
int config(bool last, int* cfg, const Args* args, cudaStream_t stream) {
  cfg[0] = K::NH;
  cfg[1] = K::S;
  cfg[2] = K::SMEM;
  if (!args) return 0;
  return last ? launch<K, true>(*args, stream)
              : launch<K, false>(*args, stream);
}

// The (C, rows a tile) builds with their acts columns a pass and ring
// slots (ops/wavenet.py:WN_BF16_BUILDS); launches the layer when args is
// given.
int dispatch(int C, int bm, bool last, int* cfg, const Args* args,
             cudaStream_t stream) {
#define WN16_CASE(C_, BM_, N1_, S_)                                      \
  if (C == C_ && bm == BM_)                                              \
    return config<Cfg<C_, BM_ / 64, N1_, S_>>(last, cfg, args, stream);
  WN16_CASE(64, 128, 128, 4)
  WN16_CASE(128, 128, 256, 4)
  WN16_CASE(256, 128, 256, 3)
  WN16_CASE(256, 64, 256, 4)
  WN16_CASE(512, 64, 256, 4)
  WN16_CASE(1024, 64, 128, 4)
#undef WN16_CASE
  return cudaErrorInvalidValue;
}

}  // namespace wn16
}  // namespace
