// K2: one WaveGlow WN layer, fp32 or bf16 in and out, products on the
// tensor cores. Two bodies behind one entry point, wn_layer_launch: this
// file's kernel is the fp32 body; the bf16 body is its own kernel, in
// wavenet_bf16.cuh (included below), whose note says its design.
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
// What bounds it on an H100: tensor-core operations. At C = 256 a row
// costs 2 * (768 * 512 + 256 * 512) = 1.05 MFLOP of fp32 math against 3 KB
// of row traffic. The products keep fp32 accuracy as three bf16 passes:
// each operand a is split into hi = bf16(a) and lo = bf16(a - hi), and
// hi*hi + hi*lo + lo*hi is summed in fp32 (lo*lo, ~2^-16 of the product,
// is dropped; the CPU emulation in tests/test_torch_port_wavenet.py holds
// this within 1e-5 of the output scale). So a flagship layer at B=1, 12800
// rows, is 40.3 G bf16 operations, 0.041 ms at the 989 TFLOP/s peak,
// against 67.6 MB of traffic, 0.020 ms at 3.35 TB/s. One pass of tf32 or
// of bf16 misses the 1e-4 bar (2.7e-4 and 2.2e-3); three tf32 passes would
// run at half the bf16 rate.
//
// The design (mma.sync m16n8k16, one block a SM):
// - A block owns BM = 16 MT rows and all 2C columns of acts, walked in NH
//   passes of 2C / NH columns (NH = 2 lets BM reach 112 rows, whose
//   accumulators would not fit the registers in one pass). Each of its 8
//   warps takes every row and an eighth of the pass's columns.
//   The weights are packed by the host (ops/wavenet.py:wn_split_weights),
//   split into bf16 hi/lo once a layer, with W_cat's columns paired so
//   that n-tile 2j is the tanh half and 2j + 1 the sigmoid half of the
//   same 8 channels: the gate runs on a thread's own accumulators.
// - K is walked in chunks of 16 (one mma k-step) through a ring of S
//   stages filled by cp.async: the chunk's weights (16 rows, hi and lo,
//   contiguous in the packed layout, L2-resident since every block reads
//   them) and, in the first product, the fp32 x rows of the chunk's tap
//   (rows t - d, t, t + d of the same stream; cp.async zero-fills rows
//   outside [0, T), so the shift stays inside the kernel). Each thread
//   splits the x pieces it copied itself into a double-buffered bf16 hi/lo
//   A tile one chunk ahead of the mma's, so a chunk costs one block
//   barrier and the next chunks' copies are in flight during its mma's.
// - z leaves the gate split into bf16 hi/lo in shared memory and is the
//   A operand of the res/skip product: it never leaves the SM. With NH = 1
//   it overlays the x ring, idle by then; the weights of the res/skip
//   product stream through the same ring, its first chunks already in
//   flight during the first product's last ones.
// - The epilogues load an m-tile's cond (gate) or x (residual) values
//   together before its arithmetic; tanh and sigmoid are branch-free
//   (ex2.approx, ~1e-6).
// - Shared-memory tiles are XOR-swizzled by 16-byte piece, so ldmatrix
//   and the stores of z meet no bank conflicts.
// - Pad rows (t >= T) of x' are re-zeroed on the store, so a bias never
//   leaks into valid rows through the next layer's shift. Every sum has
//   one owner and a fixed order (no atomics): two calls are bitwise equal.
// What holds it (PERF.md §6, K2): on an H100 a flagship layer at B=1 runs
// at about a fifth of the bf16 peak. Neither the tensor cores nor L2 set
// that: a chunk's copies, barrier, ldmatrix traffic and the epilogues add
// up in series; 16 warps a block instead of 8, a deeper ring and wgmma
// in place of mma.sync did not hide them. A producer warp feeding a
// decoupled ring is the next step: the bf16 body took it
// (wavenet_bf16.cuh); on this body's three passes it is untried.
// BM and NH come from ops/wavenet.py:wn_plan and WN_BUILDS; each (C, BM)
// is instantiated below. Past C = 256, z (2 * BM * C * 2 bytes) and the
// weight ring no longer fit one pass of 64 rows: C = 512 walks the columns
// in 4 passes at 64 rows or 2 at 32, C = 1024 in 8 at 32 rows (z alone is
// 256 KB at 64). Each pass stages x again, and every block reads all of a
// layer's weights from L2 for its BM rows, so these builds are right but
// not fast (PERF.md §6, K2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "wavenet_bf16.cuh"

namespace {

constexpr int kKC = 16;         // k rows a chunk: one m16n8k16 step
constexpr int kMaxSmem = 232448;

// fp32 pair -> bf16x2 (x0 in the low half), round to nearest even
__device__ __forceinline__ uint32_t bf16x2(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// hi = bf16(x), lo = bf16(x - hi), two values at a time
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  hi = bf16x2(x0, x1);
  lo = bf16x2(x0 - __uint_as_float(hi << 16),
              x1 - __uint_as_float(hi & 0xffff0000u));
}

// two neighbouring values (8-byte aligned), and back
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

// tanh and sigmoid without branches, from ex2.approx: within ~1e-6 of
// the correctly rounded values for the inputs a layer meets, so the gate's
// loads can be issued together ahead of its arithmetic
__device__ __forceinline__ float tanh_(float a) {
  const float e = __expf(-2.f * fabsf(a));
  return copysignf(__fdividef(1.f - e, 1.f + e), a);
}

__device__ __forceinline__ float sigmoid_(float a) {
  return __frcp_rn(1.f + __expf(-a));
}


// shared memory of a block: S weight stages, and the x stages and A
// tiles (ab bytes) beside z (zb bytes; NH = 1: z overlays them, idle by
// then)
constexpr int smem_bytes(int nh, int s, int slot, int xslot, int ab,
                         int zb) {
  return s * slot + (nh == 1 ? (zb > s * xslot + ab ? zb : s * xslot + ab)
                             : zb + s * xslot + ab);
}

constexpr int kThreads = 256;   // 8 warps

template <int MT, int NT, int NH, bool LAST>
struct Cfg {
  static constexpr int BM = 16 * MT;
  static constexpr int C = 32 * NT * NH;
  static constexpr int W1 = 2 * C / NH;   // packed acts columns a pass
  static constexpr int NP2 = LAST ? (NH > 1 ? NH / 2 : 1) : NH;
  static constexpr int W2 = (LAST ? C : 2 * C) / NP2;   // rs columns a pass
  static constexpr int NT2 = W2 / 64;     // n-tiles a warp in the rs product
  static constexpr int NC1 = 3 * C / kKC, NC2 = C / kKC;
  static constexpr int P1_CHUNKS = NH * NC1;
  static constexpr int CHUNKS = P1_CHUNKS + NP2 * NC2;
  static constexpr int WP = 2;                // weight planes (hi, lo)
  static constexpr int XPR = 4;               // 16-byte x pieces a row
  static constexpr int SLOT = kKC * W1 * 2 * WP;   // a weight stage
  static constexpr int XSLOT = BM * kKC * 4;  // an x stage
  static constexpr int ABUF = BM * kKC * 2;   // an A tile, one of hi / lo
  static constexpr int AB = 4 * ABUF;         // the A tiles
  static constexpr int ZBUF = BM * C * 2;     // z, one of hi / lo
  static constexpr int ZB = 2 * ZBUF;
  static constexpr int S =
      smem_bytes(NH, 4, SLOT, XSLOT, AB, ZB) <= kMaxSmem ? 4 : 3;
  static constexpr int SMEM = smem_bytes(NH, S, SLOT, XSLOT, AB, ZB);
  static constexpr int XOFF = S * SLOT + (NH == 1 ? 0 : ZB);
  static_assert(W2 <= W1 && NT2 <= NT && NT2 >= 1, "rs tiling");
  static_assert((W1 & (W1 - 1)) == 0 && (W2 & (W2 - 1)) == 0, "pow2");
  static_assert(W2 * WP >= 64, "a weight row spans the 8-piece swizzle");
  static_assert(SMEM <= kMaxSmem, "shared memory");
};

template <int MT, int NT, int NH, bool LAST>
__global__ void __launch_bounds__(kThreads, 1)
wn_layer_kernel(const float* __restrict__ x, int d,
                const float* __restrict__ cond, int ldc,
                const uint16_t* __restrict__ w1, const float* __restrict__ b,
                const uint16_t* __restrict__ w2,
                const float* __restrict__ b_rs, float* __restrict__ x_out,
                float* __restrict__ skip, int M, int T, int Tp) {
  using K = Cfg<MT, NT, NH, LAST>;
  using E = float;
  constexpr int C = K::C, BM = K::BM, S = K::S, WP = K::WP, XPR = K::XPR;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* zhi = smem + S * K::SLOT;
  unsigned char* zlo = zhi + K::ZBUF;
  unsigned char* xring = smem + K::XOFF;
  unsigned char* abuf = xring + S * K::XSLOT;   // [2][hi, lo]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BM;

  // the x pieces this thread copies and splits: 16 bytes (4 channels) of
  // a row; the row's stream offset and time step are fixed for the call
  constexpr int XP = (BM * XPR + kThreads - 1) / kThreads;
  constexpr int XCH = 16 / sizeof(E);            // channels a piece
  int x_base[XP], x_t[XP];
#pragma unroll
  for (int i = 0; i < XP; ++i) {
    const int q = tid + i * kThreads;
    const int g = row0 + q / XPR;
    const int s = g / Tp;
    x_base[i] = s * Tp;
    x_t[i] = (q < BM * XPR && g < M) ? g - s * Tp : -(1 << 30);
  }

  // chunk gc: weights into ring slot gc % S, and (first product) x as it
  // is, split later by convert
  auto issue = [&](int gc) {
    if (gc < K::CHUNKS) {
      unsigned char* slot = ring + (gc % S) * K::SLOT;
      const uint16_t* src;
      int w;
      if (gc < K::P1_CHUNKS) {
        const int h = gc / K::NC1, kc = gc - h * K::NC1;
        src = w1 + ((size_t)h * 3 * C + kc * kKC) * WP * K::W1;
        w = K::W1;
        const int tap = kc * kKC / C, ch0 = kc * kKC - tap * C;
        const int shift = (tap - 1) * d;
        unsigned char* xs = xring + (gc % S) * K::XSLOT;
#pragma unroll
        for (int i = 0; i < XP; ++i) {
          const int q = tid + i * kThreads;
          if (q < BM * XPR) {
            const int t = x_t[i] + shift;
            const bool ok = t >= 0 && t < T;
            const int part = q % XPR;
            const E* p = ok ? x + ((size_t)(x_base[i] + t) * C + ch0
                                   + XCH * part)
                            : x;
            cp_async16_zfill(xs + q * 16, p, ok ? 16 : 0);
          }
        }
      } else {
        const int g2 = gc - K::P1_CHUNKS;
        const int h = g2 / K::NC2, kc = g2 - h * K::NC2;
        src = w2 + ((size_t)h * C + kc * kKC) * WP * K::W2;
        w = K::W2;
      }
      // 16 rows of [hi w | lo w] bf16, pieces of 16 bytes a row a power
      // of two; piece p of row k lands at p ^ (k & 7)
      const int pieces = w * WP / 8, lg = 31 - __clz(pieces);
      for (int q = tid; q < kKC * pieces; q += kThreads) {
        const int k = q >> lg, p = q & (pieces - 1);
        cp_async16(slot + k * w * WP * 2 + ((p ^ (k & 7)) << 4), src + q * 8);
      }
    }
    cp_async_commit();
  };

  // split the x pieces of chunk gc into A tile gc & 1 (rows of 32
  // bytes, piece p of row r at p ^ ((r >> 2) & 1))
  auto convert = [&](int gc) {
    const unsigned char* xs = xring + (gc % S) * K::XSLOT;
    unsigned char* ah = abuf + (gc & 1) * 2 * K::ABUF;
    unsigned char* al = ah + K::ABUF;
#pragma unroll
    for (int i = 0; i < XP; ++i) {
      const int q = tid + i * kThreads;
      if (q < BM * 4) {
        const float4 v = *reinterpret_cast<const float4*>(xs + q * 16);
        uint2 hi, lo;
        split2(v.x, v.y, hi.x, lo.x);
        split2(v.z, v.w, hi.y, lo.y);
        const int r = q >> 2, part = q & 3;
        const int off = r * 32 + ((((part >> 1) ^ (r >> 2)) & 1) << 4)
                        + ((part & 1) << 3);
        *reinterpret_cast<uint2*>(ah + off) = hi;
        *reinterpret_cast<uint2*>(al + off) = lo;
      }
    }
  };

  float acc[MT][NT][4];
  auto zero = [&]() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  };
  zero();

  // acc[i][j] += A(m-tile i) * B(n-tile j) as three bf16 passes; B:
  // n-tile j of this warp in a weight stage of rows [hi w | lo w]; A rows
  // from a_at(i): this lane's ldmatrix addresses of the hi and lo tiles
  auto mma_chunk = [&](const unsigned char* slot, int w, int nt,
                       auto a_at) {
    uint32_t bf[NT][4];
    const int k = lane & 15;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < nt) {
        const int p = warp * nt + j + (lane >> 4) * (w >> 3);
        ldmatrix_x4<true>(bf[j], slot + k * w * 4 + ((p ^ (k & 7)) << 4));
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t ah[4], al[4];
      const unsigned char *ph, *pl;
      a_at(i, ph, pl);
      ldmatrix_x4<false>(ah, ph);
      ldmatrix_x4<false>(al, pl);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          mma_bf16(acc[i][j], ah, bf[j][0], bf[j][1]);     // hi * hi
          mma_bf16(acc[i][j], ah, bf[j][2], bf[j][3]);     // hi * lo
          mma_bf16(acc[i][j], al, bf[j][0], bf[j][1]);     // lo * hi
        }
      }
    }
  };

  // gate of pass h: z for channels 8 q .. 8 q + 7 of each n-tile pair,
  // into z hi / lo (rows of C bf16, piece p of row r at p ^ (r & 7)). An
  // m-tile's cond values are loaded together before its arithmetic (rows
  // past M read row M - 1: their z is never stored).
  auto gate = [&](int h) {
    int ch[NT / 2];
    float2 bt[NT / 2], bs[NT / 2];
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      ch[j] = 8 * (h * (C / NH / 8) + warp * (NT / 2) + j) + 2 * (lane & 3);
      bt[j] = ld2(b + ch[j]);
      bs[j] = ld2(b + C + ch[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float2 ct[2][NT / 2], cs[2][NT / 2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int g = min(row0 + 16 * i + (lane >> 2) + 8 * hr, M - 1);
        const E* crow = cond + (size_t)g * ldc;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          ct[hr][j] = ld2(crow + ch[j]);
          cs[hr][j] = ld2(crow + C + ch[j]);
        }
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * i + (lane >> 2) + 8 * hr;
#pragma unroll
        for (int j = 0; j < NT / 2; ++j) {
          const float z0 =
              tanh_(acc[i][2 * j][2 * hr] + bt[j].x + ct[hr][j].x)
              * sigmoid_(acc[i][2 * j + 1][2 * hr] + bs[j].x + cs[hr][j].x);
          const float z1 =
              tanh_(acc[i][2 * j][2 * hr + 1] + bt[j].y + ct[hr][j].y)
              * sigmoid_(acc[i][2 * j + 1][2 * hr + 1] + bs[j].y
                         + cs[hr][j].y);
          const int p = ch[j] >> 3;
          const int off = r * C * 2 + ((((p ^ r) & 7) | (p & ~7)) << 4)
                          + ((ch[j] & 7) << 1);
          uint32_t hi, lo;
          split2(z0, z1, hi, lo);
          *reinterpret_cast<uint32_t*>(zhi + off) = hi;
          *reinterpret_cast<uint32_t*>(zlo + off) = lo;
        }
      }
    }
  };

  // res/skip epilogue of rs pass h; an m-tile's x values are loaded
  // together before its stores
  auto store = [&](int h) {
    int col[K::NT2];
    float2 br[K::NT2];
#pragma unroll
    for (int j = 0; j < K::NT2; ++j) {
      col[j] = h * K::W2 + (warp * K::NT2 + j) * 8 + 2 * (lane & 3);
      br[j] = ld2(b_rs + col[j]);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      int g[2];
      float2 xv[2][K::NT2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        g[hr] = row0 + 16 * i + (lane >> 2) + 8 * hr;
        const E* xrow = x + (size_t)min(g[hr], M - 1) * C;
#pragma unroll
        for (int j = 0; j < K::NT2; ++j)
          if (!LAST && col[j] < C) xv[hr][j] = ld2(xrow + col[j]);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (g[hr] >= M) continue;
        const bool valid = g[hr] % Tp < T;
#pragma unroll
        for (int j = 0; j < K::NT2; ++j) {
          const float2 v = make_float2(acc[i][j][2 * hr] + br[j].x,
                                       acc[i][j][2 * hr + 1] + br[j].y);
          const size_t o = (size_t)g[hr] * C + col[j];
          if (LAST) {
            st2(skip + o, v);
          } else if (col[j] < C) {
            st2(x_out + o, valid ? make_float2(xv[hr][j].x + v.x,
                                               xv[hr][j].y + v.y)
                                 : make_float2(0.f, 0.f));
          } else {
            st2(skip + o - C, v);
          }
        }
      }
    }
  };

  // the A operands' lane addresses: lane l reads row 16 i + (l & 15),
  // k half l >> 4 of the chunk
  const int ar = lane & 15, ak = lane >> 4;

#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) issue(s);
  cp_async_wait<S - 2>();
  convert(0);

#pragma unroll 1
  for (int gc = 0; gc < K::CHUNKS; ++gc) {
    cp_async_wait<S - 3>();   // this thread's copies of chunks <= gc + 1
    __syncthreads();          // everyone's chunk gc; slot gc - 1 is free
    issue(gc + S - 1);
    const unsigned char* slot = ring + (gc % S) * K::SLOT;
    if (gc < K::P1_CHUNKS) {
      if (gc + 1 < K::P1_CHUNKS) convert(gc + 1);
      const unsigned char* ah = abuf + (gc & 1) * 2 * K::ABUF;
      mma_chunk(slot, K::W1, NT, [&](int i, const unsigned char*& ph,
                                     const unsigned char*& pl) {
        const int r = 16 * i + ar;
        const int off = r * 32 + (((ak ^ (r >> 2)) & 1) << 4);
        ph = ah + off;
        pl = ah + K::ABUF + off;
      });
      if (gc % K::NC1 == K::NC1 - 1) {
        if (NH == 1) __syncthreads();   // z overlays the A tiles / x ring
        gate(gc / K::NC1);
        zero();
      }
    } else {
      const int g2 = gc - K::P1_CHUNKS;
      const int h = g2 / K::NC2, kc = g2 - h * K::NC2;
      mma_chunk(slot, K::W2, K::NT2, [&](int i, const unsigned char*& ph,
                                         const unsigned char*& pl) {
        const int r = 16 * i + ar;
        const int p = 2 * kc + ak;
        const int off = r * C * 2 + ((((p ^ r) & 7) | (p & ~7)) << 4);
        ph = zhi + off;
        pl = zlo + off;
      });
      if (kc == K::NC2 - 1) {
        store(h);
        zero();
      }
    }
  }
  cp_async_wait<0>();
}

struct Args {
  const void *x, *cond, *b, *b_rs;
  const uint16_t *w1, *w2;
  void *x_out, *skip;
  int d, ldc, M, T, Tp;
};

template <int MT, int NT, int NH, bool LAST>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using K = Cfg<MT, NT, NH, LAST>;
  auto* k = wn_layer_kernel<MT, NT, NH, LAST>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err) return err;
  const int grid = (a.M + K::BM - 1) / K::BM;
  k<<<grid, kThreads, K::SMEM, stream>>>(
      static_cast<const float*>(a.x), a.d,
      static_cast<const float*>(a.cond), a.ldc, a.w1,
      static_cast<const float*>(a.b), a.w2,
      static_cast<const float*>(a.b_rs), static_cast<float*>(a.x_out),
      static_cast<float*>(a.skip), a.M, a.T, a.Tp);
  return cudaGetLastError();
}

template <int MT, int NT, int NH>
cudaError_t config(bool last, int* cfg, const Args* args,
                   cudaStream_t stream) {
  using K = Cfg<MT, NT, NH, false>;
  cfg[0] = NH;
  cfg[1] = K::S;
  cfg[2] = K::SMEM;
  if (!args) return cudaSuccess;
  return last ? launch<MT, NT, NH, true>(*args, stream)
              : launch<MT, NT, NH, false>(*args, stream);
}

// The fp32 body's (C, bm) pairs with their passes NH, ring stages and
// shared memory; launches the layer when args is given.
cudaError_t dispatch(int C, int bm, bool last, int* cfg, const Args* args,
                     cudaStream_t stream) {
#define WN_CASE(C_, BM_, NT_, NH_)                                         \
  if (C == C_ && bm == BM_)                                                \
    return config<BM_ / 16, NT_, NH_>(last, cfg, args, stream);
  WN_CASE(64, 64, 2, 1)
  WN_CASE(128, 64, 4, 1)
  WN_CASE(256, 64, 8, 1)
  WN_CASE(256, 112, 4, 2)
  WN_CASE(512, 64, 4, 4)
  WN_CASE(512, 32, 8, 2)
  WN_CASE(1024, 32, 4, 8)
#undef WN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* wavenet_error_string(int err) {
  if (err == wn16::kErrNoEncoder)
    return "cuTensorMapEncodeTiled not found through "
           "cudaGetDriverEntryPoint (driver too old for TMA?)";
  if (err == wn16::kErrEncode)
    return "cuTensorMapEncodeTiled refused a tensor map (alignment, "
           "strides or extents)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The build's (C, bm) pairs for fp32 (bf16 = 0) or bf16: 0 with cfg =
// {column passes, ring stages, shared memory bytes} of the launch, or an
// error for a pair not built. bm is rows a block (fp32) or a tile (bf16).
int wn_layer_config(int C, int bm, int bf16, int* cfg) {
  return bf16 ? wn16::dispatch(C, bm, false, cfg, nullptr, nullptr)
              : dispatch(C, bm, false, cfg, nullptr, nullptr);
}

// x (B, Tp, C); cond rows of 2C elements with row stride ldc; b (2C);
// b_rs (2C), or (C) when last. Outputs x_out (B, Tp, C) (unused when last)
// and skip (B, Tp, C). bf16 = 0: every tensor fp32, w1 and w2 the bf16
// hi/lo packs of ops/wavenet.py:wn_split_weights for this bm's NH, ldc a
// multiple of 4, grid unused (one block a bm rows). bf16 != 0, the body
// the Pallas kernel runs on bf16 (wavenet_bf16.cuh): every tensor bf16,
// w1 (2C, 3C) and w2 (n_rs, C) the transposed packs of
// ops/wavenet.py:wn_pack_weights, ldc a multiple of 8 (TMA's 16-byte
// strides), grid blocks walking the B ceil(Tp / bm) tiles. Tensors
// 16-byte aligned.
int wn_layer_launch(int bf16, const void* x, int d, const void* cond,
                    int ldc, const void* w1, const void* b, const void* w2,
                    const void* b_rs, void* x_out, void* skip, int B, int Tp,
                    int T, int C, int bm, int last, void* stream_handle,
                    int grid) {
  if (ldc % (bf16 ? 8 : 4) != 0 || T < 1 || T > Tp)
    return cudaErrorInvalidValue;
  const auto stream = static_cast<cudaStream_t>(stream_handle);
  int cfg[3];
  if (bf16) {
    if (grid < 1) return cudaErrorInvalidValue;
    const wn16::Args args{x, cond, b, b_rs, w1, w2, x_out, skip,
                          d, ldc, B, T, Tp, grid};
    return wn16::dispatch(C, bm, last != 0, cfg, &args, stream);
  }
  const Args args{x, cond, b, b_rs, static_cast<const uint16_t*>(w1),
                  static_cast<const uint16_t*>(w2), x_out, skip, d, ldc,
                  B * Tp, T, Tp};
  return dispatch(C, bm, last != 0, cfg, &args, stream);
}

}  // extern "C"
