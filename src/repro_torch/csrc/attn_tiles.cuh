// Shared attention tiles for the prefill, decode and unified P/D kernels.
//
// One CTA of THREADS threads runs one tile at a time (the unified kernel's
// persistent CTAs run many, one after another):
//   flash_tile_tc - bf16: BQ query rows of one (batch, q-head) against the
//                   causal (and window) range of keys, in k-blocks of BK
//                   keys, both products on the tensor cores (wgmma);
//   flash_tile    - float32: the same tile on CUDA cores (float32 FMAs);
//   paged_tile    - the G query heads of one (sequence, kv-head) against
//                   one split of SPLIT keys of the sequence's paged KV,
//                   in chunks of BK keys gathered through its block-table
//                   row; the last split to finish merges all of them.
// All keep the reference's masking convention: masked scores are the
// finite NEG_INF = -1e30 and the row sum is clamped to 1e-30, so a fully
// masked row comes out finite.  Every product accumulates in float32.  The
// unified kernel calls these same functions, so its outputs equal the
// standalone kernels' bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // one block size for every tile kind
constexpr int BQ = 64;        // query rows of a prefill tile
constexpr int BK = 64;        // keys per inner step (k-block / decode chunk)
static_assert(BQ == 64 && BK == 64 && THREADS == 256,
              "thread maps below assume 16x16 threads over 64x64 tiles");
constexpr int MAX_G = 8;      // query heads of a decode tile (Hq / Hkv)
constexpr int SPLIT = 256;    // keys of one decode CTA

enum TileKind { PREFILL = 0, DECODE = 1 };

// CTAs per SM the kernels are compiled for.  bf16: two, so two consumer
// warpgroups share an SM and ptxas holds the kernel to 128 registers a
// thread (the tensor-core tile's consumer fits them without spills).
// float32: one (its CUDA-core prefill tile takes 115.5 KB of shared memory).
template <typename T> struct MinCtas { static constexpr int value = 1; };
template <> struct MinCtas<__nv_bfloat16> { static constexpr int value = 2; };

// The thread's index in its CTA, for the tiles.  The unified kernel runs
// its tiles in a loop, and the compiler hoists what a tile computes from
// threadIdx.x out of the loop, where it holds registers across the tiles
// of both kinds.  At D = 16 that pushed the bf16 kernel past the 128
// registers that two CTAs an SM allow, into a spill; %tid.x read with asm
// volatile cannot be hoisted.  At the other head dims reading it anew
// spilled instead, so they keep threadIdx.x.
template <int D>
__device__ __forceinline__ int tile_thread() {
  if constexpr (D == 16) {
    int t;
    asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
    return t;
  } else {
    return threadIdx.x;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element strides of a (B, H, S, D) view whose last dimension is dense.
struct Strides {
  int64_t b, h, s;
};

struct PrefillArgs {
  const void* q;  // (B, Hq, S, D)
  const void* k;  // (B, Hkv, S, D)
  const void* v;
  void* o;        // (B, Hq, S, D)
  Strides sq, sk, sv, so;
  int S, Hq, Hkv;
  int window;     // <= 0: no sliding window
  float sm_scale;
};

struct DecodeArgs {
  const void* q;        // (B, Hq, D) dense
  const void* k_pages;  // (N, page, Hkv, D) dense
  const void* v_pages;
  const int* tables;    // (B, max_pages)
  const int* lens;      // (B,)
  void* o;              // (B, Hq, D) dense
  float* part;          // (B, Hkv, splits, G, D + 2) float32 workspace
  int* count;           // (>= B * Hkv,) zero between launches
  int Hq, Hkv, page, max_pages, splits;
  float sm_scale;
};

template <int D>
__host__ __device__ constexpr int flash_smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

// The tensor-core tile: Q, a ring of STAGES K and V k-blocks, all bf16,
// their full/empty barriers, and 1 KB of slack to align the tiles to the
// 1024 bytes a 128-byte swizzle repeats over.
constexpr int STAGES = 2;
template <int D>
__host__ __device__ constexpr int flash_tc_smem_bytes() {
  return 1024 + (BQ + 2 * STAGES * BK) * D * 2 + 2 * STAGES * 8;
}

// Keys a warp of the decode tile takes per step: 4 lanes share a key (2
// where a row of D values is only two 16-byte chunks).
__host__ __device__ constexpr int paged_kpw(int D, int elem) {
  return D * elem / 16 < 4 ? 32 / (D * elem / 16) : 8;
}

// The split decode tile: per warp DSTAGES stages of K and V (paged_kpw x
// D, input dtype), later reused for the warps' partials (WARPS x (G*D +
// 2G) float32, never larger); q (G x D) and the warps' probabilities
// (WARPS x G x paged_kpw) in float32; the pool rows of the split's keys;
// the merge weights (splits x G); and the last-CTA flag.
constexpr int DSTAGES = 3;
__host__ __device__ inline int paged_smem_bytes(int D, int G, int elem,
                                                int splits) {
  const int kpw = paged_kpw(D, elem), warps = THREADS / 32;
  return warps * 2 * DSTAGES * kpw * D * elem +
         (G * D + warps * G * kpw + SPLIT + splits * G) * 4 + 16;
}

// ---------------------------------------------------------------------------
// staging and reductions; the float32 prefill tile
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void unpack16(const uint4& u, float* dst) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < static_cast<int>(16 / sizeof(T)); ++j) dst[j] = to_f32(e[j]);
}

// Copies ROWS rows of D elements into shared memory as float32: row r of
// dst_a from src_a(r) and, when TWO, of dst_b from src_b(r); rows r >= n are
// zero.  Every 16-byte load of the tile is issued before the first store, so
// a tile costs one memory latency, not one per element.  Row starts must be
// 16-byte aligned (the wrappers check it).
template <typename T, int ROWS, int D, bool TWO, typename SrcA, typename SrcB>
__device__ __forceinline__ void stage_rows(float* dst_a, int ld_a, float* dst_b,
                                           int ld_b, int n, SrcA src_a,
                                           SrcB src_b) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC;
  constexpr int TOTAL = ROWS * PER_ROW;
  constexpr int ITERS = (TOTAL + THREADS - 1) / THREADS;
  uint4 ra[ITERS], rb[ITERS];
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = i % PER_ROW * VEC;
    const bool ok = i < TOTAL && r < n;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    ra[it] = ok ? *reinterpret_cast<const uint4*>(src_a(r) + c) : zero;
    if (TWO) rb[it] = ok ? *reinterpret_cast<const uint4*>(src_b(r) + c) : zero;
  }
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER_ROW, c = i % PER_ROW * VEC;
    if (i < TOTAL) {
      unpack16<T>(ra[it], dst_a + r * ld_a + c);
      if (TWO) unpack16<T>(rb[it], dst_b + r * ld_b + c);
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Causal flash attention for query rows [qi*BQ, qi*BQ+BQ) of (b, h), on
// CUDA cores: the float32 tile (TF32 tensor cores could not hold float32's
// 3e-5).  Tiles are staged in shared memory as float32.  Thread (ty, tx) =
// (t/16, t%16) owns rows ty+16i and, within a k-block, keys tx+16j and
// output dims tx+16j.  Row max/sum reduce across the 16 threads of a
// half-warp.  The k-block loop stops at the causal bound and
// starts at the window bound; keys past S are zero-filled and masked, rows
// past S are computed but never stored, so no padded copy exists.
template <typename T, int D>
__device__ void flash_tile(const PrefillArgs& a, int b, int h, int qi,
                           float* smem) {
  static_assert(D % 16 == 0 && D <= 128, "D in {16, 32, 64, 128}");
  constexpr int DP = D + 1;  // padded row stride: conflict-free columns
  constexpr int PP = BK + 1;
  constexpr int RPT = BQ / 16, KPT = BK / 16, DPT = D / 16;
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int t = tile_thread<D>(), tx = t % 16, ty = t / 16;
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = qi * BQ;
  const T* q = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* k = static_cast<const T*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const T* v = static_cast<const T*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  T* o = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;

  const auto q_row = [&](int r) { return q + (q0 + r) * a.sq.s; };
  stage_rows<T, BQ, D, false>(Qs, DP, nullptr, 0, min(BQ, a.S - q0), q_row,
                              q_row);

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const int k_end = min(a.S, q0 + BQ);  // causal bound (exclusive)
  int kb = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kb = (q0 - a.window + 1) / BK;
  for (; kb * BK < k_end; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();  // the previous step is done with Ks/Vs/Ps
    stage_rows<T, BK, D, true>(
        Ks, DP, Vs, D, min(BK, a.S - k0),
        [&](int r) { return k + (k0 + r) * a.sk.s; },
        [&](int r) { return v + (k0 + r) * a.sv.s; });
    __syncthreads();

    float sc[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos <= qpos && kpos < a.S &&
                        (a.window <= 0 || kpos > qpos - a.window);
        sc[i][j] = ok ? sc[i][j] * a.sm_scale : NEG_INF;
        rmax = fmaxf(rmax, sc[i][j]);
      }
      rmax = half_warp_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = expf(sc[i][j] - m_new);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        rsum += p;
      }
      rsum = half_warp_sum(rsum);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + c];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s < a.S) {
      const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < DPT; ++j)
        o[s * a.so.s + tx + 16 * j] = from_f32<T>(acc[i][j] / li);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 prefill tile on the tensor cores
// ---------------------------------------------------------------------------

// A row of D bf16 values is stored in column atoms of W bytes (128 for
// D >= 64, else the whole row: 32 or 64 bytes) with wgmma's W-byte swizzle:
// the 16-byte chunk index within a W-byte row is XORed with address bits
// 7 and up.  A tile of R rows is D*2/W atoms of R x W bytes, each aligned
// to 1024 bytes.
template <int D> __host__ __device__ constexpr int swizzle_bytes() {
  return D >= 64 ? 128 : 2 * D;
}
template <int D, int R>
__device__ __forceinline__ uint32_t tile_offset(int r, int chunk) {
  constexpr int W = swizzle_bytes<D>(), CPA = W / 16;
  const uint32_t lin = (chunk / CPA) * (R * W) + r * W + (chunk % CPA) * 16;
  return lin ^ (((lin >> 7) & (CPA - 1)) << 4);
}

// Descriptor of the k-th 16-deep slice of a K-major (rows x D) tile: rows
// 8-row groups SBO = 8*W apart; the slice starts 32*k bytes into its atom.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int k) {
  constexpr int W = swizzle_bytes<D>();
  const uint32_t at = tile + (k * 32 / W) * (R * W) + (k * 32) % W;
  return hopper::smem_desc(at, 16, 8 * W, W);
}

// Descriptor of keys [16k, 16k+16) of a V tile (BK keys x D) read as the
// MN-major B operand (16 keys x D): 8-key groups SBO = 8*W apart, column
// atoms of 64 values LBO = BK*W apart.
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int k) {
  constexpr int W = swizzle_bytes<D>();
  return hopper::smem_desc(tile + k * 16 * W, BK * W, 8 * W, W);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ bool key_visible(int kpos, int qpos, int S,
                                            int window) {
  return kpos <= qpos && kpos < S && (window <= 0 || kpos > qpos - window);
}

// Causal flash attention for query rows [qi*BQ, qi*BQ+BQ) of (b, h), bf16.
//
// Warpgroup 0 (threads 0-127) is the producer: it copies K and V k-blocks
// with 16-byte cp.async into a ring of STAGES swizzled stages and signals
// each stage's `full` barrier when its copies land.  Warpgroup 1 (threads
// 128-255) is the consumer: per k-block, S = Q K^T is D/16 wgmma
// m64n64k16 with Q and K in shared memory; the online softmax runs on the
// accumulator fragments in registers (thread row r = 16*warp + lane/4 and
// r + 8, keys 8j + 2*(lane%4) + {0,1}; a row's max and sum reduce over its
// 4 lanes); P is rounded to bf16 in registers, where the accumulator's
// layout is already the register A operand of O += P V, four wgmma
// m64nDk16 with V read MN-major from shared memory.  Then it releases the
// stage through its `empty` barrier.  Only the diagonal block and the
// window and ragged edges are masked.  Keys past S are zero-filled and
// masked, rows past S are computed but never stored.
// The tensor-core tile's shared memory: Q at the first 1024-byte boundary,
// then STAGES K stages, STAGES V stages, and the barriers full[STAGES],
// empty[STAGES].
template <int D>
__device__ __forceinline__ uint32_t flash_tc_q(void* smem_raw) {
  return (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
}
template <int D>
__device__ __forceinline__ uint32_t flash_tc_bars(void* smem_raw) {
  return flash_tc_q<D>(smem_raw) + (BQ + 2 * STAGES * BK) * D * 2;
}

template <int D>
__device__ void flash_tile_tc(const PrefillArgs& a, int b, int h, int qi,
                              void* smem_raw) {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128, "D in {16, 32, 64, 128}");
  using bf16 = __nv_bfloat16;
  constexpr int TILE = BK * D * 2, CH = D / 8;  // bytes; 16-byte chunks/row
  const uint32_t sQ = flash_tc_q<D>(smem_raw);
  const uint32_t sK = sQ + BQ * D * 2, sV = sK + STAGES * TILE;
  const uint32_t bars = flash_tc_bars<D>(smem_raw);
  const auto full = [&](int s) { return bars + 8 * s; };
  const auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int t = tile_thread<D>();
  const int kvh = h / (a.Hq / a.Hkv);
  const int q0 = qi * BQ;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.sk.b + kvh * a.sk.h;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.sv.b + kvh * a.sv.h;
  const int k_end = min(a.S, q0 + BQ);  // causal bound (exclusive)
  int kb0 = 0;
  if (a.window > 0 && q0 - a.window + 1 > 0) kb0 = (q0 - a.window + 1) / BK;
  const int nkb = (k_end + BK - 1) / BK - kb0;

  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 128);
      hopper::mbar_init(empty(s), 128);
    }
    hopper::mbar_init_fence();
  }
  for (int i = t; i < BQ * CH; i += THREADS) {
    const int r = i / CH, c = i % CH;
    hopper::cp_async16(sQ + tile_offset<D, BQ>(r, c),
                       q + min(q0 + r, a.S - 1) * a.sq.s + c * 8,
                       q0 + r < a.S);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  hopper::fence_proxy_async();
  __syncthreads();

  if (t < 128) {  // producer warpgroup
    for (int j = 0; j < nkb; ++j) {
      const int s = j % STAGES;
      if (j >= STAGES) hopper::mbar_wait(empty(s), (j / STAGES - 1) & 1);
      const int k0 = (kb0 + j) * BK;
      for (int i = t; i < BK * CH; i += 128) {
        const int r = i / CH, c = i % CH;
        const int row = min(k0 + r, a.S - 1);
        const bool ok = k0 + r < a.S;
        const uint32_t off = s * TILE + tile_offset<D, BK>(r, c);
        hopper::cp_async16(sK + off, k + row * a.sk.s + c * 8, ok);
        hopper::cp_async16(sV + off, v + row * a.sv.s + c * 8, ok);
      }
      hopper::cp_async_mbar_arrive(full(s));
    }
    hopper::cp_async_wait<0>();
    return;
  }

  // consumer warpgroup
  const int ct = t - 128, warp = ct / 32, lane = ct % 32, tq = lane % 4;
  const int qp0 = q0 + 16 * warp + lane / 4, qp1 = qp0 + 8;
  const float scale = a.sm_scale * 1.44269504088896341f;  // exp -> exp2
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nkb; ++j) {
    const int s = j % STAGES;
    const int k0 = (kb0 + j) * BK;
    hopper::mbar_wait(full(s), (j / STAGES) & 1);
    hopper::fence_proxy_async();

    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    hopper::fence_regs<BK / 2>(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss_m64n64k16(sc, kmajor_desc<D, BQ>(sQ, kk),
                                 kmajor_desc<D, BK>(sK + s * TILE, kk), kk);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BK / 2>(sc);

    // online softmax on the fragments, in the exp2 domain
    const bool edge = k0 + BK - 1 > q0 ||
                      (a.window > 0 && k0 <= q0 + BQ - 1 - a.window);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * jj + 2 * tq + e;
        float x0 = sc[4 * jj + e] * scale, x1 = sc[4 * jj + 2 + e] * scale;
        if (edge) {
          if (!key_visible(kpos, qp0, a.S, a.window)) x0 = NEG_INF;
          if (!key_visible(kpos, qp1, a.S, a.window)) x1 = NEG_INF;
        }
        sc[4 * jj + e] = x0;
        sc[4 * jj + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const float p0 = exp2f(sc[4 * jj] - m0), p1 = exp2f(sc[4 * jj + 1] - m0);
      const float p2 = exp2f(sc[4 * jj + 2] - m1);
      const float p3 = exp2f(sc[4 * jj + 3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      // keys 8jj.. of rows r (regs 0, 2 of the k-slice) and r + 8 (1, 3)
      pa[jj / 2][(jj % 2) * 2] = hopper::pack_bf16(p0, p1);
      pa[jj / 2][(jj % 2) * 2 + 1] = hopper::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= al0;
      o[4 * i + 1] *= al0;
      o[4 * i + 2] *= al1;
      o[4 * i + 3] *= al1;
    }

    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<D>(o, pa[kk], mnmajor_desc<D>(sV + s * TILE, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(o);
    hopper::mbar_arrive(empty(s));
  }

  const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
  const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
  bf16* out = static_cast<bf16*>(a.o) + b * a.so.b + h * a.so.h;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int d = 8 * i + 2 * tq;
    if (qp0 < a.S)
      *reinterpret_cast<uint32_t*>(out + qp0 * a.so.s + d) =
          hopper::pack_bf16(o[4 * i] * inv0, o[4 * i + 1] * inv0);
    if (qp1 < a.S)
      *reinterpret_cast<uint32_t*>(out + qp1 * a.so.s + d) =
          hopper::pack_bf16(o[4 * i + 2] * inv1, o[4 * i + 3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// split decode tile
// ---------------------------------------------------------------------------

// N consecutive values of p as float32 (N = 1, 2 or 4; p aligned to N).
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}
template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 1) {
    out[0] = __bfloat162float(p[0]);
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(p)[i]);
      out[2 * i] = v.x, out[2 * i + 1] = v.y;
    }
  }
}

// Decode attention of the G = Hq/Hkv (<= MAX_G) query heads that share kv
// head kvh of sequence b, over split `split`: keys [split*SPLIT,
// split*SPLIT+SPLIT) of its first lens[b] keys.  Each K/V row is read from
// device memory once for all G heads, and stays in the input dtype in
// shared memory.  The pool rows of the split's keys are looked up in the
// block table once, up front.  Only keys below lens[b] are ever read, so
// pages past the end (and padded table entries) are never touched.  A
// split that starts past the end reads nothing and writes nothing.
//
// Inside a split the 8 warps work alone, with no CTA barrier in the key
// loop: warp w takes key blocks w, w+8, ... of KPW keys, copies each with
// 16-byte cp.async into its own ring of DSTAGES stages (the next two
// blocks in flight while this one computes) and keeps its own online
// softmax (m, l per head) and accumulator (each lane D/32 output dims of
// every head, in registers).  Scores: KPW keys a step, LPK lanes a key,
// each lane CPL 16-byte chunks of the key row (rotated by key so a 16-byte
// access phase hits distinct banks) against every head's q, then summed
// over the key's lanes.  q is scaled by sm_scale * log2(e) as it is
// staged, so scores, m and every partial live in the exp2 domain.  After
// the loop the warps' partials are merged through shared memory.
//
// Merge across splits: every split with keys writes float32 (acc[G][D],
// m[G], l[G]) to its slot of a.part, then counts itself in a.count[b*Hkv +
// kvh] behind a __threadfence.  The CTA that brings the count to a.splits
// is the last one; it resets the count to 0 (so the buffer needs zeroing
// only once, and the next launch on the stream finds it clean) and merges
// the non-empty splits in split order: o = sum_s acc_s w_s with w_s =
// 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s.  Every sum runs in a
// fixed order, so the output does not depend on which CTA finishes last.
template <typename T, int D>
__device__ void paged_tile(const DecodeArgs& a, int b, int kvh, int split,
                           void* smem_raw) {
  constexpr int VEC = 16 / sizeof(T), NCH = D / VEC;
  constexpr int KPW = paged_kpw(D, sizeof(T)), LPK = 32 / KPW;
  constexpr int CPL = NCH / LPK;             // chunks a lane multiplies
  constexpr int DPL = D >= 32 ? D / 32 : 1;  // output dims a lane owns
  constexpr int WARPS = THREADS / 32, STAGE = KPW * D;
  static_assert(CPL * LPK == NCH && KPW % 4 == 0, "decode tile shape");
  const int G = a.Hq / a.Hkv;
  T* kv = static_cast<T*>(smem_raw);  // [WARPS][stage][K, V][KPW][D]
  float* qs =
      reinterpret_cast<float*>(kv + WARPS * 2 * DSTAGES * STAGE);  // [G][D]
  float* pw = qs + G * D;                               // [WARPS][G][KPW]
  int* rows = reinterpret_cast<int*>(pw + WARPS * G * KPW);  // [SPLIT]
  float* wts = reinterpret_cast<float*>(rows + SPLIT);       // [splits][G]
  int* last = reinterpret_cast<int*>(wts + a.splits * G);

  const int t = tile_thread<D>(), lane = t % 32, warp = t / 32;
  const int n = a.lens[b];
  const int kbeg = split * SPLIT, nkeys = min(n, kbeg + SPLIT) - kbeg;
  const int tile = b * a.Hkv + kvh;
  const int part_len = G * (D + 2);
  float* part =
      a.part + (static_cast<int64_t>(tile) * a.splits + split) * part_len;
  const int64_t head0 = (static_cast<int64_t>(b) * a.Hq + kvh * G) * D;

  if (nkeys > 0) {
    const int* tab = a.tables + static_cast<int64_t>(b) * a.max_pages;
    for (int r = t; r < nkeys; r += THREADS) {
      const int pos = kbeg + r;
      rows[r] = tab[pos / a.page] * a.page + pos % a.page;
    }
    const T* q = static_cast<const T*>(a.q) + head0;
    const float scale = a.sm_scale * 1.44269504088896341f;  // exp -> exp2
    for (int i = t; i < G * D; i += THREADS) qs[i] = to_f32(q[i]) * scale;
    __syncthreads();

    const T* kp = static_cast<const T*>(a.k_pages);
    const T* vp = static_cast<const T*>(a.v_pages);
    T* wkv = kv + warp * 2 * DSTAGES * STAGE;
    const auto fetch = [&](int j, int s) {  // key block j into stage s
      T* kd = wkv + s * 2 * STAGE;
      for (int i = lane; i < KPW * NCH; i += 32) {
        const int r = i / NCH, ch = i % NCH, key = j * KPW + r;
        const bool ok = key < nkeys;
        const int64_t src =
            ((ok ? static_cast<int64_t>(rows[key]) : 0) * a.Hkv + kvh) * D +
            ch * VEC;
        hopper::cp_async16(hopper::smem_u32(kd + r * D + ch * VEC), kp + src,
                           ok);
        hopper::cp_async16(hopper::smem_u32(kd + STAGE + r * D + ch * VEC),
                           vp + src, ok);
      }
    };

    float m[MAX_G], l[MAX_G], acc[MAX_G][DPL];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      m[g] = NEG_INF;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
    }
    const int nblk = (nkeys + KPW - 1) / KPW;
    const int kk = lane / LPK, qq = lane % LPK;  // this lane's key, part
    // one cp.async group per block slot, empty past the last block, so
    // waiting for all but the newest DSTAGES-1 groups finds the block
    // being consumed landed
    for (int st = 0; st < DSTAGES - 1; ++st) {
      if (warp + st * WARPS < nblk) fetch(warp + st * WARPS, st);
      hopper::cp_async_commit();
    }
    for (int j = warp, step = 0; j < nblk; j += WARPS, ++step) {
      const int s = step % DSTAGES;
      const int ahead = j + (DSTAGES - 1) * WARPS;
      if (ahead < nblk) fetch(ahead, (step + DSTAGES - 1) % DSTAGES);
      hopper::cp_async_commit();
      hopper::cp_async_wait<DSTAGES - 1>();
      __syncwarp();  // the block's copies by every lane have landed
      const T* K = wkv + s * 2 * STAGE;
      const T* V = K + STAGE;
      const bool valid = j * KPW + kk < nkeys;

      float sc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) sc[g] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int ch = ((i + kk) % CPL) * LPK + qq;
        float kf[VEC];
        unpack16<T>(*reinterpret_cast<const uint4*>(K + kk * D + ch * VEC),
                    kf);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            float qf[VEC];
#pragma unroll
            for (int v4 = 0; v4 < VEC; v4 += 4)
              load_f32<4>(qs + g * D + ch * VEC + v4, qf + v4);
#pragma unroll
            for (int e = 0; e < VEC; ++e) sc[g] = fmaf(qf[e], kf[e], sc[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float x = sc[g];
#pragma unroll
          for (int off = 1; off < LPK; off <<= 1)
            x += __shfl_xor_sync(0xffffffffu, x, off);
          x = valid ? x : NEG_INF;
          float mx = x;
#pragma unroll
          for (int off = LPK; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m[g], mx);
          const float alpha = exp2f(m[g] - mn);
          const float p = valid ? exp2f(x - mn) : 0.f;
          float ps = p;
#pragma unroll
          for (int off = LPK; off < 32; off <<= 1)
            ps += __shfl_xor_sync(0xffffffffu, ps, off);
          l[g] = l[g] * alpha + ps;
          m[g] = mn;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] *= alpha;
          if (qq == 0) pw[(warp * G + g) * KPW + kk] = p;
        }
      }
      __syncwarp();  // this step's probabilities are in pw
      if (lane * DPL < D) {
#pragma unroll
        for (int k4 = 0; k4 < KPW; k4 += 4) {
          float vf[4][DPL];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            load_f32<DPL>(V + (k4 + c) * D + lane * DPL, vf[c]);
#pragma unroll
          for (int g = 0; g < MAX_G; ++g) {
            if (g < G) {
              float pk[4];
              load_f32<4>(pw + (warp * G + g) * KPW + k4, pk);
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int e = 0; e < DPL; ++e)
                  acc[g][e] = fmaf(pk[c], vf[c][e], acc[g][e]);
            }
          }
        }
      }
      __syncwarp();  // the stage and pw are consumed before their refill
    }

    // merge the warps' partials (a warp with no keys has m = NEG_INF,
    // l = 0, acc = 0 and weight 0) into this split's partial
    __syncthreads();  // every warp is done with its stages: reuse them
    float* wacc = reinterpret_cast<float*>(kv);  // [WARPS][G][D]
    float* wm = wacc + WARPS * G * D;             // [WARPS][G]
    float* wl = wm + WARPS * G;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        if (lane * DPL < D)
#pragma unroll
          for (int e = 0; e < DPL; ++e)
            wacc[(warp * G + g) * D + lane * DPL + e] = acc[g][e];
        if (lane == 0) {
          wm[warp * G + g] = m[g];
          wl[warp * G + g] = l[g];
        }
      }
    }
    __syncthreads();
    for (int i = t; i < G * D; i += THREADS) {
      const int g = i / D;
      float M = NEG_INF;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, wm[w * G + g]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float e = exp2f(wm[w * G + g] - M);
        L = fmaf(wl[w * G + g], e, L);
        A = fmaf(wacc[w * G * D + i], e, A);
      }
      part[i] = A;
      if (i % D == 0) {
        part[G * D + g] = M;
        part[G * D + G + g] = L;
      }
    }
  }

  __threadfence();  // this split's partial is visible before it is counted
  __syncthreads();
  if (t == 0) {
    const int done = atomicAdd(a.count + tile, 1) + 1;
    *last = done == a.splits;
    if (*last) a.count[tile] = 0;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();

  const int used = min(a.splits, (n + SPLIT - 1) / SPLIT);  // non-empty
  const float* p0 = a.part + static_cast<int64_t>(tile) * a.splits * part_len;
  for (int g = t; g < G; g += THREADS) {
    float M = NEG_INF;
    for (int s = 0; s < used; ++s)
      M = fmaxf(M, __ldcg(p0 + s * part_len + G * D + g));
    float L = 0.f;
    for (int s = 0; s < used; ++s) {
      const float w = exp2f(__ldcg(p0 + s * part_len + G * D + g) - M);
      wts[s * G + g] = w;
      L = fmaf(__ldcg(p0 + s * part_len + G * D + G + g), w, L);
    }
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int s = 0; s < used; ++s) wts[s * G + g] *= inv;
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + head0;
  for (int i = t; i < G * D; i += THREADS) {
    const int g = i / D;
    float O = 0.f;
#pragma unroll 4
    for (int s = 0; s < used; ++s)
      O = fmaf(__ldcg(p0 + s * part_len + i), wts[s * G + g], O);
    o[i] = from_f32<T>(O);
  }
}

// The prefill tile of dtype T: tensor cores for bf16, CUDA cores for
// float32; and its dynamic shared memory in bytes.
template <typename T, int D>
__device__ __forceinline__ void prefill_tile(const PrefillArgs& a, int b,
                                             int h, int qi, void* smem) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    flash_tile_tc<D>(a, b, h, qi, smem);
  else
    flash_tile<T, D>(a, b, h, qi, static_cast<float*>(smem));
}
// Ends a prefill tile in a CTA that runs more tiles: the tensor-core tile's
// barriers are invalidated, so that the next tile may re-initialise them
// or use their memory as anything else.  Called by one thread, after a
// CTA barrier that every thread (both warpgroups) reached past the tile.
template <typename T, int D>
__device__ __forceinline__ void prefill_tile_release(void* smem) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const uint32_t bars = flash_tc_bars<D>(smem);
    for (int s = 0; s < 2 * STAGES; ++s) hopper::mbar_inval(bars + 8 * s);
  }
}
template <typename T, int D>
__host__ __device__ constexpr int prefill_smem_bytes() {
  return std::is_same<T, __nv_bfloat16>::value
             ? flash_tc_smem_bytes<D>()
             : flash_smem_floats<D>() * static_cast<int>(sizeof(float));
}

// Sets the dynamic shared-memory ceiling (needed above 48 KB) and launches.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem_bytes,
                   cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (e != cudaSuccess) return e;
  kernel<<<grid, THREADS, smem_bytes, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace attn

// Instantiate FN<T, D>(args...) for dtype code (0 = float32, 1 = bfloat16)
// and head dim D in {16, 32, 64, 128}; anything else is refused.
#define ATTN_DISPATCH(dtype, D, FN, ...)                                  \
  do {                                                                    \
    switch ((dtype) * 1000 + (D)) {                                       \
      case 16: return FN<float, 16>(__VA_ARGS__);                         \
      case 32: return FN<float, 32>(__VA_ARGS__);                         \
      case 64: return FN<float, 64>(__VA_ARGS__);                         \
      case 128: return FN<float, 128>(__VA_ARGS__);                       \
      case 1016: return FN<__nv_bfloat16, 16>(__VA_ARGS__);               \
      case 1032: return FN<__nv_bfloat16, 32>(__VA_ARGS__);               \
      case 1064: return FN<__nv_bfloat16, 64>(__VA_ARGS__);               \
      case 1128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);              \
      default: return static_cast<int>(cudaErrorInvalidValue);            \
    }                                                                     \
  } while (0)

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
