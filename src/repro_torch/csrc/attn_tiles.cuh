// Shared attention tiles for the prefill, decode and unified P/D kernels.
//
// One CTA of THREADS threads runs one tile:
//   flash_tile  - BQ query rows of one (batch, q-head) against the causal
//                 (and window) range of keys, in k-blocks of BK keys;
//   paged_tile  - the G query heads of one (sequence, kv-head) against the
//                 sequence's paged KV, in chunks of BK keys gathered from
//                 its block-table row.
// Both keep the reference's masking convention: masked scores are the
// finite NEG_INF = -1e30 and the row sum is clamped to 1e-30, so a fully
// masked row comes out finite.  Tiles are staged in shared memory as
// float32 and every product accumulates in float32 (CUDA cores, no tensor
// cores yet).  The unified kernel calls these same functions, so its
// outputs equal the standalone kernels' bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;  // one block size for both tile kinds
constexpr int BQ = 64;        // query rows of a prefill tile
constexpr int BK = 64;        // keys per inner step (k-block / decode chunk)
static_assert(BQ == 64 && BK == 64 && THREADS == 256,
              "thread maps below assume 16x16 threads over 64x64 tiles");

enum TileKind { PREFILL = 0, DECODE = 1 };

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
  int Hq, Hkv, page, max_pages;
  float sm_scale;
};

template <int D>
__host__ __device__ constexpr int flash_smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

__host__ __device__ inline int paged_smem_floats(int D, int G) {
  return G * D + BK * (D + 1) + BK * D + G * (BK + 1) + G * D + 3 * G + BK;
}

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
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Causal flash attention for query rows [qi*BQ, qi*BQ+BQ) of (b, h).
// Thread (ty, tx) = (t/16, t%16) owns rows ty+16i and, within a k-block,
// keys tx+16j and output dims tx+16j.  Row max/sum reduce across the 16
// threads of a half-warp.  The k-block loop stops at the causal bound and
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

  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
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

// Decode attention of the G = Hq/Hkv query heads that share kv head kvh
// of sequence b: each K/V row is read from device memory once for all G
// heads.  Keys are taken BK at a time through the block table, and only
// the sequence's first lens[b] keys are ever read, so pages past the end
// (and padded table entries) are never touched.
template <typename T, int D>
__device__ void paged_tile(const DecodeArgs& a, int b, int kvh, float* smem) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  const int G = a.Hq / a.Hkv;
  float* Qd = smem;               // G x D
  float* Ks = Qd + G * D;         // BK x DP
  float* Vs = Ks + BK * DP;       // BK x D
  float* Ps = Vs + BK * D;        // G x PP
  float* acc = Ps + G * PP;       // G x D
  float* ms = acc + G * D;        // G
  float* ls = ms + G;             // G
  float* al = ls + G;             // G
  int* rows = reinterpret_cast<int*>(al + G);  // BK pool rows of the chunk

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int n = a.lens[b];
  const int64_t head0 = (static_cast<int64_t>(b) * a.Hq + kvh * G) * D;
  const T* q = static_cast<const T*>(a.q) + head0;
  const T* kp = static_cast<const T*>(a.k_pages);
  const T* vp = static_cast<const T*>(a.v_pages);
  const int* tab = a.tables + static_cast<int64_t>(b) * a.max_pages;

  for (int i = t; i < G * D; i += THREADS) {
    Qd[i] = to_f32(q[i]);
    acc[i] = 0.f;
  }
  for (int g = t; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }

  for (int k0 = 0; k0 < n; k0 += BK) {
    const int nk = min(BK, n - k0);
    __syncthreads();  // init done / the previous chunk is consumed
    if (t < nk) {
      const int pos = k0 + t;
      rows[t] = tab[pos / a.page] * a.page + pos % a.page;
    }
    __syncthreads();
    stage_rows<T, BK, D, true>(
        Ks, DP, Vs, D, nk,
        [&](int r) { return kp + (static_cast<int64_t>(rows[r]) * a.Hkv + kvh) * D; },
        [&](int r) { return vp + (static_cast<int64_t>(rows[r]) * a.Hkv + kvh) * D; });
    __syncthreads();
    for (int i = t; i < G * BK; i += THREADS) {
      const int g = i / BK, c = i % BK;
      float s = NEG_INF;
      if (c < nk) {
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(Qd[g * D + d], Ks[c * DP + d], dot);
        s = dot * a.sm_scale;
      }
      Ps[g * PP + c] = s;
    }
    __syncthreads();
    for (int g = warp; g < G; g += THREADS / 32) {
      const float s0 = Ps[g * PP + lane], s1 = Ps[g * PP + lane + 32];
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = lane < nk ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < nk ? expf(s1 - m_new) : 0.f;
      Ps[g * PP + lane] = p0;
      Ps[g * PP + lane + 32] = p1;
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = t; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      float x = acc[i] * al[g];
      for (int c = 0; c < nk; ++c) x = fmaf(Ps[g * PP + c], Vs[c * D + d], x);
      acc[i] = x;
    }
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + head0;
  for (int i = t; i < G * D; i += THREADS)
    o[i] = from_f32<T>(acc[i] / fmaxf(ls[i / D], 1e-30f));
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
