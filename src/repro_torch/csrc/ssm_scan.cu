// Mamba S6 selective scan, from a zero state or from a given one:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t
// per (batch b, channel d), with h of d_state (DS) values per channel.
//
// Replaces: repro/kernels/ssm_scan.py, ssm_scan -> _ssm_kernel (Pallas,
// TPU).  There the chunk dimension of the grid ran in order and carried h
// for a tile of channels in VMEM from one chunk to the next.  Hopper blocks
// run in no order, so here a CTA owns CH channels of one sequence for all
// L timesteps, and h never leaves registers until the final state is
// written.  The reference starts from h0 only on its plain path; here the
// kernel reads h0 (B, din, DS) in place of the zero state when it is given.
//
// Bound on the H100: the L*din*DS exponentials on the special-function
// units (MUFU, 16 a clock per SM) and the bytes (xs, dt and y, 4*L*din
// each) are of the same size at the serving shape (0.110 and 0.104 ms at
// xs (1, 1762, 16384), DS 16).  Each (t, d, n) costs one MUFU.EX2 and four
// FP32 operations (dt*A, dx*B, the update, the C sum), so the MUFU is the
// limit as long as a step's other work (shared-memory reads, the sum
// across lanes, addressing) stays under about three issue slots an
// exponential.  The design:
//  * The DS states of a channel are split over LANES (P) adjacent lanes,
//    S = DS/P states each, held with their A (pre-scaled by log2 e, so the
//    exponential is one ex2.approx) in registers.  That gives B*din*P
//    threads: at P = 2, 8 warps an SM at the serving shape, each with S
//    independent update chains a step.
//  * Each lane sums its S terms of y_t; after P steps the P lanes of a
//    channel reduce-scatter their P partial sums with P-1 shuffles, so
//    lane j ends with y of step j and every lane stores.  The shuffles are
//    needed by no later step, so they sit off the recurrence's path.
//  * Loads stay in flight while the card computes: a ring of STAGES chunk
//    stages in shared memory, each holding T timesteps of the CTA's xs and
//    dt tile and the chunk's B and C rows, filled by cp.async from every
//    thread and waited on with mbarriers (one "full" and one "empty"
//    barrier a stage).  A stage is refilled one chunk after it was read,
//    so no warp waits for the slowest warp of the chunk it just finished.
//    Every input is read from device memory once; x and dt of a channel
//    are broadcast from shared memory to its P lanes.
//  * The steps of a chunk past L are zero-filled: dt = 0 makes them exact
//    identity updates (exp(0) = 1, no input), so only their y is masked.
//
// What holds it back on the card is issue, not the MUFU or the bytes: an
// exponential brings four FP32 instructions and the MUFU, plus its share of
// a step's shared-memory reads, lane sum and store, and with only B*din*P
// threads there are too few warps a scheduler to issue them at the MUFU's
// rate.  More lanes a channel (P = 4) gave more warps but more
// instructions an exponential; one lane (P = 1) gave too few warps, and 3
// stages were no faster than 4.  So P = 2 for DS = 16, 16 steps a trip of
// the inner loop, and no minimum of CTAs an SM in the launch bounds, which
// lets ptxas keep more of a trip's loads and exponentials in flight
// (PERF.md has the times of the instances measured and since removed).
// P = 1 for DS = 4 and P = 2 for DS = 8 are not measured yet.
//
// No fast-math flag (it would reach the attention kernels too).  The
// exponential is ex2.approx.ftz of dt * (A log2 e): a relative error of a
// few 1e-7, with results below 2^-126 flushed to zero; every exponential is
// computed from A as given.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int CH = 64;      // channels a CTA
constexpr int T = 32;       // timesteps a stage
constexpr int UNROLL = 16;  // timesteps a trip of the inner loop
constexpr int STAGES = 4;   // chunk stages in the shared-memory ring
constexpr float LOG2E = 1.4426950408889634f;

struct ScanArgs {
  const float *xs, *dt, *A, *Bm, *Cm, *h0;  // h0 may be null: zero state
  float *y, *h_out;
  int L, din;
  bool vec;  // xs/dt rows 16-byte aligned (din % 4 == 0, aligned bases)
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// N consecutive floats of shared memory into registers, 16 bytes at a time
// where N allows.
template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = v.x;
      dst[4 * i + 1] = v.y;
      dst[4 * i + 2] = v.z;
      dst[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 v = reinterpret_cast<const float2*>(src)[i];
      dst[2 * i] = v.x;
      dst[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = src[i];
  }
}

// The P lanes j = 0..P-1 of a channel (P = 1 or 2) each hold partial sums
// v[0..P) of P steps; returns, in lane j, the sum over the P lanes of step
// j.  Each lane keeps one step, sends the other to its partner and adds
// what it receives.
template <int P>
__device__ __forceinline__ float reduce_scatter(float (&v)[P], int j) {
  static_assert(P == 1 || P == 2, "lanes a channel");
  if constexpr (P == 2) {
    const bool hi = j & 1;
    const float send = hi ? v[0] : v[1];
    const float keep = hi ? v[1] : v[0];
    v[0] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
  }
  return v[0];
}

// grid (ceil(din / CH), B); CH * P threads; lane (c, j) of the CTA owns
// states [j*S, (j+1)*S) of channel blockIdx.x * CH + c of sequence
// blockIdx.y.
template <int DS, int P>
__global__ void __launch_bounds__(CH * P, 1) ssm_kernel(const ScanArgs a) {
  constexpr int THREADS = CH * P, WARPS = THREADS / 32, S = DS / P;
  constexpr int STAGE = T * (2 * CH + 2 * DS);  // floats: x, dt, B, C
  static_assert(DS % P == 0 && T % UNROLL == 0 && UNROLL % P == 0, "shape");
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2 * STAGES];  // full, then empty

  const int tid = threadIdx.x, lane = tid % 32;
  const int c = (tid / 32) * (32 / P) + lane / P, j = lane % P;
  const int d0 = blockIdx.x * CH, d = d0 + c;
  const bool live = d < a.din;  // din need not be a multiple of CH
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * a.L;  // row (b, 0)
  const int nchunks = (a.L + T - 1) / T;
  const uint32_t bar0 = hopper::smem_u32(bars);
  const auto full = [&](int s) { return bar0 + 8 * s; };
  const auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), THREADS);
      hopper::mbar_init(empty(s), WARPS);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  // Every thread copies its share of chunk m into stage m % STAGES, then
  // arrives on the stage's full barrier once its copies have landed.
  const auto fill = [&](int m) {
    float* xs_s = smem + (m % STAGES) * STAGE;
    float* dt_s = xs_s + T * CH;
    float* b_s = dt_s + T * CH;
    float* c_s = b_s + T * DS;
    const int t0 = m * T;
    if (a.vec) {
      for (int i = tid; i < T * CH / 4; i += THREADS) {
        const int r = i / (CH / 4), q = 4 * (i % (CH / 4));
        const bool ok = t0 + r < a.L && d0 + q < a.din;
        const int64_t off = ok ? (row0 + t0 + r) * a.din + d0 + q : 0;
        hopper::cp_async16(hopper::smem_u32(xs_s + r * CH + q), a.xs + off, ok);
        hopper::cp_async16(hopper::smem_u32(dt_s + r * CH + q), a.dt + off, ok);
      }
    } else {
      for (int i = tid; i < T * CH; i += THREADS) {
        const int r = i / CH, q = i % CH;
        const bool ok = t0 + r < a.L && d0 + q < a.din;
        const int64_t off = ok ? (row0 + t0 + r) * a.din + d0 + q : 0;
        hopper::cp_async4(hopper::smem_u32(xs_s + r * CH + q), a.xs + off, ok);
        hopper::cp_async4(hopper::smem_u32(dt_s + r * CH + q), a.dt + off, ok);
      }
    }
    // the chunk's B and C rows are T*DS consecutive floats
    for (int i = tid; i < T * DS / 4; i += THREADS) {
      const bool ok = t0 + 4 * i / DS < a.L;
      const int64_t off = ok ? (row0 + t0) * DS + 4 * i : 0;
      hopper::cp_async16(hopper::smem_u32(b_s + 4 * i), a.Bm + off, ok);
      hopper::cp_async16(hopper::smem_u32(c_s + 4 * i), a.Cm + off, ok);
    }
    hopper::cp_async_mbar_arrive(full(m % STAGES));
  };
  for (int m = 0; m < min(STAGES, nchunks); ++m) fill(m);

  float a2[S], h[S];
  const int64_t hrow =  // (b, d, j*S) of h0 and h_out
      (static_cast<int64_t>(blockIdx.y) * a.din + d) * DS + j * S;
#pragma unroll
  for (int n = 0; n < S; ++n) {
    a2[n] = live ? a.A[static_cast<int64_t>(d) * DS + j * S + n] * LOG2E : 0.f;
    h[n] = live && a.h0 ? a.h0[hrow + n] : 0.f;
  }

  float* yp = a.y + (row0 + j) * a.din + d;  // y of this lane's next step
  const int64_t ystep = static_cast<int64_t>(P) * a.din;

  for (int k = 0; k < nchunks; ++k) {
    const int s = k % STAGES;
    hopper::mbar_wait(full(s), (k / STAGES) & 1);
    const float* xs_s = smem + s * STAGE;
    const float* dt_s = xs_s + T * CH;
    const float* b_s = dt_s + T * CH + j * S;
    const float* c_s = b_s + T * DS;
#pragma unroll 1
    for (int r0 = 0; r0 < T; r0 += UNROLL) {
      const int left = a.L - k * T - r0;  // steps of the sequence from r0 on
#pragma unroll
      for (int g = 0; g < UNROLL; g += P) {
        float part[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const int r = r0 + g + q;
          const float dtv = dt_s[r * CH + c];
          const float dx = dtv * xs_s[r * CH + c];
          float bv[S], cv[S];
          lds<S>(bv, b_s + r * DS);
          lds<S>(cv, c_s + r * DS);
          float acc = 0.f;
#pragma unroll
          for (int n = 0; n < S; ++n) {
            h[n] = fmaf(ex2(dtv * a2[n]), h[n], dx * bv[n]);
            acc = fmaf(h[n], cv[n], acc);
          }
          part[q] = acc;
        }
        const float yv = reduce_scatter<P>(part, j);
        if (live && g + j < left) *yp = yv;
        yp += ystep;
      }
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty(s));
    // refill the stage of chunk k-1, which every warp has read by the time
    // the slowest warp finishes it
    if (k >= 1 && k - 1 + STAGES < nchunks) {
      hopper::mbar_wait(empty((k - 1) % STAGES), ((k - 1) / STAGES) & 1);
      fill(k - 1 + STAGES);
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < S; ++n) a.h_out[hrow + n] = h[n];
  }
}

template <int DS, int P>
int run(const ScanArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * STAGES * T * (2 * CH + 2 * DS);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_kernel<DS, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.din + CH - 1) / CH, B);
  ssm_kernel<DS, P><<<grid, CH * P, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All float32 and dense: xs, dt, y (B,L,din); A (din,DS); Bm, Cm (B,L,DS);
// h0 (B,din,DS) or null for a zero state; h_out (B,din,DS).  Bm and Cm
// 16-byte aligned.  One instance a d_state; the caller passes the lanes and
// stages it expects, and anything but an instance below is refused.
extern "C" int ssm_scan_launch(int ds, int lanes, int stages, const float* xs,
                               const float* dt, const float* A,
                               const float* Bm, const float* Cm,
                               const float* h0, float* y, float* h_out, int B,
                               int L, int din, void* stream) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (!aligned(Bm) || !aligned(Cm)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (stages != STAGES) return static_cast<int>(cudaErrorInvalidValue);
  const ScanArgs a{xs, dt, A, Bm, Cm, h0, y, h_out, L, din,
                   din % 4 == 0 && aligned(xs) && aligned(dt)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ds == 4 && lanes == 1) return run<4, 1>(a, B, s);
  if (ds == 8 && lanes == 2) return run<8, 2>(a, B, s);
  if (ds == 16 && lanes == 2) return run<16, 2>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
