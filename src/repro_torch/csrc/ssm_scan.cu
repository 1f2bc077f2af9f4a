// Mamba S6 selective scan from a zero state:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t
// per (batch b, channel d), with h of d_state (DS) values per channel.
//
// Replaces: repro/kernels/ssm_scan.py, ssm_scan -> _ssm_kernel (Pallas,
// TPU).  There the chunk dimension of the grid ran in order and carried h
// for a tile of channels in VMEM from one chunk to the next.  Hopper blocks
// run in no order, so here one thread owns one (b, d): it keeps h[0:DS] and
// A[d, 0:DS] in registers and walks all L timesteps itself.  Nothing
// carries between blocks, and the state never leaves registers until the
// final h is written.
//
// Bound on the H100: the bytes (xs, dt and y, 4*L*din each, plus B, C, A
// and h) and the L*din*DS exponentials at the special-function rate are of
// the same size at the serving shape, so either can bound it.  The design
// reads each input once: a CTA stages CHUNK timesteps of its channels' dt
// and x, and of the B and C rows that all its threads share, in shared
// memory with every load in flight at once, then runs the recurrence out of
// shared memory and registers.  The DS state values of a channel are
// independent chains, which gives each thread DS-wide instruction-level
// parallelism.  The weakness is parallelism across the card: one thread per
// channel gives only B*din threads (16384 at batch 1, about 4 warps per SM),
// so latency is poorly hidden; splitting DS across lanes is later work.
//
// expf (not __expf), and no fast-math: the plain version uses exp in
// float32, and any error would compound over thousands of steps.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;  // channels per CTA: B*din/64 CTAs fill 132 SMs
constexpr int CHUNK = 64;    // timesteps staged per round

template <int DS>
__global__ void __launch_bounds__(THREADS)
    ssm_kernel(const float* __restrict__ xs, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ h_out, int L, int din) {
  __shared__ float x_s[CHUNK][THREADS];
  __shared__ float dt_s[CHUNK][THREADS];
  __shared__ float b_s[CHUNK][DS];
  __shared__ float c_s[CHUNK][DS];
  const int tid = threadIdx.x;
  const int d = blockIdx.x * THREADS + tid;
  const bool live = d < din;  // din need not be a multiple of THREADS
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * L;  // row (b, 0)

  float a[DS], h[DS];
#pragma unroll
  for (int n = 0; n < DS; ++n) {
    a[n] = live ? A[static_cast<int64_t>(d) * DS + n] : 0.f;
    h[n] = 0.f;
  }
  for (int t0 = 0; t0 < L; t0 += CHUNK) {
    const int nt = min(CHUNK, L - t0);
    __syncthreads();  // every thread is done with the previous chunk
    if (live) {
#pragma unroll 16
      for (int r = 0; r < nt; ++r) {
        const int64_t i = (row0 + t0 + r) * din + d;
        x_s[r][tid] = xs[i];
        dt_s[r][tid] = dt[i];
      }
    }
    for (int i = tid; i < nt * DS; i += THREADS) {
      const int64_t j = (row0 + t0) * DS + i;
      b_s[i / DS][i % DS] = Bm[j];
      c_s[i / DS][i % DS] = Cm[j];
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < nt; ++r) {
      const float dtv = dt_s[r][tid];
      const float dx = dtv * x_s[r][tid];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < DS; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + dx * b_s[r][n];
        acc += h[n] * c_s[r][n];
      }
      y[(row0 + t0 + r) * din + d] = acc;
    }
  }
  if (live) {
    float* ho = h_out + (static_cast<int64_t>(blockIdx.y) * din + d) * DS;
#pragma unroll
    for (int n = 0; n < DS; ++n) ho[n] = h[n];
  }
}

template <int DS>
int run(const float* xs, const float* dt, const float* A, const float* Bm,
        const float* Cm, float* y, float* h_out, int B, int L, int din,
        cudaStream_t stream) {
  const dim3 grid((din + THREADS - 1) / THREADS, B);
  ssm_kernel<DS><<<grid, THREADS, 0, stream>>>(xs, dt, A, Bm, Cm, y, h_out,
                                               L, din);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All float32 and dense: xs, dt, y (B,L,din); A (din,DS); Bm, Cm (B,L,DS);
// h_out (B,din,DS).  DS in {4, 8, 16}; anything else is refused.
extern "C" int ssm_scan_launch(int ds, const float* xs, const float* dt,
                               const float* A, const float* Bm,
                               const float* Cm, float* y, float* h_out,
                               int B, int L, int din, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ds) {
    case 4: return run<4>(xs, dt, A, Bm, Cm, y, h_out, B, L, din, s);
    case 8: return run<8>(xs, dt, A, Bm, Cm, y, h_out, B, L, din, s);
    case 16: return run<16>(xs, dt, A, Bm, Cm, y, h_out, B, L, din, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
