// Causal GQA flash attention for prefill.
//
// Replaces: repro/kernels/flash_prefill.py, flash_prefill -> _flash_kernel
// (Pallas, TPU).  There the grid's innermost k-block dimension ran in order
// on one core and carried (m, l, acc) in VMEM scratch.  Here one CTA owns
// one (batch, q-head, 64-row q-block) and loops over k-blocks itself, with
// the running max, sum and accumulator in registers.
//
// Bound on the H100: operations.  A 64-row tile re-reads each k-block once
// per q-block, and the causal half of the S x S score matrix is 2*S*S*D
// multiply-adds per head; with float32 CUDA-core FMAs (no tensor cores in
// this version) it is far from the bf16 tensor-core roofline.  The design
// keeps the work down where it can without them: k-blocks past the causal
// (and before the window) bound are never loaded, GQA reads the kv head of
// q-head h as h / G with no repeat, the ragged edge is masked in place with
// no padded copies, and tiles sit in padded shared memory so the inner
// products read without bank conflicts.
#include "attn_tiles.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS)
    flash_kernel(attn::PrefillArgs a) {
  extern __shared__ float smem[];
  attn::flash_tile<T, D>(a, blockIdx.z, blockIdx.y, blockIdx.x, smem);
}

template <typename T, int D>
static int run(const attn::PrefillArgs& a, int B, cudaStream_t stream) {
  const int nq = (a.S + attn::BQ - 1) / attn::BQ;
  const size_t smem = attn::flash_smem_floats<D>() * sizeof(float);
  return attn::launch(flash_kernel<T, D>, dim3(nq, a.Hq, B), smem, stream, a);
}

// q (B,Hq,S,D), k/v (B,Hkv,S,D), o (B,Hq,S,D): element strides of the
// batch, head and sequence dims; the head dim must be dense.
extern "C" int flash_prefill_launch(
    int dtype, int D, const void* q, const void* k, const void* v, void* o,
    long long qb, long long qh, long long qs, long long kb, long long kh,
    long long ks, long long vb, long long vh, long long vs, long long ob,
    long long oh, long long os, int B, int Hq, int Hkv, int S, int window,
    float sm_scale, void* stream) {
  attn::PrefillArgs a{q, k, v, o, {qb, qh, qs}, {kb, kh, ks}, {vb, vh, vs},
                      {ob, oh, os}, S, Hq, Hkv, window, sm_scale};
  ATTN_DISPATCH(dtype, D, run, a, B, static_cast<cudaStream_t>(stream));
}
