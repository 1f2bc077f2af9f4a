// Causal GQA flash attention for prefill.
//
// Replaces: repro/kernels/flash_prefill.py, flash_prefill -> _flash_kernel
// (Pallas, TPU).  There the grid's innermost k-block dimension ran in order
// on one core and carried (m, l, acc) in VMEM scratch.  Here one CTA owns
// one (batch, q-head, 64-row q-block) and loops over k-blocks itself, with
// the running max, sum and accumulator in registers.
//
// Bound on the H100: operations.  The causal half of the S x S score
// matrix is 2*S*S*D multiply-adds per head, against only 4*S*D values of
// q, k, v and o, so at serving lengths the bf16 tensor-core rate (989
// TFLOP/s) sets the floor.  In bf16 both products run on the tensor cores
// (attn_tiles.cuh flash_tile_tc): wgmma for S = Q K^T from shared memory
// and for O += P V with P in registers, the online softmax on the
// accumulator fragments, K/V k-blocks arriving through a two-stage cp.async
// ring filled by a producer warpgroup while the consumer warpgroup
// computes, and two CTAs to an SM (80 KB of shared memory each at D = 128)
// so one CTA's softmax overlaps the other's products.  float32 keeps the
// CUDA-core tile (flash_tile).  Both tiles skip k-blocks past the causal
// (and before the window) bound, read the kv head of q-head h as h / G
// with no repeat, and mask the ragged edge in place with no padded copy.
#include "attn_tiles.cuh"

// CTAs are dispatched in index order; the last q-blocks of a head, which
// walk the most k-blocks, take the lowest indices so the launch does not
// end on its heaviest tiles.
template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS, attn::MinCtas<T>::value)
    flash_kernel(attn::PrefillArgs a) {
  extern __shared__ float smem[];
  attn::prefill_tile<T, D>(a, blockIdx.z, blockIdx.y,
                           gridDim.x - 1 - blockIdx.x, smem);
}

template <typename T, int D>
static int run(const attn::PrefillArgs& a, int B, cudaStream_t stream) {
  const int nq = (a.S + attn::BQ - 1) / attn::BQ;
  return attn::launch(flash_kernel<T, D>, dim3(nq, a.Hq, B),
                      attn::prefill_smem_bytes<T, D>(), stream, a);
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
