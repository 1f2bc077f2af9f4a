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
//
// The paged, offset form (flash_prefill_paged_launch) extends the same
// kernel.  It carries a hybrid (chunked-prefill) step's chunks: the
// queries of several requests' prompt chunks packed along one row
// dimension, each chunk at its own offset, attending to its request's
// keys 0 .. offset + len - 1 read through its block table from the paged
// pool (its earlier chunks' K/V and its own, written there first).  The
// TPU reference prices such chunks (perfmodel chunk_prefill_cost) and its
// oracle holds their math (ref.causal_attention(q_offset=)), but no Pallas
// kernel computes them: there a hybrid step is only priced.  One CTA owns
// one (chunk, q-head, 64-row q-block) and runs the same tile as above
// through a PagedRows view: the tile's cp.async K/V row loads take page
// table[p / page], slot p % page, and its causal test the chunk's offset.
// Its k-block loop stops at the causal bound of its last row.  Bound:
// operations, as above (a chunk of n queries at offset o does
// n * (o + (n + 1) / 2) score pairs per head against (o + n) K/V rows).
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

template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS, attn::MinCtas<T>::value)
    paged_prefill_kernel(attn::PagedPrefillArgs a) {
  extern __shared__ float smem[];
  attn::paged_prefill_tile<T, D>(a, blockIdx.z, blockIdx.y,
                                 gridDim.x - 1 - blockIdx.x, smem);
}

template <typename T, int D>
static int run_paged(const attn::PagedPrefillArgs& a, int q_blocks,
                     cudaStream_t stream) {
  return attn::launch(paged_prefill_kernel<T, D>, dim3(q_blocks, a.Hq, a.C),
                      attn::prefill_smem_bytes<T, D>(), stream, a);
}

// q, o (T, Hq, D): element strides of the row and head dims, the head dim
// dense; k/v_pages (N, page, Hkv, D) dense; tables (C, max_pages) and meta
// (3, C: starts, lens, offsets) int32; q_blocks the most 64-row q-blocks of
// any chunk.
extern "C" int flash_prefill_paged_launch(
    int dtype, int D, const void* q, const void* k_pages, const void* v_pages,
    void* o, const int* tables, const int* meta, long long sq_t,
    long long sq_h, long long so_t, long long so_h, int C, int q_blocks,
    int Hq, int Hkv, int page, int max_pages, float sm_scale, void* stream) {
  attn::PagedPrefillArgs a{q,    k_pages, v_pages, o,    tables, meta,
                           sq_t, sq_h,    so_t,    so_h, C,      Hq,
                           Hkv,  page,    max_pages, sm_scale};
  ATTN_DISPATCH(dtype, D, run_paged, a, q_blocks,
                static_cast<cudaStream_t>(stream));
}
