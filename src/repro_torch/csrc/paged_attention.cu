// Paged decode attention: one query token per sequence over a paged KV pool.
//
// Replaces: repro/kernels/paged_attention.py, paged_attention ->
// _paged_kernel (Pallas, TPU).  There scalar prefetch brought the block
// table ahead of a grid whose innermost dimension walked pages in order,
// carrying (m, l, acc) in VMEM.  Here one CTA owns one (sequence, kv head),
// reads its own block-table row, and walks the sequence's keys in chunks of
// 64 gathered through that row.
//
// Bound on the H100: bytes.  Each cached K and V row is needed once, and the
// arithmetic per byte is about G multiply-adds.  The design reads every K/V
// row of the valid prefix exactly once for all G = Hq/Hkv query heads that
// share it, touches no page past seq_len (padded table entries are never
// dereferenced), and gathers a 64-key chunk across pages per step so one
// round of loads covers several pages.  Its weakness is parallelism: there
// are only B*Hkv CTAs, which at small decode batches leaves most SMs idle;
// splitting the key range across CTAs is later work.
#include "attn_tiles.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS)
    paged_kernel(attn::DecodeArgs a) {
  extern __shared__ float smem[];
  attn::paged_tile<T, D>(a, blockIdx.y, blockIdx.x, smem);
}

template <typename T, int D>
static int run(const attn::DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem = attn::paged_smem_floats(D, a.Hq / a.Hkv) * sizeof(float);
  return attn::launch(paged_kernel<T, D>, dim3(a.Hkv, B), smem, stream, a);
}

// q (B,Hq,D) and o (B,Hq,D) dense; k/v pages (N,page,Hkv,D) dense;
// tables (B,max_pages) int32; lens (B,) int32 valid tokens per sequence.
extern "C" int paged_attention_launch(
    int dtype, int D, const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lens, void* o, int B, int Hq, int Hkv,
    int page, int max_pages, float sm_scale, void* stream) {
  attn::DecodeArgs a{q, k_pages, v_pages, tables, lens, o,
                     Hq, Hkv, page, max_pages, sm_scale};
  ATTN_DISPATCH(dtype, D, run, a, B, static_cast<cudaStream_t>(stream));
}
