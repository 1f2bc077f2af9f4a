// Unified P/D attention: prefill flash tiles and decode paged tiles in one
// launch, the paper's concurrent prefill+decode step.
//
// Replaces: repro/kernels/unified_pd.py, unified_pd -> _unified_kernel
// (Pallas, TPU), with its slot schedule (build_slot_schedule) and
// descriptor table (_make_descriptors).  On the TPU the grid ran in slot
// order on one core, so f_decode set how early decode tiles issued.  Here
// the grid is 1-D over the same slots in the same order: CTA s reads
// descriptor row s and runs either a prefill tile or a decode tile.  CTAs
// are dispatched in increasing index order, so f_decode again sets how early
// decode tiles reach the SMs, but once resident they share the card with
// whatever prefill tiles are running; giving decode a fixed share of the SMs
// (the analogue of CU masking) needs a persistent kernel and is later work.
//
// Bound on the H100: the sum of its two parts, operations for the prefill
// tiles and bytes for the decode tiles; running both in one launch lets
// decode's memory-bound tiles fill SMs while prefill's compute-bound tiles
// run.  The tile bodies are the standalone kernels' (attn_tiles.cuh): the
// tensor-core prefill tile in bf16, and the split decode tile, which the
// wrapper schedules as Bd x (Hkv * splits) decode slots: column dkvh of a
// decode row is kvh * splits + split.  Both kernels run the same tiles with the same
// split count and merge, so the fused outputs equal the standalone
// kernels' bit for bit in both dtypes, whatever f_decode is.  Both kinds
// share one block size and one dynamic shared-memory size, the larger of
// the two tiles' needs.
#include "attn_tiles.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS, attn::MinCtas<T>::value)
    unified_kernel(const int* desc, attn::PrefillArgs p, attn::DecodeArgs d) {
  extern __shared__ float smem[];
  const int* row = desc + blockIdx.x * 7;  // [kind, pb, ph, pkvh, pqi, db, dkvh]
  if (row[0] == attn::PREFILL)
    attn::prefill_tile<T, D>(p, row[1], row[2], row[4], smem);
  else
    attn::paged_tile<T, D>(d, row[5], row[6] / d.splits, row[6] % d.splits,
                           smem);
}

template <typename T, int D>
static int run(const int* desc, int n_slots, const attn::PrefillArgs& p,
               const attn::DecodeArgs& d, cudaStream_t stream) {
  const int flash = attn::prefill_smem_bytes<T, D>();
  const int paged =
      attn::paged_smem_bytes(D, d.Hq / d.Hkv, static_cast<int>(sizeof(T)),
                             d.splits);
  return attn::launch(unified_kernel<T, D>, dim3(n_slots),
                      flash > paged ? flash : paged, stream, desc, p, d);
}

// Prefill operands as flash_prefill_launch, decode operands as
// paged_attention_launch, plus desc (n_slots, 7) int32 on the device.
extern "C" int unified_pd_launch(
    int dtype, int D, const int* desc, int n_slots, const void* q,
    const void* k, const void* v, void* o, long long qb, long long qh,
    long long qs, long long kb, long long kh, long long ks, long long vb,
    long long vh, long long vs, long long ob, long long oh, long long os,
    int S, int Hq, int Hkv, int window, const void* q_d, const void* k_pages,
    const void* v_pages, const int* tables, const int* lens, void* o_d,
    float* part, int* count, int page, int max_pages, int splits,
    float sm_scale, void* stream) {
  attn::PrefillArgs p{q, k, v, o, {qb, qh, qs}, {kb, kh, ks}, {vb, vh, vs},
                      {ob, oh, os}, S, Hq, Hkv, window, sm_scale};
  attn::DecodeArgs d{q_d,  k_pages, v_pages, tables, lens,       o_d,
                     part, count,   Hq,      Hkv,    page,       max_pages,
                     splits, sm_scale};
  ATTN_DISPATCH(dtype, D, run, desc, n_slots, p, d,
                static_cast<cudaStream_t>(stream));
}
