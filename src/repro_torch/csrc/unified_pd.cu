// Unified P/D attention: prefill flash tiles and decode paged tiles in one
// persistent launch, the paper's concurrent prefill+decode step, with
// decode holding an f_decode share of the SMs.
//
// Replaces: repro/kernels/unified_pd.py, unified_pd -> _unified_kernel
// (Pallas, TPU), with its slot schedule (build_slot_schedule) and
// descriptor table (_make_descriptors).  On the TPU the grid ran in slot
// order on one core, so the only knob f_decode had was how early decode
// tiles issued.  The paper's knob is spatial: CU masking gives decode a
// fixed share of the compute units while prefill takes the rest.  Here
// that share is real:
//   * the grid is persistent: min(tiles, SMs x CTAs-per-SM) CTAs (the
//     wrapper sizes it from the occupancy of this kernel), each looping
//     over tiles until both work queues are empty, so there are no waves;
//   * the tiles come from two queues of the reference's 7-column
//     descriptor rows, decode rows and then prefill rows, the prefill
//     rows longest first (most k-blocks read), so the heaviest tiles
//     start first and the tail is short; thread 0 takes the next row with
//     one atomicAdd on its queue's head and broadcasts it through shared
//     memory;
//   * a CTA on an SM whose %smid is below decode_sms = clamp(round(
//     f_decode x SMs), 1, SMs) takes decode tiles first, any other CTA
//     prefill tiles first; a CTA whose own queue is empty takes the other
//     queue's tiles (the overallocation of the reference's schedule, which
//     fills the slots after the last decode tile with prefill).
// No CTA ever waits for another, so the launch finishes even when only
// part of its grid is resident (a kernel on another stream holding SMs).
//
// The queue heads and a count of CTAs that have left live in the launching
// stream's counter buffer, after the split counters.  A CTA fences its
// last fetches before it counts itself out; the last one out resets all
// three to 0, so, as with the split counters, a launch leaves its stream's
// buffer zeroed and no memset precedes it.
//
// Bound on the H100: the sum of its two parts, operations for the prefill
// tiles and bytes for the decode tiles; decode's memory-bound tiles stream
// on their share of the SMs while prefill's tensor-core tiles run on the
// rest.  The tile bodies are the standalone kernels' (attn_tiles.cuh): the
// tensor-core prefill tile in bf16 and the split decode tile, column dkvh
// of a decode row being kvh * splits + split, with the same split count
// and merge.  So the outputs equal the standalone kernels' bit for bit in
// both dtypes, whatever f_decode is.  Both kinds share one block size and
// one dynamic shared-memory size, the larger of the two tiles' needs.  As
// paged_attention.cu, the kernel is instanced per decode head bucket (G <=
// 8 or G <= 16); the 16-head instance runs one CTA an SM in bf16
// (attn_tiles.cuh MinCtasG), so its grid, from the occupancy calculator,
// is one CTA an SM and f_decode's share of the SMs keeps its meaning.
//
// An optional trace (8 int64 values; the serving path passes
// null) records, from %globaltimer, the first CTA's start, the end of the
// last decode tile (after its merge) and of the last prefill tile, then
// %nsmid and the set of SM ids that ran a CTA: how a measurement sees
// whether a held share keeps decode's finish time apart from prefill.
#include "attn_tiles.cuh"

namespace unified {

// Control words after the split counters, zero between launches.
constexpr int DECODE_HEAD = 0, PREFILL_HEAD = 1, EXITED = 2;
// The trace: START, DECODE_END, PREFILL_END (ns), NSMID, then SM_WORDS
// 64-bit words of the set of SM ids.
constexpr int START = 0, DECODE_END = 1, PREFILL_END = 2, NSMID = 3,
              SM_SET = 4, SM_WORDS = 4;

struct Queues {
  const int* rows;  // (n_decode + n_prefill, 7): decode rows, then prefill
  int n_decode, n_prefill;
  int decode_sms;   // CTAs on SMs of id below this take decode tiles first
  int* ctl;         // Control words
  unsigned long long* trace;  // SM_SET + SM_WORDS values, or null
};

}  // namespace unified

using namespace unified;

// Thread 0, between two tiles of its CTA: ends the tile of row `prev`
// (none when < 0), whose threads have all passed a CTA barrier since, by
// invalidating a tensor-core prefill tile's barriers and stamping the
// trace; then takes the row of the CTA's next tile, its own queue first,
// or returns -1 once both queues are empty.  Not inlined, so that none of
// its state is held in registers across the tiles.
template <typename T, int D>
__device__ __noinline__ int between_tiles(Queues qs, int prev, void* smem) {
  if (prev >= 0) {
    const bool prefill = qs.rows[prev * 7] == attn::PREFILL;
    if (prefill) attn::prefill_tile_release<T, D>(smem);
    if (qs.trace)
      atomicMax(qs.trace + (prefill ? PREFILL_END : DECODE_END),
                hopper::global_ns());
  }
  const bool decode_first =
      hopper::sm_id() < static_cast<uint32_t>(qs.decode_sms);
  for (int pass = 0; pass < 2; ++pass) {
    if (decode_first == (pass == 0)) {
      const int i = atomicAdd(qs.ctl + DECODE_HEAD, 1);
      if (i < qs.n_decode) return i;
    } else {
      const int i = atomicAdd(qs.ctl + PREFILL_HEAD, 1);
      if (i < qs.n_prefill) return qs.n_decode + i;
    }
  }
  return -1;
}

template <typename T, int D, int GB,
          int CTAS = attn::MinCtasG<T, GB>::value>
__global__ void __launch_bounds__(attn::THREADS, CTAS)
    unified_kernel(Queues qs, attn::PrefillArgs p, attn::DecodeArgs d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;
  if (threadIdx.x == 0) {
    if (qs.trace) {
      const uint32_t sm = hopper::sm_id();
      atomicMin(qs.trace + START, hopper::global_ns());
      atomicMax(qs.trace + NSMID,
                static_cast<unsigned long long>(hopper::sm_id_bound()));
      atomicOr(qs.trace + SM_SET + (sm / 64) % SM_WORDS, 1ull << (sm % 64));
    }
    next = -1;
  }
  for (;;) {
    if (threadIdx.x == 0) next = between_tiles<T, D>(qs, next, smem);
    __syncthreads();
    const int i = next;
    if (i < 0) break;
    const int* row = qs.rows + i * 7;  // [kind, pb, ph, pkvh, pqi, db, dkvh]
    if (row[0] == attn::PREFILL)
      attn::prefill_tile<T, D>(p, row[1], row[2], row[4], smem);
    else
      attn::paged_tile<T, D, GB>(d, row[5], row[6] / d.splits,
                                 row[6] % d.splits, smem);
    // every thread is past the tile (the producer warpgroup and the
    // non-merging decode CTAs return early from it): its shared memory,
    // and `next`, are free for the next tile
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    __threadfence();  // this CTA's last fetches come before its exit
    if (atomicAdd(qs.ctl + EXITED, 1) == static_cast<int>(gridDim.x) - 1) {
      __threadfence();  // every CTA's fetches come before the reset
      atomicExch(qs.ctl + DECODE_HEAD, 0);
      atomicExch(qs.ctl + PREFILL_HEAD, 0);
      atomicExch(qs.ctl + EXITED, 0);
    }
  }
}

template <typename T, int D>
static int smem_bytes(int G, int splits) {
  const int flash = attn::prefill_smem_bytes<T, D>();
  const int paged =
      attn::paged_smem_bytes(D, G, static_cast<int>(sizeof(T)), splits);
  return flash > paged ? flash : paged;
}

template <typename T, int D>
static int run(const Queues& qs, int grid, const attn::PrefillArgs& p,
               const attn::DecodeArgs& d, cudaStream_t stream) {
  const int G = d.Hq / d.Hkv;
  return attn::with_head_bucket(G, [&](auto gb) {
    return attn::launch(unified_kernel<T, D, decltype(gb)::value>, dim3(grid),
                        smem_bytes<T, D>(G, d.splits), stream, qs, p, d);
  });
}

template <typename T, int D>
static int ctas_per_sm(int G, int splits, int* out) {
  const int smem = smem_bytes<T, D>(G, splits);
  return attn::with_head_bucket(G, [&](auto gb) {
    const auto kernel = unified_kernel<T, D, decltype(gb)::value>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel, attn::THREADS, smem));
  });
}

// The CTAs of the kernel that fit on one SM at once, for G query heads per
// kv head and `splits` decode splits (they set its shared memory).
extern "C" int unified_pd_ctas_per_sm(int dtype, int D, int G, int splits,
                                      int* out) {
  ATTN_DISPATCH(dtype, D, ctas_per_sm, G, splits, out);
}

// Prefill operands as flash_prefill_launch, decode operands as
// paged_attention_launch; rows (n_decode + n_prefill, 7) int32 on the
// device; ctl the stream's 3 control words after its split counters;
// trace SM_SET + SM_WORDS int64 or null.
extern "C" int unified_pd_launch(
    int dtype, int D, const int* rows, int n_decode, int n_prefill, int grid,
    int decode_sms, int* ctl, void* trace, const void* q, const void* k,
    const void* v, void* o, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long vb, long long vh,
    long long vs, long long ob, long long oh, long long os, int S, int Hq,
    int Hkv, int window, const void* q_d, const void* k_pages,
    const void* v_pages, const int* tables, const int* lens, void* o_d,
    float* part, int* count, int page, int max_pages, int splits,
    float sm_scale, void* stream) {
  const Queues queues{rows, n_decode, n_prefill, decode_sms, ctl,
                      static_cast<unsigned long long*>(trace)};
  attn::PrefillArgs p{q, k, v, o, {qb, qh, qs}, {kb, kh, ks}, {vb, vh, vs},
                      {ob, oh, os}, S, Hq, Hkv, window, sm_scale};
  attn::DecodeArgs d{q_d,  k_pages, v_pages, tables, lens,       o_d,
                     part, count,   Hq,      Hkv,    page,       max_pages,
                     splits, sm_scale};
  ATTN_DISPATCH(dtype, D, run, queues, grid, p, d,
                static_cast<cudaStream_t>(stream));
}
