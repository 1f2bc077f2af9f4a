// Paged decode attention: one query token per sequence over a paged KV pool.
//
// Replaces: repro/kernels/paged_attention.py, paged_attention ->
// _paged_kernel (Pallas, TPU).  There scalar prefetch brought the block
// table ahead of a grid whose innermost dimension walked pages in order,
// carrying (m, l, acc) in VMEM.
//
// Bound on the H100: bytes.  Each cached K and V row is needed once, and
// the arithmetic per byte is about G multiply-adds, far below the ~295
// operations a byte where the tensor cores would become the limit; so no
// tensor cores here, and the design is about moving the bytes with enough
// of the card.  One CTA per (sequence, kv head) gave only B*Hkv CTAs (32
// at a serving batch of 4 on 132 SMs).  So the grid is (splits, Hkv, B):
// each CTA covers SPLIT = 256 keys of one (sequence, kv head), and the
// split count comes from the block table's width, a shape the host holds,
// never from seq_lens on the device.  Within a split, the pool rows of its
// keys are looked up once; then each warp walks its own 8-key blocks
// through a three-stage cp.async ring with its own online softmax, so the
// key loop has no CTA barrier, and each K chunk is converted once for all
// G heads (attn_tiles.cuh paged_tile).  K/V stay in the input dtype.  Every
// K/V row of the valid prefix is read once for all G = Hq/Hkv query heads
// that share it; no page past seq_len (and no padded table entry) is read.
// Each split writes a float32 partial (m, l, acc) to a workspace the
// wrapper allocates; the last CTA of a (sequence, kv head), found with an
// atomic counter behind __threadfence, merges the partials in split order
// and writes o.  One launch, no host sync.  The counters must not be
// shared by launches that run at the same time: the wrapper keeps one
// buffer per device and stream.
#include "attn_tiles.cuh"

template <typename T, int D>
__global__ void __launch_bounds__(attn::THREADS, attn::MinCtas<T>::value)
    paged_kernel(attn::DecodeArgs a) {
  extern __shared__ float smem[];
  attn::paged_tile<T, D>(a, blockIdx.z, blockIdx.y, blockIdx.x, smem);
}

template <typename T, int D>
static int run(const attn::DecodeArgs& a, int B, cudaStream_t stream) {
  const size_t smem =
      attn::paged_smem_bytes(D, a.Hq / a.Hkv, static_cast<int>(sizeof(T)),
                             a.splits);
  return attn::launch(paged_kernel<T, D>, dim3(a.splits, a.Hkv, B), smem,
                      stream, a);
}

// q (B,Hq,D) and o (B,Hq,D) dense; k/v pages (N,page,Hkv,D) dense;
// tables (B,max_pages) int32; lens (B,) int32 valid tokens per sequence;
// part (B*Hkv*splits*G*(D+2),) float32 scratch; count (>= B*Hkv,) int32,
// zero before the launch and left zero after it.
extern "C" int paged_attention_launch(
    int dtype, int D, const void* q, const void* k_pages, const void* v_pages,
    const int* tables, const int* lens, void* o, float* part, int* count,
    int B, int Hq, int Hkv, int page, int max_pages, int splits,
    float sm_scale, void* stream) {
  attn::DecodeArgs a{q,    k_pages, v_pages, tables, lens,       o,
                     part, count,   Hq,      Hkv,    page,       max_pages,
                     splits, sm_scale};
  ATTN_DISPATCH(dtype, D, run, a, B, static_cast<cudaStream_t>(stream));
}
