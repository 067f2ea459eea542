// K1: forward-membership keyword scoring, title and body in one pass, and
// K3, its one-section entry point (ss_membership1, below).
//
// K1 replaces the TPU kernel spaghettisearch_tpu/ops/kernels/membership.py
// pallas_forward_scores_2sec (_kernel2). For query row b and doc d, per
// section:
//     score[b, d] = sum_j fw[d, j] * #{q : ft[d, j] == tq[b, q]}
//     count[b, d] = the same sum without fw   (only when counts are emitted)
// The body sweep reads its own term tile btq (the hot-term split masks hot
// slots to the sentinel; the caller adds their body weight by matmul) and its
// own per-8-row bound qnb. With body_tmax (doc-sorted layout) the body sweep
// of each 512-doc block stops at the block's max distinct-term count.
//
// What bounds it on the H100: integer compares on the CUDA cores
// (B * T * q per doc: ~6.5e9 at 100k docs, B=128, q=4) and the [T, D]
// forward tiles streamed from HBM/L2 once per row tile, plus the [B, D] f32
// outputs written once.
//
// Design: one thread per doc walks its term slots j (coalesced: the doc axis
// is contiguous), loading ft/fw once per 32-row tile and comparing against
// the tile's query terms held in shared memory (a warp-wide broadcast read).
// The compare loop of each 8-row sub-block stops at that sub-block's max
// active term count, as the TPU kernel's qn dispatch does, and a warp stops
// at its first all-pad slot row. The per-row sums stay in registers; each
// output element is written exactly once. Blocks are independent: the grid is
// (doc blocks of 128) x (row tiles of 32), no cross-block reduction.
#include "common.cuh"

namespace ss {

template <bool kCounts>
__global__ void __launch_bounds__(kDocsPerBlock)
membership2_kernel(const int* __restrict__ title_ftT,
                   const float* __restrict__ title_fwT, int Tt,
                   const int* __restrict__ body_ftT,
                   const float* __restrict__ body_fwT, int Tb, int D,
                   const int* __restrict__ tq, const int* __restrict__ btq,
                   int B, int Q, const int* __restrict__ qn_blk,
                   const int* __restrict__ qnb_blk,
                   const int* __restrict__ body_tmax, int tmax_block,
                   float* __restrict__ ts, float* __restrict__ tc,
                   float* __restrict__ bs, float* __restrict__ bc) {
  __shared__ int s_tq[kRowTile * kQMax];
  __shared__ int s_btq[kRowTile * kQMax];
  __shared__ int s_qn[kSubs];
  __shared__ int s_qnb[kSubs];
  const int r0 = blockIdx.y * kRowTile;
  load_rows_i32(s_tq, tq, r0, B, Q);
  load_rows_i32(s_btq, btq, r0, B, Q);
  load_bounds(s_qn, qn_blk, r0, B, Q);
  load_bounds(s_qnb, qnb_blk, r0, B, Q);
  __syncthreads();

  const int d = blockIdx.x * kDocsPerBlock + threadIdx.x;
  const bool live = d < D;
  float score[kRowTile];
  float count[kRowTile];
  section_sweep<kCounts>(title_ftT, title_fwT, Tt, D, d, live, s_tq, s_qn, Q,
                         score, count);
  store_rows<kCounts>(ts, tc, r0, B, D, d, live, score, count);
  const int bound = body_bound(body_tmax, tmax_block, Tb, D, d);
  section_sweep<kCounts>(body_ftT, body_fwT, bound, D, d, live, s_btq, s_qnb,
                         Q, score, count);
  store_rows<kCounts>(bs, bc, r0, B, D, d, live, score, count);
}

// K3: one section (replaces membership.py pallas_forward_scores / _kernel):
// the same sweep over one [T, D] tile against one term tile, bounded per
// 8-row sub-block by qn; no hot split and no doc-sorted bound, like the TPU
// kernel.
template <bool kCounts>
__global__ void __launch_bounds__(kDocsPerBlock)
membership1_kernel(const int* __restrict__ ftT, const float* __restrict__ fwT,
                   int T, int D, const int* __restrict__ tq, int B, int Q,
                   const int* __restrict__ qn_blk, float* __restrict__ out_s,
                   float* __restrict__ out_c) {
  __shared__ int s_tq[kRowTile * kQMax];
  __shared__ int s_qn[kSubs];
  const int r0 = blockIdx.y * kRowTile;
  load_rows_i32(s_tq, tq, r0, B, Q);
  load_bounds(s_qn, qn_blk, r0, B, Q);
  __syncthreads();

  const int d = blockIdx.x * kDocsPerBlock + threadIdx.x;
  const bool live = d < D;
  float score[kRowTile];
  float count[kRowTile];
  section_sweep<kCounts>(ftT, fwT, T, D, d, live, s_tq, s_qn, Q, score, count);
  store_rows<kCounts>(out_s, out_c, r0, B, D, d, live, score, count);
}

}  // namespace ss

extern "C" int ss_membership1(const int* ftT, const float* fwT, int T, int D,
                              const int* tq, int B, int Q, const int* qn_blk,
                              float* out_s, float* out_c, void* stream) {
  const dim3 grid((D + ss::kDocsPerBlock - 1) / ss::kDocsPerBlock,
                  (B + ss::kRowTile - 1) / ss::kRowTile);
  const dim3 block(ss::kDocsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_c != nullptr) {
    ss::membership1_kernel<true><<<grid, block, 0, st>>>(
        ftT, fwT, T, D, tq, B, Q, qn_blk, out_s, out_c);
  } else {
    ss::membership1_kernel<false><<<grid, block, 0, st>>>(
        ftT, fwT, T, D, tq, B, Q, qn_blk, out_s, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ss_membership2(const int* title_ftT, const float* title_fwT,
                              int Tt, const int* body_ftT,
                              const float* body_fwT, int Tb, int D,
                              const int* tq, const int* btq, int B, int Q,
                              const int* qn_blk, const int* qnb_blk,
                              const int* body_tmax, int tmax_block, float* ts,
                              float* tc, float* bs, float* bc, void* stream) {
  const dim3 grid((D + ss::kDocsPerBlock - 1) / ss::kDocsPerBlock,
                  (B + ss::kRowTile - 1) / ss::kRowTile);
  const dim3 block(ss::kDocsPerBlock);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc != nullptr) {
    ss::membership2_kernel<true><<<grid, block, 0, st>>>(
        title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, tq, btq, B, Q,
        qn_blk, qnb_blk, body_tmax, tmax_block, ts, tc, bs, bc);
  } else {
    ss::membership2_kernel<false><<<grid, block, 0, st>>>(
        title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, tq, btq, B, Q,
        qn_blk, qnb_blk, body_tmax, tmax_block, ts, nullptr, bs, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
