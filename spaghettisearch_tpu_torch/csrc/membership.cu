// K1: forward-membership keyword scoring, title and body in one pass, and
// K3, its one-section entry point (ss_membership1, below).
//
// K1 replaces the TPU kernel spaghettisearch_tpu/ops/kernels/membership.py
// pallas_forward_scores_2sec (_kernel2). For query row b and doc d, per
// section:
//     score[b, d] = sum_j fw[d, j] * #{q : ft[d, j] == tq[b, q]}
//     count[b, d] = the same sum without fw   (only when counts are emitted)
// The body sweep reads the cold terms only (the hot-term split: the caller
// adds hot body weights by matmul). With body_tmax (doc-sorted layout) the
// body sweep of each 512-doc block stops at the block's max distinct-term
// count.
//
// What bounds it on the H100: bytes. It must read the term id of each
// doc's real slots (4 B each: ~32 MB at 100k docs; a weight only where a
// row asks for the slot's term) and write the [B, D] f32 outputs (2 or 4
// of them: 103 MB at B=128 with counts elided), ~40 us at 3.35 TB/s. It
// does no arithmetic worth counting: the work is integer matching, so
// tensor cores do not apply.
//
// Design (probe, don't compare; csrc/probe.cuh): a first small kernel
// builds, per section and row tile, a sorted table of the batch's distinct
// (term, row) pairs with their multiplicity (ops/kernels/probe.py
// build_tables is its plain version, held to it entry for entry; built
// with torch ops, the table cost ~20 launches of host time per call, more
// than the sweep). A block stages the table in shared memory with a hash
// filter and each thread probes each real slot of its doc once, instead of
// comparing it with every query term of a 32-row tile. A miss costs one
// shared-memory load and touches no sums. With compares gone the row tile
// grows to 64 rows; the per-row sums sit in shared memory, one column per
// thread, and set the occupancy (32 KB of sums and ~6 KB of filter and
// table per block at Q=4: 5 blocks per SM). The grid puts the row tiles of
// one doc block next to each other, so at B=128 the second tile finds the
// slots in L2 and the forward tiles stream from HBM about once per batch.
// (On an H100 at B=128, 64-row tiles measured 0.1029 ms on the device
// against 0.1036 ms for one 128-row tile, and K2 0.198-0.205 ms against
// 0.224 ms.) Slot ids are pipelined through registers (the next kUnroll
// loads in flight while the current ones are probed) rather than staged
// through shared memory with cp.async or TMA: the loads are already whole
// 128-byte lines, fw is read only on a hit, and shared memory is spent on
// the sums; a 16-deep pipeline measured no faster. Each doc's matches are
// added in slot order (w * multiplicity), as before.
#include "common.cuh"
#include "probe.cuh"

namespace ss {

template <bool kCounts>
__global__ void __launch_bounds__(probe::kDocs)
membership2_kernel(const int* __restrict__ title_ftT,
                   const float* __restrict__ title_fwT, int Tt,
                   const int* __restrict__ body_ftT,
                   const float* __restrict__ body_fwT, int Tb, int D,
                   const int* __restrict__ tbl_term,
                   const int* __restrict__ tbl_pay, int N, int R, int B,
                   const int* __restrict__ body_tmax, int tmax_block,
                   float* __restrict__ ts, float* __restrict__ tc,
                   float* __restrict__ bs, float* __restrict__ bc) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem) + threadIdx.x;
  float* acc_c = acc_s + R * kDocs;
  uint32_t* s_filter =
      reinterpret_cast<uint32_t*>(smem + (size_t)R * kDocs * 4 * (kCounts ? 2 : 1));
  int* s_term = reinterpret_cast<int*>(s_filter + kFilterWords);
  int* s_pay = s_term + N;

  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int d = blockIdx.y * kDocs + threadIdx.x;
  const bool live = d < D;

  const size_t title = (size_t)tile * N;
  int n = stage_table(s_term, s_pay, s_filter, tbl_term + title,
                      tbl_pay + title, N);
  zero_rows(acc_s, R);
  if (kCounts) zero_rows(acc_c, R);
  sweep<kCounts, false>(title_ftT, title_fwT, Tt, D, d, live, s_term, s_pay,
                        s_filter, n, acc_s, acc_c, nullptr);
  if (live) {
    probe::store_rows(ts, acc_s, r0, R, B, D, d);
    if (kCounts) probe::store_rows(tc, acc_c, r0, R, B, D, d);
  }

  const size_t body = (size_t)(gridDim.x + tile) * N;
  n = stage_table(s_term, s_pay, s_filter, tbl_term + body, tbl_pay + body, N);
  zero_rows(acc_s, R);
  if (kCounts) zero_rows(acc_c, R);
  const int bound = body_bound(body_tmax, tmax_block, Tb, D, d);
  sweep<kCounts, false>(body_ftT, body_fwT, bound, D, d, live, s_term, s_pay,
                        s_filter, n, acc_s, acc_c, nullptr);
  if (live) {
    probe::store_rows(bs, acc_s, r0, R, B, D, d);
    if (kCounts) probe::store_rows(bc, acc_c, r0, R, B, D, d);
  }
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

// K1: build the batch's probe tables into `tables` (probe.cuh Tables
// layout), then sweep.
extern "C" int ss_membership2(const int* title_ftT, const float* title_fwT,
                              int Tt, const int* body_ftT,
                              const float* body_fwT, int Tb, int D,
                              const int* tq, int B, int Q, const int* qn,
                              const int* qnb, const int* body_tmax,
                              int tmax_block, int* tables, int R, int N,
                              float* ts, float* tc, float* bs, float* bc,
                              void* stream) {
  using ss::probe::kDocs;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  const ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N);
  int err = ss::probe::launch_build(tq, B, Q, qn, qnb, nullptr, nullptr, 0, R,
                                    N, tb, st);
  if (err != 0) return err;
  const dim3 grid(n_tiles, (D + kDocs - 1) / kDocs);  // a doc block's row tiles adjacent
  const size_t smem = ss::probe::smem_bytes(R, tc != nullptr, N, 0);
  auto launch = [&](auto kernel, float* c_title, float* c_body) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kDocs, smem, st>>>(title_ftT, title_fwT, Tt, body_ftT,
                                      body_fwT, Tb, D, tb.term, tb.pay, N, R,
                                      B, body_tmax, tmax_block, ts, c_title, bs,
                                      c_body);
    return (int)cudaGetLastError();
  };
  if (tc != nullptr) return launch(ss::membership2_kernel<true>, tc, bc);
  return launch(ss::membership2_kernel<false>, nullptr, nullptr);
}

// The table build alone (K1's keyword tables, or K2's with phrases), for
// holding it against its plain version (probe.py build_tables).
extern "C" int ss_probe_tables(const int* tq, int B, int Q, const int* qn,
                               const int* qnb, const int* ph_ids,
                               const float* ph_valid, int P, int R, int N,
                               int* tables, void* stream) {
  const ss::probe::Tables tb =
      ss::probe::tables_at(tables, (B + R - 1) / R, N);
  return ss::probe::launch_build(tq, B, Q, qn, qnb, ph_ids, ph_valid, P, R, N,
                                 P > 0 ? tb : ss::probe::Tables{tb.term, tb.pay, nullptr},
                                 static_cast<cudaStream_t>(stream));
}
