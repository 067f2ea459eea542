// K1: forward-membership keyword scoring, title and body in one pass, and
// K3, its one-section entry point (ss_membership1, below).
//
// K1 replaces the TPU kernel spaghettisearch_tpu/ops/kernels/membership.py
// pallas_forward_scores_2sec (_kernel2), K3 pallas_forward_scores
// (_kernel). For query row b and doc d, per section:
//     score[b, d] = sum_j fw[d, j] * #{q : ft[d, j] == tq[b, q]}
//     count[b, d] = the same sum without fw   (only when counts are emitted)
// The body sweep reads the cold terms only (the hot-term split: the caller
// adds hot body weights by matmul). With body_tmax (doc-sorted layout) the
// body sweep of each 512-doc block stops at the block's max distinct-term
// count.
//
// What bounds both on the H100: bytes. They must read the term id of each
// doc's real slots (4 B each: ~32 MB at 100k docs for both sections, ~31
// MB for the body alone; a weight only where a row asks for the slot's
// term) and write the [B, D] f32 outputs (K1: 2 or 4 of them, 103 MB at
// B=128 with counts elided; K3: score and count of one section, also 103
// MB), ~40 us at 3.35 TB/s. They do no arithmetic worth counting: the
// work is integer matching, so tensor cores do not apply.
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
//
// K3 is the same design for one section: the build makes one table per row
// tile (columns < qn, all Q without it: K1's title table), and one sweep
// adds its sums and, always on the custom-blend route, its counts. No rows
// are padded: a ragged last tile builds and stores only its rows. Two
// things differ from K1, both measured on an H100 at B=128 (PERF.md):
// - K3 has no hot split, so the hot query terms stay in the table and
//   some lane of a warp passes the filter in most slot rows. Walking a
//   batch's slots one by one, the warp then takes its lanes' hits one
//   after the other; K3 compacts them (probe.cuh sweep, kCompact): each
//   lane marks the batch's slots that pass and walks its own marks, so
//   the lanes take their k-th hits together (0.2332 -> 0.1299 ms per
//   call).
// - Counts are uint16 in shared memory (at most T x Q = 4096): 32 KB of
//   sums + 16 KB of counts + the filter and table give 4 blocks per SM,
//   where f32 counts gave 3 (0.1299 -> 0.1187 ms).
#include "probe.cuh"

namespace ss {

// One keyword section of a row tile for this thread's doc: stage the
// tile's table, zero the row sums (and counts), sweep, store the rows
// below B.
template <bool kCounts, bool kCompact, class CountT>
__device__ inline void keyword_section(const probe::Smem& sm, CountT* acc_c,
                                       int R, int N,
                                       const int* __restrict__ g_term,
                                       const int* __restrict__ g_pay,
                                       const int* __restrict__ ftT,
                                       const float* __restrict__ fwT,
                                       int bound, int D, int d, bool live,
                                       int r0, int B, float* __restrict__ out_s,
                                       float* __restrict__ out_c) {
  using namespace probe;
  const int n = stage_table(sm.term, sm.pay, sm.filter, g_term, g_pay, N);
  zero_rows(sm.acc, R);
  if (kCounts) zero_rows(acc_c, R);
  sweep<kCounts, false, false, kCompact>(ftT, fwT, bound, D, d, live, sm.term,
                                         sm.pay, sm.filter, n, sm.acc, acc_c,
                                         nullptr);
  if (live) {
    store_rows(out_s, sm.acc, r0, R, B, D, d);
    if (kCounts) store_rows(out_c, acc_c, r0, R, B, D, d);
  }
}

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
  const Smem sm = smem_layout(smem, R, kCounts ? 2 : 1, N);
  float* acc_c = sm.acc + R * kDocs;
  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int d = blockIdx.y * kDocs + threadIdx.x;
  const bool live = d < D;

  const size_t title = (size_t)tile * N;
  keyword_section<kCounts, false>(sm, acc_c, R, N, tbl_term + title,
                                  tbl_pay + title, title_ftT, title_fwT, Tt, D,
                                  d, live, r0, B, ts, tc);
  const size_t body = (size_t)(gridDim.x + tile) * N;
  const int bound = body_bound(body_tmax, tmax_block, Tb, D, d);
  keyword_section<kCounts, false>(sm, acc_c, R, N, tbl_term + body,
                                  tbl_pay + body, body_ftT, body_fwT, bound, D,
                                  d, live, r0, B, bs, bc);
}

// K3: one section against its one table per row tile, hits compacted per
// warp; no hot split and no doc-sorted bound, like the TPU kernel. The
// counts are uint16 in shared memory (a count is at most T x Q = 4096),
// after the table: 16 KB at R=64 where f32 counts took 32 KB.
template <bool kCounts>
__global__ void __launch_bounds__(probe::kDocs)
membership1_kernel(const int* __restrict__ ftT, const float* __restrict__ fwT,
                   int T, int D, const int* __restrict__ tbl_term,
                   const int* __restrict__ tbl_pay, int N, int R, int B,
                   float* __restrict__ out_s, float* __restrict__ out_c) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, R, 1, N);
  uint16_t* acc_c = reinterpret_cast<uint16_t*>(sm.extra) + threadIdx.x;
  const int tile = blockIdx.x;
  const int d = blockIdx.y * kDocs + threadIdx.x;
  const size_t off = (size_t)tile * N;
  keyword_section<kCounts, true>(sm, acc_c, R, N, tbl_term + off, tbl_pay + off,
                                 ftT, fwT, T, D, d, d < D, tile * R, B, out_s,
                                 out_c);
}

}  // namespace ss

// K3: build the batch's one-section tables into `tables` (probe.cuh Tables
// layout, one section), then sweep.
extern "C" int ss_membership1(const int* ftT, const float* fwT, int T, int D,
                              const int* tq, int B, int Q, const int* qn,
                              int* tables, int R, int N, float* out_s,
                              float* out_c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 1);
  tb.req = nullptr;
  int err = ss::probe::launch_build(tq, B, Q, qn, nullptr, nullptr, nullptr, 0,
                                    R, N, 1, tb, st);
  if (err != 0) return err;
  const size_t smem = ss::probe::smem_bytes(
      R, 1, N, out_c != nullptr ? (size_t)R * ss::probe::kDocs * 2 : 0);
  using ss::probe::launch_sweep;
  if (out_c != nullptr)
    return launch_sweep(ss::membership1_kernel<true>, n_tiles, D, smem, st, ftT,
                        fwT, T, D, tb.term, tb.pay, N, R, B, out_s, out_c);
  return launch_sweep(ss::membership1_kernel<false>, n_tiles, D, smem, st, ftT,
                      fwT, T, D, tb.term, tb.pay, N, R, B, out_s,
                      (float*)nullptr);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  const ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 2);
  int err = ss::probe::launch_build(tq, B, Q, qn, qnb, nullptr, nullptr, 0, R,
                                    N, 2, tb, st);
  if (err != 0) return err;
  const size_t smem = ss::probe::smem_bytes(R, tc != nullptr ? 2 : 1, N, 0);
  using ss::probe::launch_sweep;
  if (tc != nullptr)
    return launch_sweep(ss::membership2_kernel<true>, n_tiles, D, smem, st,
                        title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D,
                        tb.term, tb.pay, N, R, B, body_tmax, tmax_block, ts, tc,
                        bs, bc);
  return launch_sweep(ss::membership2_kernel<false>, n_tiles, D, smem, st,
                      title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D,
                      tb.term, tb.pay, N, R, B, body_tmax, tmax_block, ts,
                      (float*)nullptr, bs, (float*)nullptr);
}

// The table build alone, for holding it against its plain version
// (probe.py build_tables): K1's keyword tables (sections 2), K2's with
// phrases, or the one table of K3 (sections 1, columns < qn) or K4
// (sections 1, qn null: all columns).
extern "C" int ss_probe_tables(const int* tq, int B, int Q, const int* qn,
                               const int* qnb, const int* ph_ids,
                               const float* ph_valid, int P, int R, int N,
                               int sections, int* tables, void* stream) {
  ss::probe::Tables tb =
      ss::probe::tables_at(tables, (B + R - 1) / R, N, sections);
  if (P == 0) tb.req = nullptr;
  return ss::probe::launch_build(tq, B, Q, qn, qnb, ph_ids, ph_valid, P, R, N,
                                 sections, tb, static_cast<cudaStream_t>(stream));
}
