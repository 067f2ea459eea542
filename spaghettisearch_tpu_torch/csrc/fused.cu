// K4: both sections' membership scoring + score finalization in one pass.
//
// Replaces the TPU kernel spaghettisearch_tpu/ops/kernels/fused.py
// pallas_fused_final_scores (_kernel). For query row b and doc d:
//     score_s, count_s = K1's sweep of section s over all Q terms
//                        (no per-row term bound, no hot split)
//     norm_s     = score_s / (mag_s[d] * sqrt(qlen[b]))   NaN -> 0, +inf kept
//     sqd        = sum_c tp[b, c] * prT[c, d]
//     final[b,d] = (w_pr*sqd + w_title*norm_t + w_body*norm_b) * scale,
//                  -inf where count_t + count_b == 0
// Only `final` [B, D] is written: the four [B, D] score/count arrays of the
// unfused path never reach device memory.
//
// What bounds it on the H100: bytes. It must read the term id of each real
// slot of both sections (~32 MB at 100k docs; a weight only where a row
// asks for the slot's term), mag_t, mag_b and the C PageRank rows once, and
// write the one [B, D] f32 output (51 MB at B=128): ~27 us at 3.35 TB/s.
//
// Design (csrc/probe.cuh, as K1): K4 reads all Q columns of both sections
// and has no hot split, so the title and body tables of a row tile are the
// same. The build makes one table per 64-row tile; a block stages it once
// and sweeps the title, then the body, against it, keeping both sections'
// per-row sums in shared memory (one column per thread: 2 x 32 KB at R=64).
// Like K3, it keeps the hot query terms in the table, so the sweep compacts
// each lane's hits of a slot batch (probe.cuh sweep, kCompact): the lanes
// of a warp take their k-th hits together instead of one lane after the
// other (0.3068 -> 0.2114 ms per B=128 call on an H100, PERF.md).
// Candidacy needs only "some slot of either section matched row r", so a
// 64-bit hit mask in registers replaces the counts (a zero-weight hit sets
// it too). The finalize runs from shared memory per owned doc: mag and the
// C PageRank values of the doc are read once (held in registers, unrolled
// over kCMax with a uniform early exit), qmag and the topic probabilities
// of the tile's rows sit in shared memory, and each row's value is stored
// by its owner, a warp writing 128 contiguous bytes of one row. Shared
// memory per block: 64 KB of sums, the 4 KB filter, the table (2 KB at
// Q=4, 16 KB at Q=32), R x C topic probabilities (up to 16 KB) and R
// qmags: at Q=4, C=1, 3 blocks per SM. The arithmetic after the sweeps uses
// the round-to-nearest intrinsics (__fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn), which nvcc never contracts into FMAs, in the plain version's
// order, so the only drift against it is the summation order of the sweep
// (slot order) and of sqd. Compiled without --use_fast_math: isnan() and
// IEEE division keep NaN -> 0 and +inf exactly.
#include <math.h>

#include "probe.cuh"

namespace ss {

constexpr int kCMax = 64;  // topic categories the finalize holds per doc

__device__ inline float normalize(float s, float mag, float qmag) {
  const float n = __fdiv_rn(s, __fmul_rn(mag, qmag));
  return isnan(n) ? 0.f : n;
}

__global__ void __launch_bounds__(probe::kDocs)
fused_kernel(const int* __restrict__ title_ftT,
             const float* __restrict__ title_fwT, int Tt,
             const int* __restrict__ body_ftT,
             const float* __restrict__ body_fwT, int Tb, int D,
             const float* __restrict__ mag_t, const float* __restrict__ mag_b,
             const float* __restrict__ prT, int C,
             const int* __restrict__ tbl_term, const int* __restrict__ tbl_pay,
             int N, int R, int B, const float* __restrict__ qlen,
             const float* __restrict__ tp, float w_pr, float w_title,
             float w_body, float scale, float* __restrict__ out) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, R, 2, N);
  float* acc_t = sm.acc;
  float* acc_b = sm.acc + R * kDocs;
  float* s_tp = reinterpret_cast<float*>(sm.extra);  // [R, C]
  float* s_qmag = s_tp + R * C;                      // [R]

  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int rows = min(R, B - r0);
  const int d = blockIdx.y * kDocs + threadIdx.x;
  const bool live = d < D;
  // read after stage_table's barriers
  for (int i = threadIdx.x; i < rows * C; i += blockDim.x)
    s_tp[i] = __ldg(tp + (size_t)r0 * C + i);
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    s_qmag[i] = __fsqrt_rn(__ldg(qlen + r0 + i));

  const size_t off = (size_t)tile * N;
  const int n = stage_table(sm.term, sm.pay, sm.filter, tbl_term + off,
                            tbl_pay + off, N);
  zero_rows(acc_t, R);
  zero_rows(acc_b, R);
  unsigned long long hit = 0ull;
  sweep<false, false, true, true, float>(title_ftT, title_fwT, Tt, D, d, live,
                                        sm.term, sm.pay, sm.filter, n, acc_t,
                                        nullptr, nullptr, &hit);
  sweep<false, false, true, true, float>(body_ftT, body_fwT, Tb, D, d, live,
                                        sm.term, sm.pay, sm.filter, n, acc_b,
                                        nullptr, nullptr, &hit);
  if (!live) return;

  const float mt = __ldg(mag_t + d);
  const float mb = __ldg(mag_b + d);
  float pr[kCMax];
#pragma unroll
  for (int c = 0; c < kCMax; ++c) {
    if (c >= C) break;
    pr[c] = __ldg(prT + (size_t)c * D + d);
  }
  for (int r = 0; r < rows; ++r) {
    float v = -INFINITY;
    if ((hit >> r) & 1ull) {
      const float qm = s_qmag[r];
      const float tn = normalize(acc_t[r * kDocs], mt, qm);
      const float bn = normalize(acc_b[r * kDocs], mb, qm);
      const float* tpr = s_tp + r * C;
      float sqd = 0.f;
#pragma unroll
      for (int c = 0; c < kCMax; ++c) {
        if (c >= C) break;
        sqd = __fadd_rn(sqd, __fmul_rn(tpr[c], pr[c]));
      }
      const float blend = __fadd_rn(
          __fadd_rn(__fmul_rn(w_pr, sqd), __fmul_rn(w_title, tn)),
          __fmul_rn(w_body, bn));
      v = __fmul_rn(blend, scale);
    }
    out[(size_t)(r0 + r) * D + d] = v;
  }
}

}  // namespace ss

// K4: build the batch's shared table (all Q columns) into `tables`
// (probe.cuh Tables layout, one section), then sweep and finalize.
// Refuses C or Q above the limits (at C=64, Q=32 a block takes ~103 KB
// of shared memory; launch_sweep's attribute call refuses what does not
// fit).
extern "C" int ss_fused(const int* title_ftT, const float* title_fwT, int Tt,
                        const int* body_ftT, const float* body_fwT, int Tb,
                        int D, const float* mag_t, const float* mag_b,
                        const float* prT, int C, const int* tq, int B, int Q,
                        const float* qlen, const float* tp, float w_pr,
                        float w_title, float w_body, float scale, int* tables,
                        int R, int N, float* out, void* stream) {
  if (C < 1 || C > ss::kCMax || Q < 1 || Q > ss::probe::kQMax)
    return (int)cudaErrorInvalidValue;
  // two sum arrays, the filter and the table, then R rows' topic
  // probabilities and qmags
  const size_t smem =
      ss::probe::smem_bytes(R, 2, N, (size_t)R * C * 4 + (size_t)R * 4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 1);
  tb.req = nullptr;
  int err = ss::probe::launch_build(tq, B, Q, nullptr, nullptr, nullptr,
                                    nullptr, 0, R, N, 1, tb, st);
  if (err != 0) return err;
  return ss::probe::launch_sweep(ss::fused_kernel, n_tiles, D, smem, st,
                                 title_ftT, title_fwT, Tt, body_ftT, body_fwT,
                                 Tb, D, mag_t, mag_b, prT, C, tb.term, tb.pay,
                                 N, R, B, qlen, tp, w_pr, w_title, w_body,
                                 scale, out);
}
