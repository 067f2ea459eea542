// K4: both sections' membership scoring + score finalization in one pass.
//
// Replaces the TPU kernel spaghettisearch_tpu/ops/kernels/fused.py
// pallas_fused_final_scores (_kernel). For query row b and doc d:
//     score_s, count_s = K1's sweep of section s over all Q terms
//                        (no per-row term bound, no hot split)
//     norm_s     = score_s / (mag_s[d] * qmag[b])       NaN -> 0, +inf kept
//     sqd        = sum_c tp[b, c] * prT[c, d]
//     final[b,d] = (w_pr*sqd + w_title*norm_t + w_body*norm_b) * scale,
//                  -inf where count_t + count_b == 0
// Only `final` [B, D] is written: the four [B, D] score/count arrays of the
// unfused path never reach device memory.
//
// What bounds it on the H100: as K1, the integer compares (B * T * Q per
// doc) and the [T, D] forward tiles streamed once per 32-row tile; the
// finalize adds C + 2 loads per doc per row, mostly L1 hits.
//
// Design: one thread per doc, 32 query rows per block (the row tile's terms,
// qmag and topic probabilities in shared memory). Both sweeps keep their
// per-row sums in registers; candidacy needs only "some slot matched", so the
// counts collapse into one 32-bit hit mask per section. The arithmetic after
// the sweeps uses the round-to-nearest intrinsics (__fmul_rn / __fadd_rn /
// __fdiv_rn), which nvcc never contracts into FMAs, in the plain version's
// order, so the only drift against it is the summation order of the sweep
// and of sqd. Compiled without --use_fast_math: isnan() and IEEE division
// keep NaN -> 0 and +inf exactly.
#include <math.h>

#include "common.cuh"

namespace ss {

constexpr int kCMax = 64;  // topic categories a row tile holds in smem

// One section's sweep against the row tile: score[r] += w * multiplicity,
// bit r of the returned mask set when some slot matched row r.
__device__ inline unsigned fused_sweep(const int* __restrict__ ftT,
                                       const float* __restrict__ fwT, int T,
                                       int D, int d, bool live,
                                       const int* s_terms, const int* s_qb,
                                       int Q, float (&score)[kRowTile]) {
  unsigned hit = 0u;
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) score[r] = 0.f;
  for (int j = 0; j < T; ++j) {
    const int f = live ? __ldg(ftT + (size_t)j * D + d) : -1;
    if (__all_sync(0xffffffffu, f < 0)) break;  // the rest are pad slots
    const float w = live ? __ldg(fwT + (size_t)j * D + d) : 0.f;
#pragma unroll
    for (int s = 0; s < kSubs; ++s) {
      const int qb = s_qb[s];
      if (qb == 0) continue;
#pragma unroll
      for (int r = 0; r < kSub; ++r) {
        const int* tq = s_terms + (s * kSub + r) * Q;
        int m = 0;
        for (int q = 0; q < qb; ++q) m += (tq[q] == f);
        if (m) {
          score[s * kSub + r] += w * (float)m;
          hit |= 1u << (s * kSub + r);
        }
      }
    }
  }
  return hit;
}

__device__ inline float normalize(float s, float mag, float qmag) {
  const float n = __fdiv_rn(s, __fmul_rn(mag, qmag));
  return isnan(n) ? 0.f : n;
}

__global__ void __launch_bounds__(kDocsPerBlock)
fused_kernel(const int* __restrict__ title_ftT,
             const float* __restrict__ title_fwT, int Tt,
             const int* __restrict__ body_ftT,
             const float* __restrict__ body_fwT, int Tb, int D,
             const float* __restrict__ mag_t, const float* __restrict__ mag_b,
             const float* __restrict__ prT, int C,
             const int* __restrict__ tq, int B, int Q,
             const float* __restrict__ qmag, const float* __restrict__ tp,
             float w_pr, float w_title, float w_body, float scale,
             float* __restrict__ out) {
  __shared__ int s_tq[kRowTile * kQMax];
  __shared__ int s_qb[kSubs];
  __shared__ float s_qmag[kRowTile];
  __shared__ float s_tp[kRowTile * kCMax];
  const int r0 = blockIdx.y * kRowTile;
  load_rows_i32(s_tq, tq, r0, B, Q);
  if (threadIdx.x < kSubs) s_qb[threadIdx.x] = r0 + threadIdx.x * kSub < B ? Q : 0;
  if (threadIdx.x < kRowTile) {
    const int row = r0 + threadIdx.x;
    s_qmag[threadIdx.x] = row < B ? qmag[row] : 1.f;
  }
  for (int i = threadIdx.x; i < kRowTile * C; i += blockDim.x) {
    const int row = r0 + i / C;
    s_tp[i] = row < B ? tp[(size_t)row * C + i % C] : 0.f;
  }
  __syncthreads();

  const int d = blockIdx.x * kDocsPerBlock + threadIdx.x;
  const bool live = d < D;
  float ts[kRowTile];
  float bs[kRowTile];
  const unsigned t_hit =
      fused_sweep(title_ftT, title_fwT, Tt, D, d, live, s_tq, s_qb, Q, ts);
  const unsigned b_hit =
      fused_sweep(body_ftT, body_fwT, Tb, D, d, live, s_tq, s_qb, Q, bs);
  if (!live) return;
  const float mt = __ldg(mag_t + d);
  const float mb = __ldg(mag_b + d);
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    const int row = r0 + r;
    if (row >= B) break;
    float v = -INFINITY;
    if ((t_hit | b_hit) & (1u << r)) {
      const float tn = normalize(ts[r], mt, s_qmag[r]);
      const float bn = normalize(bs[r], mb, s_qmag[r]);
      float sqd = 0.f;
      for (int c = 0; c < C; ++c)
        sqd = __fadd_rn(sqd, __fmul_rn(s_tp[r * C + c], __ldg(prT + (size_t)c * D + d)));
      const float blend = __fadd_rn(
          __fadd_rn(__fmul_rn(w_pr, sqd), __fmul_rn(w_title, tn)),
          __fmul_rn(w_body, bn));
      v = __fmul_rn(blend, scale);
    }
    out[(size_t)row * D + d] = v;
  }
}

}  // namespace ss

extern "C" int ss_fused(const int* title_ftT, const float* title_fwT, int Tt,
                        const int* body_ftT, const float* body_fwT, int Tb,
                        int D, const float* mag_t, const float* mag_b,
                        const float* prT, int C, const int* tq, int B, int Q,
                        const float* qmag, const float* tp, float w_pr,
                        float w_title, float w_body, float scale, float* out,
                        void* stream) {
  if (C < 1 || C > ss::kCMax || Q < 1 || Q > ss::kQMax) return -1;
  const dim3 grid((D + ss::kDocsPerBlock - 1) / ss::kDocsPerBlock,
                  (B + ss::kRowTile - 1) / ss::kRowTile);
  const dim3 block(ss::kDocsPerBlock);
  ss::fused_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, mag_t, mag_b, prT,
      C, tq, B, Q, qmag, tp, w_pr, w_title, w_body, scale, out);
  return static_cast<int>(cudaGetLastError());
}
