// K5: both sections' membership scoring, a finalize and an exact top-k in
// one kernel pair: the [B, D] score matrix never reaches device memory.
//
// Replaces the TPU kernel experiments/fused2_probe.py build_kernel
// (pallas_call at :126), the prototype of a fused scorer. For query row b:
//     ts, tc = sum_q sum_t [ftT[t, d] == tq[b, q]] * (fwT[t, d], 1)  (title)
//     bs, bc = the same for the body                  (a term twice counts twice)
//     tn     = ts / (mag_t[d] * sqrt(qlen[b])), NaN -> 0 (x/0 stays inf)
//     final  = (0.38 * tn + 0.29 * bn) * 100, -inf where tc + bc == 0
//              (the reference's title and body weights and scale, passed in)
//     out    = the k largest finals of the row, descending; equal values by
//              ascending doc id (the TPU kernel's argmax takes the first of
//              equal values, and its earlier grid steps hold lower ids);
//              slots past the row's candidates hold -inf and id 0.
// The prototype's own finalize, not the production blend (no PageRank).
//
// What bounds it on the H100: bytes. It must read the term id of each real
// slot of both sections (~28 MB on the probe's synthetic 100k docs, ~34 MB
// on the 100k benchmark corpus), a weight only where a row asks for the
// slot's term, mag_t and mag_b once (0.8 MB), and write [B, k] values and
// ids: 9-13 us at 3.35 TB/s. The unfused path writes (and its top-k reads
// back) a [B, D] f32 matrix: 103 MB at B=256.
//
// Design. The TPU kernel carries each row's top-k across a sequential grid
// in VMEM. Blocks of a CUDA grid run in no order, so the top-k is two
// passes here:
//  1. fused_topk_kernel: a block owns one row tile (R rows, one probe table,
//     as K4: all Q columns, built once per tile by probe.cuh's
//     build_tables_kernel) and `chunks` consecutive 128-doc chunks. It
//     stages the table once, then per chunk sweeps title and body into two
//     shared-memory sum arrays (one column per thread, hits compacted per
//     warp, a 64-bit hit mask for candidacy, as K4), finalizes each row's
//     value in place with the round-to-nearest intrinsics in the plain
//     version's order, and merges the chunk into each row's running
//     top-k: one warp per row, the list held one entry per lane, the 128
//     candidates read a warp-row at a time; a ballot keeps those above the
//     row's k-th value (almost none once the list fills) and each is
//     inserted by a shuffle. The chunk's docs come in ascending id order,
//     so an equal value already listed always has the lower id, and a tie
//     at the k-th value never enters. The block writes its lists as
//     partials [n_parts, B, k], 8 B a slot.
//  2. topk_merge_kernel: one warp per row streams its n_parts lists in part
//     order (ascending doc ranges) through the same insertion.
// chunks is chosen by the wrapper so that the grid is about two waves of
// resident blocks: more chunks per block mean fewer partials (4 MB at
// B=256, 100k docs), fewer make more blocks. Row tiles are 32 rows
// (fused_topk.py ROWS): two [32, 128] f32 sum arrays, the table and the
// lists take ~41 KB, 5 blocks per SM. On an H100 at B=256 and 100k docs
// a call takes 0.55 ms, 2.3% of its bound on the benchmark corpus, against
// 3.3-3.7 ms for the production keyword scorer's K1 + finalize + top-k on
// the probe's synthetic corpus (PERF.md): each
// chunk is swept once per row tile (8 times at B=256, from L2 after the
// first), which is where a faster version would start.
#include <math.h>

#include "probe.cuh"

namespace ss {

constexpr int kKMax = 32;  // a list is held one entry per lane

__device__ inline float normalize(float s, float mag, float qmag) {
  const float n = __fdiv_rn(s, __fmul_rn(mag, qmag));
  return isnan(n) ? 0.f : n;
}

// Insert (x, xi) into the warp's sorted list (lane l < K holds entry l,
// value descending). Every listed entry equal to x has a lower id, so x
// goes after them. Warp-uniform arguments; entries pushed past K drop.
__device__ __forceinline__ void list_insert(float& lv, int& li, float x,
                                            int xi, int K, int lane) {
  const int pos = __popc(__ballot_sync(probe::kFull, lane < K && lv >= x));
  if (pos >= K) return;
  const float uv = __shfl_up_sync(probe::kFull, lv, 1);
  const int ui = __shfl_up_sync(probe::kFull, li, 1);
  if (lane == pos) {
    lv = x;
    li = xi;
  } else if (lane > pos && lane < K) {
    lv = uv;
    li = ui;
  }
}

// Offer this lane's candidate (v, id) of a warp-wide batch to the list, in
// lane order; thresh is the list's k-th value (-inf until it fills).
__device__ __forceinline__ void offer(float& lv, int& li, float& thresh,
                                      float v, int id, int K, int lane) {
  unsigned m = __ballot_sync(probe::kFull, v > thresh);
  while (m != 0u) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float x = __shfl_sync(probe::kFull, v, src);
    const int xi = __shfl_sync(probe::kFull, id, src);
    if (!(x > thresh)) continue;  // the list rose past it meanwhile
    list_insert(lv, li, x, xi, K, lane);
    thresh = __shfl_sync(probe::kFull, lv, K - 1);
  }
}

__global__ void __launch_bounds__(probe::kDocs)
fused_topk_kernel(const int* __restrict__ title_ftT,
                  const float* __restrict__ title_fwT, int Tt,
                  const int* __restrict__ body_ftT,
                  const float* __restrict__ body_fwT, int Tb, int D,
                  const float* __restrict__ mag_t,
                  const float* __restrict__ mag_b,
                  const int* __restrict__ tbl_term,
                  const int* __restrict__ tbl_pay, int N, int R, int B,
                  const float* __restrict__ qlen, float w_title,
                  float w_body, float scale, int K, int chunks,
                  float* __restrict__ part_v, int* __restrict__ part_i) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, R, 2, N);
  float* acc_t = sm.acc;  // this thread's column; the finals after a chunk
  float* acc_b = sm.acc + R * kDocs;
  const float* finals = sm.acc - threadIdx.x;  // [R, kDocs], row-major
  float* s_qmag = reinterpret_cast<float*>(sm.extra);  // [R]
  float* s_lv = s_qmag + R;                            // [R, K]
  int* s_li = reinterpret_cast<int*>(s_lv + R * K);    // [R, K]

  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int rows = min(R, B - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // read after stage_table's barriers
  for (int i = threadIdx.x; i < rows; i += blockDim.x)
    s_qmag[i] = __fsqrt_rn(__ldg(qlen + r0 + i));
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) {
    s_lv[i] = -INFINITY;
    s_li[i] = 0;
  }
  const size_t off = (size_t)tile * N;
  const int n = stage_table(sm.term, sm.pay, sm.filter, tbl_term + off,
                            tbl_pay + off, N);

  const int first = blockIdx.y * chunks * kDocs;
  for (int c = 0; c < chunks; ++c) {
    const int base = first + c * kDocs;
    if (base >= D) break;  // block-uniform
    const int d = base + threadIdx.x;
    const bool live = d < D;
    zero_rows(acc_t, R);
    zero_rows(acc_b, R);
    unsigned long long hit = 0ull;
    sweep<false, false, true, true, float>(title_ftT, title_fwT, Tt, D, d,
                                          live, sm.term, sm.pay, sm.filter, n,
                                          acc_t, nullptr, nullptr, &hit);
    sweep<false, false, true, true, float>(body_ftT, body_fwT, Tb, D, d, live,
                                          sm.term, sm.pay, sm.filter, n,
                                          acc_b, nullptr, nullptr, &hit);
    const float mt = live ? __ldg(mag_t + d) : 0.f;
    const float mb = live ? __ldg(mag_b + d) : 0.f;
    for (int r = 0; r < rows; ++r) {
      float v = -INFINITY;
      if (live && ((hit >> r) & 1ull)) {
        const float qm = s_qmag[r];
        const float tn = normalize(acc_t[r * kDocs], mt, qm);
        const float bn = normalize(acc_b[r * kDocs], mb, qm);
        v = __fmul_rn(__fadd_rn(__fmul_rn(w_title, tn), __fmul_rn(w_body, bn)),
                      scale);
      }
      acc_t[r * kDocs] = v;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kDocs / 32) {
      float lv = lane < K ? s_lv[r * K + lane] : -INFINITY;
      int li = lane < K ? s_li[r * K + lane] : 0;
      float thresh = __shfl_sync(kFull, lv, K - 1);
      for (int j = 0; j < kDocs; j += 32)
        offer(lv, li, thresh, finals[r * kDocs + j + lane], base + j + lane, K,
              lane);
      if (lane < K) {
        s_lv[r * K + lane] = lv;
        s_li[r * K + lane] = li;
      }
    }
    __syncthreads();  // the sums are zeroed for the next chunk
  }
  for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
    const size_t at = ((size_t)blockIdx.y * B + r0) * K + i;
    part_v[at] = s_lv[i];
    part_i[at] = s_li[i];
  }
}

// One warp per row: merge the row's n_parts lists (partials [n_parts, B,
// K]) in part order, 32 slots a step.
__global__ void __launch_bounds__(128)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, int n_parts, int B, int K,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;  // a whole warp
  float lv = -INFINITY;
  int li = 0;
  float thresh = -INFINITY;
  const int total = n_parts * K;
  for (int c0 = 0; c0 < total; c0 += 32) {
    const int c = c0 + lane;
    float v = -INFINITY;
    int id = 0;
    if (c < total) {
      const size_t at = ((size_t)(c / K) * B + b) * K + c % K;
      v = __ldg(part_v + at);
      id = __ldg(part_i + at);
    }
    offer(lv, li, thresh, v, id, K, lane);
  }
  if (lane < K) {
    out_v[(size_t)b * K + lane] = lv;
    out_i[(size_t)b * K + lane] = li;
  }
}

}  // namespace ss

// K5: build the batch's shared table (all Q columns, as K4) into `tables`
// (probe.cuh Tables layout, one section), sweep and select per block into
// the partials, then merge into out_v / out_i [B, K].
extern "C" int ss_fused_topk(const int* title_ftT, const float* title_fwT,
                             int Tt, const int* body_ftT,
                             const float* body_fwT, int Tb, int D,
                             const float* mag_t, const float* mag_b,
                             const int* tq, int B, int Q, const float* qlen,
                             float w_title, float w_body, float scale, int K,
                             int chunks, int* tables, int R, int N,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, void* stream) {
  using ss::probe::kDocs;
  if (K < 1 || K > ss::kKMax || Q < 1 || Q > ss::probe::kQMax || R < 1 ||
      R > ss::probe::kRowsMax || chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 1);
  tb.req = nullptr;
  int err = ss::probe::launch_build(tq, B, Q, nullptr, nullptr, nullptr,
                                    nullptr, 0, R, N, 1, tb, st);
  if (err != 0) return err;
  // two sum arrays, the filter and the table, then R qmags and R lists
  const size_t smem =
      ss::probe::smem_bytes(R, 2, N, (size_t)R * 4 + (size_t)R * K * 8);
  cudaError_t e = cudaFuncSetAttribute(
      ss::fused_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (D + kDocs - 1) / kDocs;
  const int n_parts = (n_chunks + chunks - 1) / chunks;
  ss::fused_topk_kernel<<<dim3(n_tiles, n_parts), kDocs, smem, st>>>(
      title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, mag_t, mag_b,
      tb.term, tb.pay, N, R, B, qlen, w_title, w_body, scale, K, chunks, part_v,
      part_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ss::topk_merge_kernel<<<(B + 3) / 4, 128, 0, st>>>(part_v, part_i, n_parts,
                                                      B, K, out_v, out_i);
  return (int)cudaGetLastError();
}
