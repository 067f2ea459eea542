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
// slot of both sections (~34 MB on the 100k benchmark corpus), a weight
// only where a row asks for the slot's term, mag_t and mag_b once (0.8 MB),
// and write [B, k] values and ids: ~13 us at 3.35 TB/s. The unfused path
// writes (and its top-k reads back) a [B, D] f32 matrix: 103 MB at B=256.
//
// Design. The TPU kernel carries each row's top-k across a sequential grid
// in VMEM; blocks of a CUDA grid run in no order, so the top-k is two
// passes here: fused_topk_kernel (below) keeps a list per row in each block
// and writes them as partials [n_parts, B, k], and topk_merge_kernel merges
// each row's partials with four warps (a quarter of the parts each, then
// one warp merges their four lists). Every list orders its entries by
// (value descending, doc id ascending), in the insertion and in the merge,
// so no tie rule rests on the order in which candidates arrive. A row's
// sums add its slots in slot order, so the values are bit-identical to the
// first port's.
//
// What was measured (experiments/torch_kernel_ab.py, an NVIDIA H100 80GB
// HBM3 at 700 W, B=256 on the 100k benchmark corpus; PERF.md section 6): the
// first design spent 0.48 of its 0.54 ms in the sweep kernel and 0.05 ms
// in a one-warp-per-row merge. Its selection offered every candidate of the
// first chunks a block saw to lists that had yet to fill; sharing each
// row's running k-th value as a threshold across blocks (below) cuts
// that, and the four-warp merge halves the merge. A design that swept each
// chunk once for the whole batch (the table of all 256 rows, the slots
// whose terms it holds listed per thread, then the 32-row tiles done from
// shared memory) took 1.0-1.3 ms: its 112 KB of shared memory held it at
// 2 blocks per SM, a doc's list overflowed into rescans, and the tile
// phase's walks ran at that occupancy; so did 64-row tiles (4 sweeps at 2
// blocks per SM: 0.94 ms), and a pilot kernel that set the thresholds
// from a sample of chunks cost more (0.10 ms) than it saved. What holds the
// kernel now is its eight sweeps of each chunk (one per 32-row tile, each
// ~0.05 ms at 5 blocks per SM, the first from device memory and the
// others mostly from L2) and the finalize of every (row, doc) hit. A
// B=256 call takes 0.4872 ms there (0.5441-0.5505 ms for the first
// design in the same runs): the sweep kernel 0.439 ms, the merge 0.032 ms.
#include <math.h>

#include "probe.cuh"

namespace ss {
namespace topk {

constexpr int kDocs = probe::kDocs;  // threads per block, one doc each
constexpr int kKMax = 32;            // a list is held one entry per lane
constexpr int kInFlight = 16;        // slot ids a thread has in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ inline float normalize(float s, float mag, float qmag) {
  const float n = __fdiv_rn(s, __fmul_rn(mag, qmag));
  return isnan(n) ? 0.f : n;
}

// (x, xi) ranks before (y, yi): value descending, then doc id ascending.
__device__ __forceinline__ bool before(float x, int xi, float y, int yi) {
  return x > y || (x == y && xi < yi);
}

// Insert (x, xi) into the warp's sorted list (lane l < K holds entry l).
// Warp-uniform arguments; the entry pushed past K drops.
__device__ __forceinline__ void list_insert(float& lv, int& li, float x,
                                            int xi, int K, int lane) {
  const int pos =
      __popc(__ballot_sync(kFull, lane < K && before(lv, li, x, xi)));
  if (pos >= K) return;
  const float uv = __shfl_up_sync(kFull, lv, 1);
  const int ui = __shfl_up_sync(kFull, li, 1);
  if (lane == pos) {
    lv = x;
    li = xi;
  } else if (lane > pos && lane < K) {
    lv = uv;
    li = ui;
  }
}

// Offer this lane's candidate (v, id) of a warp-wide batch to the list;
// (tv, ti) is the list's k-th entry ((-inf, 0) until it fills).
__device__ __forceinline__ void offer(float& lv, int& li, float& tv, int& ti,
                                      float v, int id, int K, int lane) {
  unsigned m = __ballot_sync(kFull, before(v, id, tv, ti));
  while (m != 0u) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float x = __shfl_sync(kFull, v, src);
    const int xi = __shfl_sync(kFull, id, src);
    if (!before(x, xi, tv, ti)) continue;  // the list rose past it meanwhile
    list_insert(lv, li, x, xi, K, lane);
    tv = __shfl_sync(kFull, lv, K - 1);
    ti = __shfl_sync(kFull, li, K - 1);
  }
}

// A row's threshold as the global array holds it: the final's bits, which
// order like the value (every final is >= +0); negative: none yet.
__device__ __forceinline__ float thr_value(int x) {
  return x < 0 ? -INFINITY : __int_as_float(x);
}

// One row tile (R rows, one probe table, all Q columns, as K4) over
// `chunks` 128-doc chunks: per chunk, both sections are swept into two
// shared-memory sum arrays (one column per thread, hits compacted per warp,
// 16 slot ids in flight per thread, a 64-bit hit mask for candidacy, as
// K4), each hit row is finalized with the round-to-nearest intrinsics in the
// plain version's order, and kept if it is at or above the row's threshold
// and ranks above the k-th entry of the block's list for the row (value
// descending, doc id ascending); one warp per row merges the kept docs into
// the row's list (a ballot against the k-th entry, then one insertion per
// survivor), and only rows where some doc was kept are visited. A full
// list's k-th value is published to the row's threshold `thr` (atomicMax):
// that block holds k docs at or above it, so no doc below it can rank among
// the row's k. Every block reads the thresholds at each chunk.
__global__ void __launch_bounds__(kDocs)
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
                  int* __restrict__ thr, float* __restrict__ part_v,
                  int* __restrict__ part_i) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem sm = smem_layout(smem, R, 2, N);
  float* acc_t = sm.acc;  // this thread's column; the finals after a chunk
  float* acc_b = sm.acc + R * kDocs;
  const float* finals = sm.acc - threadIdx.x;  // [R, kDocs], row-major
  float* s_qmag = reinterpret_cast<float*>(sm.extra);  // [R]
  float* s_thr = s_qmag + R;                           // [R]
  float* s_lv = s_thr + R;                             // [R, K]
  int* s_li = reinterpret_cast<int*>(s_lv + R * K);    // [R, K]
  uint64_t* s_cand = reinterpret_cast<uint64_t*>(s_li + R * K);  // [kDocs]
  uint64_t* s_rows = s_cand + kDocs;  // rows with a kept doc in this chunk

  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int rows = min(R, B - r0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // read after stage_table's barriers
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s_qmag[i] = __fsqrt_rn(__ldg(qlen + r0 + i));
    s_thr[i] = -INFINITY;
  }
  for (int i = threadIdx.x; i < R * K; i += blockDim.x) {
    s_lv[i] = -INFINITY;
    s_li[i] = 0;
  }
  if (threadIdx.x == 0) *s_rows = 0ull;
  const size_t off = (size_t)tile * N;
  const int n = stage_table(sm.term, sm.pay, sm.filter, tbl_term + off,
                            tbl_pay + off, N);

  const int first = blockIdx.y * chunks;
  for (int c = 0; c < chunks; ++c) {
    const int base = (first + c) * kDocs;
    if (base >= D) break;  // block-uniform
    const int d = base + threadIdx.x;
    const bool live = d < D;
    zero_rows(acc_t, R);
    zero_rows(acc_b, R);
    // the other blocks' thresholds (through L2)
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
      s_thr[i] = fmaxf(s_thr[i], thr_value(__ldcg(thr + r0 + i)));
    unsigned long long hit = 0ull;
    sweep<false, false, true, true, float, kInFlight>(
        title_ftT, title_fwT, Tt, D, d, live, sm.term, sm.pay, sm.filter, n,
        acc_t, nullptr, nullptr, &hit);
    sweep<false, false, true, true, float, kInFlight>(
        body_ftT, body_fwT, Tb, D, d, live, sm.term, sm.pay, sm.filter, n,
        acc_b, nullptr, nullptr, &hit);
    const float mt = live ? __ldg(mag_t + d) : 0.f;
    const float mb = live ? __ldg(mag_b + d) : 0.f;
    __syncthreads();  // s_thr
    uint64_t keep = 0ull;
    for (int r = 0; r < rows; ++r) {
      if (live && ((hit >> r) & 1ull)) {
        const float qm = s_qmag[r];
        const float tn = normalize(acc_t[r * kDocs], mt, qm);
        const float bn = normalize(acc_b[r * kDocs], mb, qm);
        const float v = __fmul_rn(
            __fadd_rn(__fmul_rn(w_title, tn), __fmul_rn(w_body, bn)), scale);
        if (v >= s_thr[r] &&
            before(v, d, s_lv[r * K + K - 1], s_li[r * K + K - 1])) {
          acc_t[r * kDocs] = v;
          keep |= 1ull << r;
        }
      }
    }
    s_cand[threadIdx.x] = keep;
    const unsigned lo = __reduce_or_sync(kFull, (unsigned)keep);
    const unsigned hi = __reduce_or_sync(kFull, (unsigned)(keep >> 32));
    if (lane == 0 && (lo | hi) != 0u)
      atomicOr(reinterpret_cast<unsigned long long*>(s_rows),
               (unsigned long long)hi << 32 | lo);
    __syncthreads();
    const uint64_t any = *s_rows;
    for (int r = warp; r < rows; r += kDocs / 32) {
      if (!((any >> r) & 1ull)) continue;  // warp-uniform
      float lv = lane < K ? s_lv[r * K + lane] : -INFINITY;
      int li = lane < K ? s_li[r * K + lane] : 0;
      float tv = __shfl_sync(kFull, lv, K - 1);
      int ti = __shfl_sync(kFull, li, K - 1);
      for (int j = 0; j < kDocs; j += 32) {
        const bool kept = (s_cand[j + lane] >> r) & 1ull;
        offer(lv, li, tv, ti, kept ? finals[r * kDocs + j + lane] : -INFINITY,
              base + j + lane, K, lane);
      }
      if (lane < K) {
        s_lv[r * K + lane] = lv;
        s_li[r * K + lane] = li;
      }
      // a full list's k-th value bounds the row's k-th final from below
      if (lane == 0 && tv > s_thr[r]) {
        s_thr[r] = tv;
        atomicMax(thr + r0 + r, __float_as_int(tv));
      }
    }
    __syncthreads();  // the sums, s_cand and s_rows are reset next chunk
    if (threadIdx.x == 0) *s_rows = 0ull;
  }
  for (int i = threadIdx.x; i < rows * K; i += blockDim.x) {
    const size_t at = ((size_t)blockIdx.y * B + r0) * K + i;
    part_v[at] = s_lv[i];
    part_i[at] = s_li[i];
  }
}

// One block of four warps per row: each warp merges a quarter of the row's
// n_parts lists (partials [n_parts, B, K]), then warp 0 merges the four.
__global__ void __launch_bounds__(128)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, int n_parts, int B, int K,
                  float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float s_v[4][kKMax];
  __shared__ int s_i[4][kKMax];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x;
  float lv = -INFINITY, tv = -INFINITY;
  int li = 0, ti = 0;
  const int total = n_parts * K;
  for (int c0 = warp * 32; c0 < total; c0 += 128) {
    const int c = c0 + lane;
    float v = -INFINITY;
    int id = 0;
    if (c < total) {
      const size_t at = ((size_t)(c / K) * B + b) * K + c % K;
      v = __ldg(part_v + at);
      id = __ldg(part_i + at);
    }
    offer(lv, li, tv, ti, v, id, K, lane);
  }
  if (lane < K) {
    s_v[warp][lane] = lv;
    s_i[warp][lane] = li;
  }
  __syncthreads();
  if (warp != 0) return;
  for (int w = 1; w < 4; ++w)
    offer(lv, li, tv, ti, lane < K ? s_v[w][lane] : -INFINITY,
          lane < K ? s_i[w][lane] : 0, K, lane);
  if (lane < K) {
    out_v[(size_t)b * K + lane] = lv;
    out_i[(size_t)b * K + lane] = li;
  }
}

}  // namespace topk
}  // namespace ss

// Dynamic shared memory of the sweep kernel: two sum arrays, the filter and
// the table, then R query magnitudes, R thresholds, R lists of K entries,
// the docs' kept-row masks and one mask of rows.
static size_t topk_smem(int R, int N, int K) {
  return ss::probe::smem_bytes(R, 2, N, (size_t)R * 8 + (size_t)R * K * 8 +
                                            (size_t)ss::probe::kDocs * 8 + 8);
}

// K5: build the batch's shared table per row tile (all Q columns, as K4)
// into `tables` (probe.cuh Tables layout, one section), clear the rows'
// thresholds `thr` [B], sweep and select per block into the partials
// [n_parts, B, K] (a block: one row tile, `chunks` chunks), then merge into
// out_v / out_i [B, K].
extern "C" int ss_fused_topk(const int* title_ftT, const float* title_fwT,
                             int Tt, const int* body_ftT,
                             const float* body_fwT, int Tb, int D,
                             const float* mag_t, const float* mag_b,
                             const int* tq, int B, int Q, const float* qlen,
                             float w_title, float w_body, float scale, int K,
                             int chunks, int* tables, int R, int N, int* thr,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, void* stream) {
  using ss::probe::kDocs;
  namespace tk = ss::topk;
  if (K < 1 || K > tk::kKMax || Q < 1 || Q > ss::probe::kQMax || R < 1 ||
      R > ss::probe::kRowsMax || chunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 1);
  tb.req = nullptr;
  int err = ss::probe::launch_build(tq, B, Q, nullptr, nullptr, nullptr,
                                    nullptr, 0, R, N, 1, tb, st);
  if (err != 0) return err;
  cudaError_t e = cudaMemsetAsync(thr, 0xff, (size_t)B * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = topk_smem(R, N, K);
  e = cudaFuncSetAttribute(tk::fused_topk_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (D + kDocs - 1) / kDocs;
  const int n_parts = (n_chunks + chunks - 1) / chunks;
  tk::fused_topk_kernel<<<dim3(n_tiles, n_parts), kDocs, smem, st>>>(
      title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, mag_t, mag_b,
      tb.term, tb.pay, N, R, B, qlen, w_title, w_body, scale, K, chunks, thr,
      part_v, part_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tk::topk_merge_kernel<<<B, 128, 0, st>>>(part_v, part_i, n_parts, B, K,
                                           out_v, out_i);
  return (int)cudaGetLastError();
}
