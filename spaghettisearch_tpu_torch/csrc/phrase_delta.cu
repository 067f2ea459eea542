// K6: the phrase rows' additive contributions alone (the phrase delta).
//
// Replaces the TPU kernel experiments/phrase_delta_probe.py
// pallas_phrase_delta (_kernel_phrase_delta over
// spaghettisearch_tpu/ops/kernels/mixed.py _phrase_block). For query row b
// and doc d, per section s:
//     add_s[b, d] = the sum of the row's phrase-term weights in section s
//                   where every valid phrase term occurs in s and the
//                   positional chain holds (csrc/phrase.cuh), else 0
//     flag[b, d]  = 1 where either section matched, else 0 (emit_flag)
// That is exactly what K2 folds into its keyword sums, with no keyword
// work: K1's scores plus add_t / add_b over the phrase rows are K2's.
//
// What bounds it on the H100: bytes. It must read the term id of each real
// slot of both sections (~32 MB at 100k docs), a weight and C positions
// only where a slot holds a row's phrase term, and write its two or three
// [B, D] f32 outputs once (13 MB at B=16, 103-154 MB at B=128); there is
// no arithmetic worth counting.
//
// Design: K2's probe sweep and phrase stage (probe.cuh, phrase.cuh) over a
// table that holds the phrase entries only (the build gets one all-pad
// keyword column, so no keyword entry enters); a block stages its tile's
// table once and sweeps the title, then the body, against it. A slot passes
// the filter only where it holds some row's phrase term, so the sweep costs
// one id load and one shared-memory probe per real slot, and the chain
// check runs only at docs that log a hit. The first port took
// 0.099 ms of device time on 16 phrase rows (12% of its bound) at 118
// registers and 4 blocks per SM: its tiles were the batch's first 64 rows,
// phrase rows or not; its chain check was compiled for 32 position planes
// (64 floats of registers and 1,024 compares per required term, where the
// benchmark index holds 3 and 7 planes); and its flag was a second [R, 128]
// f32 array in shared memory (2 blocks per SM with it). Here:
//   - phrase_rows_kernel partitions the batch (phrase rows first, each part
//     in batch order) and the table build reads the phrase rows' slots in
//     that order, so tiles hold phrase rows only (R = 16 rows for a batch
//     of at most 16, else 32); blocks past the phrase tiles store the
//     other rows' zeros and sweep nothing (a store-only path);
//   - the chain check is instantiated for a bucket of plane counts (4, 8,
//     16, 32: phrase_delta.py plane_bucket picks the one max(Ct, Cb) falls
//     in), so its registers and compares follow the index's C (48
//     registers at 8 planes);
//   - the flag is a 64-bit mask in a register per thread (a match in either
//     section sets the row's bit), stored once at the end;
//   - a thread logs up to 32 phrase hits per section (K2 keeps 16): fewer
//     docs of the benchmark mix's phrase rows overflow into the rescan.
// Shared memory per block of 32 rows at P=16: 16 KB of sums, the 4 KB
// filter, the table (8 B an entry: 4.4 KB), the 16 KB log and R required-
// position masks and row indices: 5 blocks per SM (7 at 16 rows).
// Measured (experiments/torch_kernel_ab.py, an NVIDIA H100 80GB HBM3 at
// 700 W, the 100k benchmark corpus; PERF.md section 6): 0.1094-0.1095 ms per
// call on 16 phrase rows (first design 0.1120-0.1122 ms in the same runs),
// 0.1385-0.1394 ms at bp=128 (0.1583-0.1599) and 0.1534-0.1609 ms there
// with the flag (0.2229-0.2250). What holds it now is the sweep itself:
// without the phrase stage the kernel took 0.080 of its 0.093 ms.
#include "phrase.cuh"

namespace ss {
namespace delta {

constexpr int kRowsMax = 64;  // a tile's rows fit the 64-bit match mask
constexpr int kLogCap = 32;  // phrase hits a thread logs per section
// Words of the per-thread log region: the log, or a rescan's slots.
constexpr int kLogRegion = kLogCap > kPMax / 2 ? kLogCap : kPMax / 2;

// Dynamic shared memory of the sweep kernel, in bytes.
__host__ __device__ inline size_t smem_bytes(int R, int N) {
  return probe::smem_bytes(R, 1, N,
                           (size_t)kLogRegion * probe::kDocs * 4 + (size_t)R * 8);
}

// Partition the batch: positions [0, n_ph) hold the rows whose phrase slot
// 0 is valid, in batch order, then the other rows in batch order.
// row_map[pos] = row; ids_c / valid_c are ph_ids / ph_valid in that order,
// the other rows' slots invalid; pad_col (when given) gets the table
// build's all-pad [B, 1] keyword column. One block.
__global__ void __launch_bounds__(1024)
phrase_rows_kernel(const int* __restrict__ ph_ids,
                   const float* __restrict__ ph_valid, int B, int P,
                   int* __restrict__ row_map, int* __restrict__ ids_c,
                   float* __restrict__ valid_c, int* __restrict__ n_ph,
                   int* __restrict__ pad_col) {
  __shared__ int warp_n[32];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (threadIdx.x == 0) total = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < B; r += blockDim.x)
    if (ph_valid[(size_t)r * P] > 0.f) atomicAdd(&total, 1);
  __syncthreads();
  const int n = total;
  int carry = 0;  // phrase rows before this chunk
  for (int base = 0; base < B; base += blockDim.x) {
    const int r = base + threadIdx.x;
    const bool ph = r < B && ph_valid[(size_t)r * P] > 0.f;
    const unsigned m = __ballot_sync(probe::kFull, ph);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int before = carry + __popc(m & ((1u << lane) - 1u));
    int chunk = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w < warp) before += warp_n[w];
      chunk += warp_n[w];
    }
    if (r < B) {
      const int pos = ph ? before : n + r - before;
      row_map[pos] = r;
      if (pad_col != nullptr) pad_col[r] = probe::kTermPad;
      for (int p = 0; p < P; ++p) {
        ids_c[(size_t)pos * P + p] = ph_ids[(size_t)r * P + p];
        valid_c[(size_t)pos * P + p] = ph ? ph_valid[(size_t)r * P + p] : 0.f;
      }
    }
    carry += chunk;
    __syncthreads();  // warp_n is reused
  }
  if (threadIdx.x == 0) *n_ph = n;
}

template <int kC>
__global__ void __launch_bounds__(probe::kDocs)
phrase_delta_kernel(const int* __restrict__ title_ftT,
                    const float* __restrict__ title_fwT, int Tt,
                    const int* __restrict__ body_ftT,
                    const float* __restrict__ body_fwT, int Tb, int D,
                    const void* title_posT, int Ct, int tpos16,
                    const void* body_posT, int Cb, int bpos16,
                    const int* __restrict__ tbl_term,
                    const int* __restrict__ tbl_pay, int N, int R, int B,
                    const int* __restrict__ ph_req,
                    const int* __restrict__ row_map,
                    const int* __restrict__ n_ph_at, float* __restrict__ add_t,
                    float* __restrict__ add_b, float* __restrict__ flag) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem) + threadIdx.x;
  uint32_t* s_filter = reinterpret_cast<uint32_t*>(smem + (size_t)R * kDocs * 4);
  int* s_term = reinterpret_cast<int*>(s_filter + kFilterWords);
  int* s_pay = s_term + N;
  uint32_t* s_log = reinterpret_cast<uint32_t*>(s_pay + N);
  int* s_req = reinterpret_cast<int*>(s_log + (size_t)kLogRegion * kDocs);
  int* s_row = s_req + R;

  const int n_ph = __ldg(n_ph_at);
  const int ph_tiles = (n_ph + R - 1) / R;
  const int d = blockIdx.y * kDocs + threadIdx.x;
  const bool live = d < D;
  if ((int)blockIdx.x >= ph_tiles) {  // the other rows: zeros, no sweep
    const int p0 = n_ph + ((int)blockIdx.x - ph_tiles) * R;
    if (!live) return;
    for (int p = p0; p < min(p0 + R, B); ++p) {
      const size_t at = (size_t)__ldg(row_map + p) * D + d;
      add_t[at] = 0.f;
      add_b[at] = 0.f;
      if (flag != nullptr) flag[at] = 0.f;
    }
    return;
  }
  const int p0 = blockIdx.x * R;
  const int rows = min(R, n_ph - p0);
  for (int i = threadIdx.x; i < R; i += blockDim.x) {  // seen after the
    s_req[i] = i < rows ? __ldg(ph_req + p0 + i) : 0;  // next barrier
    s_row[i] = i < rows ? __ldg(row_map + p0 + i) : 0;
  }
  const size_t off = (size_t)blockIdx.x * N;
  const int n = stage_table(s_term, s_pay, s_filter, tbl_term + off,
                            tbl_pay + off, N);
  const Section secs[2] = {
      {title_ftT, title_fwT, title_posT, tpos16 != 0, Tt, Ct, Tt},
      {body_ftT, body_fwT, body_posT, bpos16 != 0, Tb, Cb, Tb},
  };
  float* outs[2] = {add_t, add_b};
  unsigned long long matched = 0ull;  // rows that matched in either section
  auto mark = [&](int k) { matched |= 1ull << k; };
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const Section& sec = secs[s];
    zero_rows(acc_s, R);
    PhraseLog plog{s_log + threadIdx.x, kLogCap, 0, false};
    sweep<false, true>(sec.ftT, sec.fwT, sec.bound, D, d, live, s_term, s_pay,
                       s_filter, n, acc_s, (float*)nullptr, &plog);
    if (live) {
      phrase_matches<kC>(sec, D, d, R, s_term, s_pay, s_filter, n, s_req, plog,
                         acc_s, mark);
      for (int r = 0; r < rows; ++r)
        outs[s][(size_t)s_row[r] * D + d] = acc_s[r * kDocs];
    }
  }
  if (live && flag != nullptr)
    for (int r = 0; r < rows; ++r)
      flag[(size_t)s_row[r] * D + d] = (matched >> r) & 1ull ? 1.f : 0.f;
}

}  // namespace delta
}  // namespace ss

// The batch's partition alone (phrase_rows_kernel into `rows`, laid out as
// ss_phrase_delta's), to hold against phrase_delta.py plain_phrase_rows.
extern "C" int ss_phrase_rows(const int* ph_ids, const float* ph_valid, int B,
                              int P, int* rows, void* stream) {
  if (B < 1 || P < 1) return (int)cudaErrorInvalidValue;
  int* ids_c = rows + B;
  float* valid_c = reinterpret_cast<float*>(ids_c + (size_t)B * P);
  ss::delta::phrase_rows_kernel<<<1, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      ph_ids, ph_valid, B, P, rows, ids_c, valid_c,
      reinterpret_cast<int*>(valid_c + (size_t)B * P), nullptr);
  return (int)cudaGetLastError();
}

// K6: partition the batch (phrase rows first) into `rows` (row_map [B], the
// partitioned ph_ids [B, P] and ph_valid [B, P], n_ph, then an all-pad
// [B, 1] keyword column for the table build: B * (2 + 2P) + 1 int32),
// build the phrase rows' tables (one per R-row tile) into `tables`
// (probe.cuh Tables layout, one section), then sweep the phrase tiles and
// zero the other rows, with the chain check compiled for `bucket` planes
// (4, 8, 16 or 32, at least Ct and Cb). flag may be null (emit_flag off).
extern "C" int ss_phrase_delta(const int* title_ftT, const float* title_fwT,
                               int Tt, const int* body_ftT,
                               const float* body_fwT, int Tb, int D,
                               const void* title_posT, int Ct, int tpos16,
                               const void* body_posT, int Cb, int bpos16,
                               int bucket, int B, const int* ph_ids,
                               const float* ph_valid, int P, int* rows,
                               int* tables, int R, int N,
                               float* add_t, float* add_b, float* flag,
                               void* stream) {
  using ss::probe::kDocs;
  if (P < 1 || P > ss::kPMax || Ct < 1 || Cb < 1 || Ct > bucket ||
      Cb > bucket || R < 1 || R > ss::delta::kRowsMax || B < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* row_map = rows;
  int* ids_c = rows + B;
  float* valid_c = reinterpret_cast<float*>(ids_c + (size_t)B * P);
  int* n_ph = reinterpret_cast<int*>(valid_c + (size_t)B * P);
  int* tq_pad = n_ph + 1;
  ss::delta::phrase_rows_kernel<<<1, 1024, 0, st>>>(
      ph_ids, ph_valid, B, P, row_map, ids_c, valid_c, n_ph, tq_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = (B + R - 1) / R;
  const ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 1);
  int err = ss::probe::launch_build(tq_pad, B, 1, nullptr, nullptr, ids_c,
                                    valid_c, P, R, N, 1, tb, st);
  if (err != 0) return err;
  const size_t smem = ss::delta::smem_bytes(R, N);
  // the phrase tiles, then the zero tiles: at most n_tiles + 1 in all
  const dim3 grid(n_tiles + 1, (D + kDocs - 1) / kDocs);
  auto launch = [&](auto kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kDocs, smem, st>>>(
        title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, title_posT, Ct,
        tpos16, body_posT, Cb, bpos16, tb.term, tb.pay, N, R, B, tb.req,
        row_map, n_ph, add_t, add_b, flag);
    return (int)cudaGetLastError();
  };
  switch (bucket) {
    case 4: return launch(ss::delta::phrase_delta_kernel<4>);
    case 8: return launch(ss::delta::phrase_delta_kernel<8>);
    case 16: return launch(ss::delta::phrase_delta_kernel<16>);
    case 32: return launch(ss::delta::phrase_delta_kernel<32>);
    default: return (int)cudaErrorInvalidValue;
  }
}
