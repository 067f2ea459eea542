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
// table that holds the phrase entries only. The build gets one all-pad
// keyword column, so no keyword entry enters; the phrase entries are the
// same for both sections, so a row tile builds one table (as K4 does) and
// a block stages it once and sweeps the title, then the body, against it.
// A slot passes the filter only where it holds some row's phrase term, so
// the sweep costs one id load and one shared-memory probe per real slot,
// and the phrase stage runs only at docs that log a hit. A row tile whose
// table holds no entry (every row without a phrase: pn == 0) skips both
// sweeps and stores zeros, the counterpart of the TPU kernel's zero-trip
// blocks, so a full-width batch with its phrase rows first pays the sweep
// once per tile that holds one. The flag rides K2's count path: the title
// flag is a second shared-memory row array, and a body match adds 1 to the
// flag the same thread stored unless the title matched. Shared memory per
// block of 64 rows: 32 KB of sums (64 KB with the flag), the 4 KB filter,
// the table (8 B an entry: 8.5 KB at P=16), the 8 KB log, 1.25 KB of
// flags and R required-position masks. On an H100 at 100k docs it takes
// 0.117 ms on 16 phrase rows and 0.161 ms on a B=128 batch whose second
// tile skips, 12% of its bound (PERF.md); K1 + K6 cost about what
// K2 does, so the split mixed program does not pay here.
#include "phrase.cuh"

namespace ss {

template <bool kFlag>
__global__ void __launch_bounds__(probe::kDocs)
phrase_delta_kernel(const int* __restrict__ title_ftT,
                    const float* __restrict__ title_fwT, int Tt,
                    const int* __restrict__ body_ftT,
                    const float* __restrict__ body_fwT, int Tb, int D,
                    const void* title_posT, int Ct, int tpos16,
                    const void* body_posT, int Cb, int bpos16,
                    const int* __restrict__ tbl_term,
                    const int* __restrict__ tbl_pay, int N, int R, int B,
                    const int* __restrict__ ph_req, float* __restrict__ add_t,
                    float* __restrict__ add_b, float* __restrict__ flag) {
  using namespace probe;
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem) + threadIdx.x;
  float* acc_c = acc_s + R * kDocs;  // the title flag (kFlag)
  uint32_t* s_filter =
      reinterpret_cast<uint32_t*>(smem + (size_t)R * kDocs * 4 * (kFlag ? 2 : 1));
  int* s_term = reinterpret_cast<int*>(s_filter + kFilterWords);
  int* s_pay = s_term + N;
  uint32_t* s_log = reinterpret_cast<uint32_t*>(s_pay + N);
  uint32_t* s_ok = s_log + (size_t)kLogWords * kDocs;
  int* s_req = reinterpret_cast<int*>(s_ok + kOkWords * kDocs);

  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int d = blockIdx.y * kDocs + threadIdx.x;
  const bool live = d < D;
  for (int i = threadIdx.x; i < R; i += blockDim.x)
    s_req[i] = r0 + i < B ? __ldg(ph_req + r0 + i) : 0;  // seen after the
  for (int w = 0; w < kOkWords; ++w) s_ok[w * kDocs + threadIdx.x] = 0u;  // next barrier
  uint32_t* okbits = s_ok + threadIdx.x;

  const size_t off = (size_t)tile * N;
  const int n = stage_table(s_term, s_pay, s_filter, tbl_term + off,
                            tbl_pay + off, N);
  // sorted, pads last: an empty table has a pad first (block-uniform)
  const bool any = s_term[0] != kTermPad;
  const Section secs[2] = {
      {title_ftT, title_fwT, title_posT, tpos16 != 0, Tt, Ct, Tt},
      {body_ftT, body_fwT, body_posT, bpos16 != 0, Tb, Cb, Tb},
  };
  float* outs[2] = {add_t, add_b};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const Section& sec = secs[s];
    zero_rows(acc_s, R);
    if (kFlag && s == 0) zero_rows(acc_c, R);
    if (any) {
      PhraseLog plog{s_log + threadIdx.x, kLog, 0, false};
      sweep<false, true>(sec.ftT, sec.fwT, sec.bound, D, d, live, s_term,
                         s_pay, s_filter, n, acc_s, (float*)nullptr, &plog);
      if (live)
        phrase_stage<kFlag>(sec, s == 0, D, d, r0, R, s_term, s_pay, s_filter,
                            n, s_req, plog, okbits, acc_s, acc_c, flag);
    }
    if (live) {
      store_rows(outs[s], acc_s, r0, R, B, D, d);
      if (kFlag && s == 0) store_rows(flag, acc_c, r0, R, B, D, d);
    }
  }
}

}  // namespace ss

// K6: build the batch's phrase tables (one per row tile; `tq_pad` is an
// all-pad [B, 1] keyword column) into `tables` (probe.cuh Tables layout,
// one section), then sweep. flag may be null (emit_flag off).
extern "C" int ss_phrase_delta(const int* title_ftT, const float* title_fwT,
                               int Tt, const int* body_ftT,
                               const float* body_fwT, int Tb, int D,
                               const void* title_posT, int Ct, int tpos16,
                               const void* body_posT, int Cb, int bpos16,
                               const int* tq_pad, int B, const int* ph_ids,
                               const float* ph_valid, int P, int* tables,
                               int R, int N, float* add_t, float* add_b,
                               float* flag, void* stream) {
  using ss::probe::kDocs;
  if (P < 1 || P > ss::kPMax || Ct > ss::kCMax || Cb > ss::kCMax)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  const ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 1);
  int err = ss::probe::launch_build(tq_pad, B, 1, nullptr, nullptr, ph_ids,
                                    ph_valid, P, R, N, 1, tb, st);
  if (err != 0) return err;
  const size_t extra = (size_t)ss::kLogWords * kDocs * 4 +
                       ss::kOkWords * kDocs * 4 + (size_t)R * 4;
  const size_t smem =
      ss::probe::smem_bytes(R, flag != nullptr ? 2 : 1, N, extra);
  using ss::probe::launch_sweep;
  if (flag != nullptr)
    return launch_sweep(ss::phrase_delta_kernel<true>, n_tiles, D, smem, st,
                        title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D,
                        title_posT, Ct, tpos16, body_posT, Cb, bpos16, tb.term,
                        tb.pay, N, R, B, tb.req, add_t, add_b, flag);
  return launch_sweep(ss::phrase_delta_kernel<false>, n_tiles, D, smem, st,
                      title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D,
                      title_posT, Ct, tpos16, body_posT, Cb, bpos16, tb.term,
                      tb.pay, N, R, B, tb.req, add_t, add_b, (float*)nullptr);
}
