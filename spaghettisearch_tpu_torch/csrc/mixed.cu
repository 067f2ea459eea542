// K2: fused keyword + dense phrase scoring (the mixed lane).
//
// Replaces the TPU kernel spaghettisearch_tpu/ops/kernels/mixed.py
// pallas_mixed_scores_2sec (_kernel_mixed, _phrase_block). It computes K1's
// keyword sweep for both sections, then folds in phrase matches with the
// reference semantics (mixed.py module docstring):
//   - a section adds the sum of its phrase-term weights only when every
//     valid phrase term occurs in that section AND the positional chain
//     holds: some position p0 of term 0 with term i at p0 + i;
//   - an invalid phrase slot (ph_valid <= 0) is found, weighs 0 and has no
//     chain constraint; a row whose slot 0 is invalid holds no phrase;
//   - a 1-term phrase matches wherever the term occurs (-100 included);
//   - a phrase match alone makes the doc a candidate (the title count gets
//     the flag when counts are emitted).
// Positions come from the doc-major planes posT[c*T + t, d] (the c-th unique
// position of doc d's slot t), stored int16 (32767 = pad -> POS_BIG) or f32;
// int16 values are dequantized exactly like the TPU kernel's _deq_posT, so
// every compare sees the same f32 values as the plain version.
//
// What bounds it on the H100: bytes, as K1 (the term ids of the real
// slots of both sections, read once, a weight only where a row asks for
// the slot's term, and the [B, D] outputs, written once); the position
// planes are read only where a section holds every term of a phrase.
//
// Design: one probe sweep per section (csrc/probe.cuh). The table build
// puts each phrase row's valid phrase terms into the same table as the
// keyword terms, as entries flagged with (row, phrase position p); a term
// at two positions of a row has two entries. The sweep adds keyword hits
// to the row sums and logs each phrase hit (entry, slot) in a per-thread
// log in shared memory. After the sweep, the phrase stage (csrc/phrase.cuh,
// shared with K6, phrase_delta.cu) runs: each logged hit of a row's
// position 0 starts that row's check: the row's other positions are looked
// up in the log, and only when every valid position was found are the
// positions read for the chain and the weights summed (in phrase order, as
// the plain version sums them). So there is one pass over the slots, and
// no per-term rescan. A doc with more phrase hits in a section than the
// log holds (kLog, 16) is checked by rescanning its slots once per phrase
// row of the tile, the same probe again: correct, slower, rare at 16 (a
// log of 8 made the B=128, P=16 batch 2.5x slower on the H100: too many
// docs rescanned). The anchor and position lists of the
// chain check live in registers (fully unrolled over the 32 planes, NaN
// past C), not in local memory. Phrase matches are added to the owner's shared-memory sums
// before the store; the body's candidacy flag goes to the title count the
// same thread stored, unless the title already matched. Shared memory per
// block of 64 rows with counts elided: 32 KB of sums, the 4 KB filter, the
// table (8 B an entry: 10 KB at Q=4, P=16), the 8 KB log, 1.25 KB of
// flags: 4 blocks per SM.
//
// The doc-sorted layout's body bound (body_tmax, as K1 reads it: the max
// distinct-term count of each 512-doc block, read at the warp's first doc
// so it is warp-uniform; probe.cuh body_bound). Slots past a block's tmax
// are pads, so every bounded call gives the unbounded call's results bit
// for bit. The TPU kernel has two body loops, the keyword sweep and one
// sweep per phrase term, and its tmax_stage picks which the bound cuts
// ("kw", "phrase" or "both"). Here keyword and phrase hits come from ONE
// sweep, and the only other body loop is the rescan after a log overflow
// (phrase.cuh phrase_matches). So the stage mask maps onto these two:
// kTmaxSweep ("kw") bounds the sweep, kTmaxRescan ("phrase") the rescan,
// both bits ("both") both. The title section is never bounded.
#include "phrase.cuh"

namespace ss {

constexpr int kTmaxSweep = 1;   // tmax_stage "kw"
constexpr int kTmaxRescan = 2;  // tmax_stage "phrase"

template <bool kCounts>
__global__ void __launch_bounds__(probe::kDocs)
mixed_kernel(const int* __restrict__ title_ftT,
             const float* __restrict__ title_fwT, int Tt,
             const int* __restrict__ body_ftT,
             const float* __restrict__ body_fwT, int Tb, int D,
             const void* title_posT, int Ct, int tpos16,
             const void* body_posT, int Cb, int bpos16,
             const int* __restrict__ tbl_term, const int* __restrict__ tbl_pay,
             int N, int R, int B, const int* __restrict__ ph_req,
             const int* __restrict__ body_tmax, int tmax_block, int tmax_stage,
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

  // the body's bound (Tb without body_tmax) for the loops the stage picks:
  // Section.bound is the rescan's, sweep_bound the sweep's
  const int tmax = body_bound(body_tmax, tmax_block, Tb, D, d);
  const int sweep_bound[2] = {Tt, tmax_stage & kTmaxSweep ? tmax : Tb};
  const Section secs[2] = {
      {title_ftT, title_fwT, title_posT, tpos16 != 0, Tt, Ct, Tt},
      {body_ftT, body_fwT, body_posT, bpos16 != 0, Tb, Cb,
       tmax_stage & kTmaxRescan ? tmax : Tb},
  };
  float* outs[2][2] = {{ts, tc}, {bs, bc}};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const Section& sec = secs[s];
    const size_t off = (size_t)(s * gridDim.x + tile) * N;
    const int n = stage_table(s_term, s_pay, s_filter, tbl_term + off,
                              tbl_pay + off, N);
    zero_rows(acc_s, R);
    if (kCounts) zero_rows(acc_c, R);
    PhraseLog plog{s_log + threadIdx.x, kLog, 0, false};
    sweep<kCounts, true>(sec.ftT, sec.fwT, sweep_bound[s], D, d, live, s_term,
                         s_pay, s_filter, n, acc_s, acc_c, &plog);
    if (live) {
      phrase_stage<kCounts>(sec, s == 0, D, d, r0, R, s_term, s_pay, s_filter,
                            n, s_req, plog, okbits, acc_s, acc_c, tc);
      store_rows(outs[s][0], acc_s, r0, R, B, D, d);
      if (kCounts) store_rows(outs[s][1], acc_c, r0, R, B, D, d);
    }
  }
}

}  // namespace ss

// K2: build the batch's probe tables (keyword and phrase entries) into
// `tables` (probe.cuh Tables layout), then sweep. body_tmax (may be null:
// no bound) holds one bound per tmax_block docs; tmax_stage is a mask of
// kTmaxSweep and kTmaxRescan.
extern "C" int ss_mixed(const int* title_ftT, const float* title_fwT, int Tt,
                        const int* body_ftT, const float* body_fwT, int Tb,
                        int D, const void* title_posT, int Ct, int tpos16,
                        const void* body_posT, int Cb, int bpos16,
                        const int* tq, int B, int Q, const int* qn,
                        const int* qnb, const int* ph_ids,
                        const float* ph_valid, int P, const int* body_tmax,
                        int tmax_block, int tmax_stage, int* tables, int R,
                        int N, float* ts, float* tc, float* bs, float* bc,
                        void* stream) {
  using ss::probe::kDocs;
  if (P < 1 || P > ss::kPMax || Ct > ss::kCMax || Cb > ss::kCMax ||
      (body_tmax != nullptr && (tmax_block % 32 != 0 || tmax_block <= 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + R - 1) / R;
  const ss::probe::Tables tb = ss::probe::tables_at(tables, n_tiles, N, 2);
  int err = ss::probe::launch_build(tq, B, Q, qn, qnb, ph_ids, ph_valid, P, R,
                                    N, 2, tb, st);
  if (err != 0) return err;
  const dim3 grid(n_tiles, (D + kDocs - 1) / kDocs);  // a doc block's row tiles adjacent
  const size_t extra = (size_t)ss::kLogWords * kDocs * 4 +
                       ss::kOkWords * kDocs * 4 + (size_t)R * 4;
  const size_t smem = ss::probe::smem_bytes(R, tc != nullptr ? 2 : 1, N, extra);
  auto launch = [&](auto kernel, float* c_title, float* c_body) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kDocs, smem, st>>>(
        title_ftT, title_fwT, Tt, body_ftT, body_fwT, Tb, D, title_posT, Ct,
        tpos16, body_posT, Cb, bpos16, tb.term, tb.pay, N, R, B, tb.req,
        body_tmax, tmax_block, tmax_stage, ts, c_title, bs, c_body);
    return (int)cudaGetLastError();
  };
  if (tc != nullptr) return launch(ss::mixed_kernel<true>, tc, bc);
  return launch(ss::mixed_kernel<false>, nullptr, nullptr);
}
