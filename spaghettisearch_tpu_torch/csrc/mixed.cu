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
// log in shared memory. After the sweep, each logged hit of a row's
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
#include "probe.cuh"

namespace ss {

constexpr int kPMax = 16;  // engine P_LEVELS[-1]
constexpr int kCMax = 32;  // device_index POS_T_C_MAX
constexpr int kOkWords = probe::kRowsMax / 32;
constexpr int kLog = 16;  // phrase hits a thread logs per section
// Words of the per-thread log region: the log, or a rescan's slots.
constexpr int kLogWords = kLog > kPMax / 2 ? kLog : kPMax / 2;
constexpr float kPosRealMax = 8388608.0f;  // 2^23 (mixed.py POS_REAL_MAX)
constexpr float kPosBig = 16777216.0f;     // 2^24 (mixed.py POS_BIG)

__device__ __forceinline__ float load_pos(const void* posT, bool pos16,
                                          size_t i) {
  if (pos16) {
    const float x = (float)__ldg(static_cast<const int16_t*>(posT) + i);
    return x >= 32767.0f ? kPosBig : x;
  }
  return __ldg(static_cast<const float*>(posT) + i);
}

// Where a check finds the slot at which this doc holds phrase position p
// of row k (-1: absent). From the sweep's log of phrase hits:
struct LogSlots {
  const uint32_t* log;  // this thread's column
  int n;
  const int* s_pay;
  int k;
  __device__ int operator()(int p) const {
    for (int i = 0; i < n; ++i) {
      const uint32_t v = log[i * probe::kDocs];
      const int q = s_pay[v >> 16];
      if ((q >> 16) == k && (q & 0x7fff) == p) return (int)(v & 0xffffu);
    }
    return -1;
  }
};

// From a rescan of the doc's slots (after the log overflowed): two 16-bit
// slots a word, in this thread's column of the log region.
struct ArraySlots {
  uint32_t* col;
  __device__ int operator()(int p) const {
    const uint32_t w = col[(p >> 1) * probe::kDocs];
    return (int)(short)(p & 1 ? w >> 16 : w & 0xffffu);
  }
  __device__ void clear() const {
    for (int i = 0; i < kPMax / 2; ++i) col[i * probe::kDocs] = 0xffffffffu;
  }
  __device__ void set(int p, int j) const {
    uint32_t* w = col + (p >> 1) * probe::kDocs;
    *w = p & 1 ? (*w & 0xffffu) | ((uint32_t)j << 16) : (*w & 0xffff0000u) | (uint32_t)j;
  }
};

// The positional chain of one (row, doc, section) whose every required
// position p is at slot_of(p): some real position a of the term at p = 0
// such that each other required term occurs at a + p.
template <class Slots>
__device__ inline bool chain_holds(const void* posT, bool pos16, int T, int C,
                                   int D, int d, const Slots& slot_of, int req) {
  float anc[kCMax];
  uint32_t hit = 0;
  const size_t s0 = (size_t)slot_of(0);
#pragma unroll
  for (int c = 0; c < kCMax; ++c) {
    anc[c] = c < C ? load_pos(posT, pos16, ((size_t)c * T + s0) * D + d) : kPosBig;
    if (anc[c] < kPosRealMax) hit |= 1u << c;
  }
  for (int m = req & ~1; m != 0 && hit != 0; m &= m - 1) {
    const int p = __ffs(m) - 1;
    const size_t sp = (size_t)slot_of(p);
    float pos[kCMax];
#pragma unroll
    for (int c = 0; c < kCMax; ++c)
      pos[c] = c < C ? load_pos(posT, pos16, ((size_t)c * T + sp) * D + d)
                     : __int_as_float(0x7fffffff);  // NaN: equals nothing
    const float fp = (float)p;
    uint32_t found = 0;
#pragma unroll
    for (int c0 = 0; c0 < kCMax; ++c0) {
      const float target = anc[c0] + fp;
      bool m0 = false;
#pragma unroll
      for (int c = 0; c < kCMax; ++c) m0 |= (pos[c] == target);
      found |= (uint32_t)m0 << c0;
    }
    hit &= found;
  }
  return hit != 0;
}

// Per-section inputs of the phrase stage.
struct Section {
  const int* ftT;
  const float* fwT;
  const void* posT;
  bool pos16;
  int T;
  int C;
  int bound;
};

// Check row k of this thread's doc in one section and fold a match into
// the row's sums.
template <bool kCounts, class Slots>
__device__ inline void fold_match(const Section& sec, bool title, int k,
                                  int req, int D, int d, int r0,
                                  const Slots& slot_of, uint32_t* okbits,
                                  float* acc_s, float* acc_c, float* tc) {
  using probe::kDocs;
  for (int m = req; m != 0; m &= m - 1)
    if (slot_of(__ffs(m) - 1) < 0) return;  // a term is absent
  if (!chain_holds(sec.posT, sec.pos16, sec.T, sec.C, D, d, slot_of, req)) return;
  float sum = 0.f;
  for (int m = req; m != 0; m &= m - 1)
    sum += __ldg(sec.fwT + (size_t)slot_of(__ffs(m) - 1) * D + d);
  acc_s[k * kDocs] += sum;
  uint32_t* ok = okbits + (k >> 5) * kDocs;
  const uint32_t bit = 1u << (k & 31);
  if (title) {
    if (kCounts) acc_c[k * kDocs] += 1.f;
    *ok |= bit;
  } else if (kCounts && !(*ok & bit)) {
    tc[(size_t)(r0 + k) * D + d] += 1.f;  // stored by this thread already
  }
}

// The phrase stage of one section for this thread's doc, after its sweep.
// A rescan after an overflow keeps its slots where the log was.
template <bool kCounts>
__device__ inline void phrase_stage(const Section& sec, bool title, int D,
                                    int d, int r0, int R, const int* s_term,
                                    const int* s_pay, const uint32_t* s_filter,
                                    int n,
                                    const int* s_req,
                                    const probe::PhraseLog& plog,
                                    uint32_t* okbits, float* acc_s,
                                    float* acc_c, float* tc) {
  using namespace probe;
  if (!plog.overflow) {
    for (int i = 0; i < plog.n; ++i) {
      const int q = s_pay[plog.log[i * kDocs] >> 16];
      if ((q & 0x7fff) != 0) continue;  // position 0 starts a row's check
      const int k = q >> 16;
      const int req = s_req[k];
      if (req & 1)
        fold_match<kCounts>(sec, title, k, req, D, d, r0,
                            LogSlots{plog.log, plog.n, s_pay, k}, okbits, acc_s,
                            acc_c, tc);
    }
    return;
  }
  const ArraySlots slots{plog.log};
  for (int k = 0; k < R; ++k) {  // the log overflowed: rescan per phrase row
    const int req = s_req[k];
    if (!(req & 1)) continue;
    slots.clear();
    for (int j = 0; j < sec.bound; ++j) {
      const int f = __ldg(sec.ftT + (size_t)j * D + d);
      if (f < 0) break;
      if (!filter_test(s_filter, f)) continue;
      for (int e = lower_bound(s_term, n, f); e < n && s_term[e] == f; ++e) {
        const int q = s_pay[e];
        if ((q & kPhraseFlag) && (q >> 16) == k) slots.set(q & 0x7fff, j);
      }
    }
    fold_match<kCounts>(sec, title, k, req, D, d, r0, slots, okbits, acc_s,
                        acc_c, tc);
  }
}

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

  const Section secs[2] = {
      {title_ftT, title_fwT, title_posT, tpos16 != 0, Tt, Ct, Tt},
      {body_ftT, body_fwT, body_posT, bpos16 != 0, Tb, Cb, Tb},
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
    sweep<kCounts, true>(sec.ftT, sec.fwT, sec.bound, D, d, live, s_term,
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
// `tables` (probe.cuh Tables layout), then sweep.
extern "C" int ss_mixed(const int* title_ftT, const float* title_fwT, int Tt,
                        const int* body_ftT, const float* body_fwT, int Tb,
                        int D, const void* title_posT, int Ct, int tpos16,
                        const void* body_posT, int Cb, int bpos16,
                        const int* tq, int B, int Q, const int* qn,
                        const int* qnb, const int* ph_ids,
                        const float* ph_valid, int P, int* tables, int R,
                        int N, float* ts, float* tc, float* bs, float* bc,
                        void* stream) {
  using ss::probe::kDocs;
  if (P < 1 || P > ss::kPMax || Ct > ss::kCMax || Cb > ss::kCMax)
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
        tpos16, body_posT, Cb, bpos16, tb.term, tb.pay, N, R, B, tb.req, ts,
        c_title, bs, c_body);
    return (int)cudaGetLastError();
  };
  if (tc != nullptr) return launch(ss::mixed_kernel<true>, tc, bc);
  return launch(ss::mixed_kernel<false>, nullptr, nullptr);
}
