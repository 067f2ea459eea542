// The phrase stage shared by K2 (mixed.cu) and K6 (phrase_delta.cu): after
// a section's probe sweep (probe.cuh sweep with kPhrase) has logged this
// thread's phrase hits, check each phrase row of the tile against the
// doc and fold a match into the row's shared-memory sums, with the
// reference semantics (ops/kernels/mixed.py module docstring):
//   - a section adds the sum of its phrase-term weights only when every
//     valid phrase term occurs in that section AND the positional chain
//     holds: some position p0 of term 0 with term i at p0 + i;
//   - an invalid phrase slot (ph_valid <= 0) is found, weighs 0 and has no
//     chain constraint; a row whose slot 0 is invalid holds no phrase;
//   - a 1-term phrase matches wherever the term occurs (-100 included).
// Each logged hit of a row's position 0 starts that row's check: the row's
// other positions are looked up in the log, and only when every valid
// position was found are the positions read for the chain and the weights
// summed (in phrase order, as the plain version sums them). A doc with more
// phrase hits in a section than the log holds (kLog) is checked by
// rescanning its slots once per phrase row of the tile. Positions come from
// the doc-major planes posT[c*T + t, d], int16 (32767 = pad -> POS_BIG) or
// f32, dequantized exactly like the TPU kernel's _deq_posT. The chain check
// is compiled for a bucket kC of plane counts (K6 instantiates 4, 8, 16 and
// 32 and picks the bucket the index's C falls in; K2 keeps 32): its anchor
// and position lists are kC registers each, and it makes kC * kC compares.
// What a match does besides adding its weights is the caller's (OnMatch).
#pragma once

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
// such that each other required term occurs at a + p. C <= kC planes.
template <int kC, class Slots>
__device__ inline bool chain_holds(const void* posT, bool pos16, int T, int C,
                                   int D, int d, const Slots& slot_of, int req) {
  static_assert(kC >= 1 && kC <= kCMax, "plane bucket");
  float anc[kC];
  uint32_t hit = 0;
  const size_t s0 = (size_t)slot_of(0);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    anc[c] = c < C ? load_pos(posT, pos16, ((size_t)c * T + s0) * D + d) : kPosBig;
    if (anc[c] < kPosRealMax) hit |= 1u << c;
  }
  for (int m = req & ~1; m != 0 && hit != 0; m &= m - 1) {
    const int p = __ffs(m) - 1;
    const size_t sp = (size_t)slot_of(p);
    float pos[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c)
      pos[c] = c < C ? load_pos(posT, pos16, ((size_t)c * T + sp) * D + d)
                     : __int_as_float(0x7fffffff);  // NaN: equals nothing
    const float fp = (float)p;
    uint32_t found = 0;
#pragma unroll
    for (int c0 = 0; c0 < kC; ++c0) {
      const float target = anc[c0] + fp;
      bool m0 = false;
#pragma unroll
      for (int c = 0; c < kC; ++c) m0 |= (pos[c] == target);
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

// Check row k of this thread's doc in one section; on a match, add the
// row's phrase-term weights (in phrase order) to its sum and call
// on_match(k).
template <int kC, class Slots, class OnMatch>
__device__ inline void fold_match(const Section& sec, int k, int req, int D,
                                  int d, const Slots& slot_of, float* acc_s,
                                  OnMatch& on_match) {
  using probe::kDocs;
  for (int m = req; m != 0; m &= m - 1)
    if (slot_of(__ffs(m) - 1) < 0) return;  // a term is absent
  if (!chain_holds<kC>(sec.posT, sec.pos16, sec.T, sec.C, D, d, slot_of, req))
    return;
  float sum = 0.f;
  for (int m = req; m != 0; m &= m - 1)
    sum += __ldg(sec.fwT + (size_t)slot_of(__ffs(m) - 1) * D + d);
  acc_s[k * kDocs] += sum;
  on_match(k);
}

// The phrase stage of one section for this thread's doc, after its sweep:
// every phrase row of the tile is checked (fold_match). A rescan after an
// overflow keeps its slots where the log was.
template <int kC, class OnMatch>
__device__ inline void phrase_matches(const Section& sec, int D, int d, int R,
                                      const int* s_term, const int* s_pay,
                                      const uint32_t* s_filter, int n,
                                      const int* s_req,
                                      const probe::PhraseLog& plog,
                                      float* acc_s, OnMatch& on_match) {
  using namespace probe;
  if (!plog.overflow) {
    for (int i = 0; i < plog.n; ++i) {
      const int q = s_pay[plog.log[i * kDocs] >> 16];
      if ((q & 0x7fff) != 0) continue;  // position 0 starts a row's check
      const int k = q >> 16;
      const int req = s_req[k];
      if (req & 1)
        fold_match<kC>(sec, k, req, D, d, LogSlots{plog.log, plog.n, s_pay, k},
                       acc_s, on_match);
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
    fold_match<kC>(sec, k, req, D, d, slots, acc_s, on_match);
  }
}

// K2's phrase stage: all kCMax planes; a match in the title adds 1 to the
// row's title count (kCounts) and sets its bit in okbits; a match in the
// body adds 1 to the title count this thread stored, unless the title
// matched.
template <bool kCounts>
__device__ inline void phrase_stage(const Section& sec, bool title, int D,
                                    int d, int r0, int R, const int* s_term,
                                    const int* s_pay, const uint32_t* s_filter,
                                    int n, const int* s_req,
                                    const probe::PhraseLog& plog,
                                    uint32_t* okbits, float* acc_s,
                                    float* acc_c, float* tc) {
  using probe::kDocs;
  auto count = [&](int k) {
    uint32_t* ok = okbits + (k >> 5) * kDocs;
    const uint32_t bit = 1u << (k & 31);
    if (title) {
      if (kCounts) acc_c[k * kDocs] += 1.f;
      *ok |= bit;
    } else if (kCounts && !(*ok & bit)) {
      tc[(size_t)(r0 + k) * D + d] += 1.f;  // stored by this thread already
    }
  };
  phrase_matches<kCMax>(sec, D, d, R, s_term, s_pay, s_filter, n, s_req, plog,
                        acc_s, count);
}

}  // namespace ss
