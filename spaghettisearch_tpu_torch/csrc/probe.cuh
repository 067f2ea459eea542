// The probe sweep shared by K1 and K3 (membership.cu), K2 (mixed.cu) and
// K4 (fused.cu).
//
// A block owns 128 docs (one thread each) and one tile of up to 64 query
// rows. Per section it stages the tile's probe table (built by
// build_tables_kernel below; ops/kernels/probe.py: distinct (term, row)
// entries sorted by term, int32 term + int32 payload, TERM_PAD last) in
// shared memory and sets one bit per entry in a 32768-bit hash filter. The
// thread then walks its doc's slots once: a slot whose filter bit is clear
// (almost all of them) costs one global load, one hash and one
// shared-memory load; a slot that passes is found by a sorted search, and
// only its entries touch the rows they name. (Searching the table in
// global memory instead, through L1, to free shared memory for a third
// K2 block per SM measured slower for both kernels on the H100.)
//
// The per-row sums live in shared memory, acc[row * 128 + thread]: each
// thread owns one column, so a hit updates its own sums in slot order with
// no atomics and no barrier, the sums are zeroed and stored by their owner
// (a warp stores 128 contiguous bytes of one row per instruction), and the
// accesses of a warp fall in 32 distinct banks whatever rows they name.
//
// Slot loads are software-pipelined through registers: a thread holds the
// kUnroll slot ids of the current batch and has the next batch's loads in
// flight while it probes. The doc axis of ftT is contiguous, so each warp
// load is one 128-byte line. A warp stops at its first all-pad slot row
// (each doc's real slots come first). fw is read only on a hit, issued
// before the search so its latency overlaps it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ss {
namespace probe {

constexpr int kDocs = 128;        // threads per block, one doc each
constexpr int kRowsMax = 64;      // query rows per block (ops/kernels/probe.py ROWS_MAX)
constexpr int kQMax = 32;         // query term columns (engine Q_CATCHALL)
constexpr int kFilterBits = 15;   // 32768-bit filter, 4 KB
constexpr int kFilterWords = 1 << (kFilterBits - 5);
constexpr int kTermPad = 0x7fffffff;
constexpr int kPhraseFlag = 0x8000;
constexpr int kUnroll = 8;        // slot ids per pipelined batch
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t filter_hash(int f) {
  return ((uint32_t)f * 0x9E3779B1u) >> (32 - kFilterBits);
}

__device__ __forceinline__ bool filter_test(const uint32_t* s_filter, int f) {
  const uint32_t h = filter_hash(f);
  return (s_filter[h >> 5] >> (h & 31)) & 1u;
}

// First index in the sorted s_term[0, n) whose term is >= f.
__device__ __forceinline__ int lower_bound(const int* s_term, int n, int f) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (s_term[lo + half] < f) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// The body sweep's slot bound: the doc-sorted layout's per-512-doc-block max
// distinct-term count (exact: slots past it are pads). Read at the warp's
// first doc so the bound is warp-uniform (512 is a multiple of 32).
__device__ inline int body_bound(const int* __restrict__ tmax, int tmax_block,
                                 int Tb, int D, int d) {
  if (tmax == nullptr) return Tb;
  int dw = d & ~31;
  if (dw > D - 1) dw = D - 1;
  const int t = tmax[dw / tmax_block];
  return t < Tb ? (t < 0 ? 0 : t) : Tb;
}

// Stage one tile's table (global, N entries, sorted, pads last) in shared
// memory and build its filter. All threads of the block must call it; it
// begins with a barrier, so the previous table may still be in use when it
// is called. Returns the number of entries staged: copying stops after the
// first chunk of blockDim entries that holds only pads.
__device__ inline int stage_table(int* s_term, int* s_pay, uint32_t* s_filter,
                                  const int* __restrict__ g_term,
                                  const int* __restrict__ g_pay, int N) {
  __syncthreads();
  for (int i = threadIdx.x; i < kFilterWords; i += blockDim.x) s_filter[i] = 0u;
  __syncthreads();
  int staged = 0;
  for (int base = 0; base < N; base += blockDim.x) {
    const int i = base + threadIdx.x;
    int t = kTermPad;
    if (i < N) {
      t = __ldg(g_term + i);
      s_term[i] = t;
      s_pay[i] = __ldg(g_pay + i);
      if (t != kTermPad) {
        const uint32_t h = filter_hash(t);
        atomicOr(s_filter + (h >> 5), 1u << (h & 31));
      }
    }
    staged = min(base + (int)blockDim.x, N);
    // sorted: once a chunk holds no real entry, none follows
    if (!__syncthreads_or(t != kTermPad)) break;
  }
  return staged;
}

template <class T>
__device__ __forceinline__ void zero_rows(T* col, int R) {
  for (int r = 0; r < R; ++r) col[r * kDocs] = T(0);
}

// Store this thread's column of R rows (rows past B are not stored).
template <class T>
__device__ __forceinline__ void store_rows(float* __restrict__ out,
                                           const T* col, int r0, int R,
                                           int B, int D, int d) {
  const int n = min(R, B - r0);
  for (int r = 0; r < n; ++r) out[(size_t)(r0 + r) * D + d] = (float)col[r * kDocs];
}

// Where a K2 sweep logs phrase hits: up to `cap` entries per thread,
// log[i * kDocs + thread] = entry << 16 | slot (the entry's index in the
// table).
struct PhraseLog {
  uint32_t* log;
  int cap;
  int n;
  bool overflow;
};

// Slot j of this thread's doc holds term f (weight w), which passed the
// filter: find its entries and take each. Keyword entries add
// w * multiplicity to acc_s (and multiplicity to acc_c); with kHits they
// set bit `row` of *hits (K4's candidacy: some slot matched the row, a
// zero weight included); with kPhrase, phrase entries are logged.
template <bool kCounts, bool kPhrase, bool kHits, class CountT>
__device__ __forceinline__ void take_hit(int f, float w, int j,
                                         const int* s_term, const int* s_pay,
                                         int n, float* acc_s, CountT* acc_c,
                                         PhraseLog* plog,
                                         unsigned long long* hits) {
  for (int e = lower_bound(s_term, n, f); e < n && s_term[e] == f; ++e) {
    const int p = s_pay[e];
    const int row = p >> 16;
    if (!kPhrase || !(p & kPhraseFlag)) {
      const int m = p & 0x7fff;
      acc_s[row * kDocs] += w * (float)m;
      if (kCounts) acc_c[row * kDocs] += (CountT)m;
      if (kHits) *hits |= 1ull << row;
    } else if (plog->n < plog->cap) {
      plog->log[plog->n++ * kDocs] = ((uint32_t)e << 16) | (uint32_t)j;
    } else {
      plog->overflow = true;
    }
  }
}

// One section's sweep for this thread's doc: each real slot below `bound`
// (warp-uniform) that passes the filter is taken (take_hit), in slot order.
// Without kCompact a warp walks the kUnroll slots of a batch one by one, so
// lanes that pass the filter at different slots take their hits one after
// the other. With kCompact each lane first marks the batch's slots that
// pass, then walks its own marks, so the lanes of a warp take their k-th
// hits together: K3 and K4, whose tables keep the hot terms (no hot
// split), have some lane hitting in most slot rows of a warp. kU slot ids
// are in flight per thread (kUnroll unless the caller asks for more).
template <bool kCounts, bool kPhrase, bool kHits = false, bool kCompact = false,
          class CountT = float, int kU = kUnroll>
__device__ inline void sweep(const int* __restrict__ ftT,
                             const float* __restrict__ fwT, int bound, int D,
                             int d, bool live, const int* s_term,
                             const int* s_pay, const uint32_t* s_filter, int n,
                             float* acc_s, CountT* acc_c, PhraseLog* plog,
                             unsigned long long* hits = nullptr) {
  int cur[kU];
#pragma unroll
  for (int u = 0; u < kU; ++u)
    cur[u] = (live && u < bound) ? __ldg(ftT + (size_t)u * D + d) : -1;
  for (int j0 = 0; j0 < bound; j0 += kU) {
    int nxt[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = j0 + kU + u;
      nxt[u] = (live && j < bound) ? __ldg(ftT + (size_t)j * D + d) : -1;
    }
    if (kCompact) {
      unsigned pass = 0u;  // pads and slots past bound never pass
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (j0 + u < bound && cur[u] >= 0 && filter_test(s_filter, cur[u]))
          pass |= 1u << u;
      while (pass != 0u) {
        const int u = __ffs(pass) - 1;
        pass &= pass - 1;
        int f = cur[0];
#pragma unroll
        for (int k = 1; k < kU; ++k)
          if (u == k) f = cur[k];
        const int j = j0 + u;
        take_hit<kCounts, kPhrase, kHits>(f, __ldg(fwT + (size_t)j * D + d), j,
                                          s_term, s_pay, n, acc_s, acc_c, plog,
                                          hits);
      }
      // the rest are pad slots once a whole slot row is
      if (__all_sync(kFull, cur[kU - 1] < 0)) break;
    } else {
      bool done = false;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int j = j0 + u;
        const int f = cur[u];
        if (j >= bound || __all_sync(kFull, f < 0)) {  // the rest are pad slots
          done = true;
          break;
        }
        if (f >= 0 && filter_test(s_filter, f))
          take_hit<kCounts, kPhrase, kHits>(f, __ldg(fwT + (size_t)j * D + d),
                                            j, s_term, s_pay, n, acc_s, acc_c,
                                            plog, hits);
      }
      if (done) break;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
}

// Dynamic shared memory of a block, in bytes: the per-row sums (n_sums
// arrays of R x kDocs floats), the filter, the table (N terms + N
// payloads), then `extra` bytes for the caller.
__host__ __device__ inline size_t smem_bytes(int R, int n_sums, int N,
                                             size_t extra) {
  return (size_t)R * kDocs * 4 * n_sums + kFilterWords * 4 + (size_t)N * 8 +
         extra;
}

// Where a block's dynamic shared memory puts the pieces smem_bytes counts:
// acc is this thread's column of the first sum array (array k starts at
// acc + k * R * kDocs).
struct Smem {
  float* acc;
  uint32_t* filter;
  int* term;
  int* pay;
  unsigned char* extra;
};

__device__ inline Smem smem_layout(unsigned char* smem, int R, int n_sums,
                                   int N) {
  Smem s;
  s.acc = reinterpret_cast<float*>(smem) + threadIdx.x;
  s.filter = reinterpret_cast<uint32_t*>(smem + (size_t)R * kDocs * 4 * n_sums);
  s.term = reinterpret_cast<int*>(s.filter + kFilterWords);
  s.pay = s.term + N;
  s.extra = reinterpret_cast<unsigned char*>(s.pay + N);
  return s;
}

// Launch a sweep kernel over (row tiles, doc blocks), a doc block's row
// tiles adjacent, with `smem` bytes of dynamic shared memory.
template <class Kernel, class... Args>
__host__ int launch_sweep(Kernel kernel, int n_tiles, int D, size_t smem,
                 cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(n_tiles, (D + probe::kDocs - 1) / probe::kDocs);
  kernel<<<grid, probe::kDocs, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// Building the tables (ops/kernels/probe.py build_tables is the plain
// version; the two must give the same tables, entry for entry).
// ---------------------------------------------------------------------

constexpr int kBuildThreads = 1024;
constexpr int kEntriesMax = kRowsMax * (kQMax + 16);  // R x (Q_MAX + P_MAX)
constexpr unsigned long long kPadKey = ~0ull >> 1;  // TERM_PAD << 32 | 0xffffffff

// Where the tables of a batch live: terms [S, n_tiles, N], payloads [S,
// n_tiles, N], then req [B] (required phrase positions per row), int32.
// S is 2 for K1/K2 (title, body) and 1 for K3 (one section) and K4 (one
// table both sections are swept against).
struct Tables {
  int* term;
  int* pay;
  int* req;
};

__host__ inline Tables tables_at(int* buf, int n_tiles, int N, int sections) {
  const size_t n = (size_t)sections * n_tiles * N;
  return {buf, buf + n, buf + 2 * n};
}

// The sort key of candidate i = r * (Q + P) + c of row tile r0, section s
// (kPadKey when it enters no table): a keyword column below the row's
// active count that holds the row's first copy of its term, with the
// term's multiplicity; or a valid phrase slot. Negative ids and kTermPad
// (the int32-max column pad) never enter.
__device__ inline unsigned long long candidate_key(
    int i, int s, int r0, int B, int Q, int P, const int* __restrict__ tq,
    const int* __restrict__ qn, const int* __restrict__ qnb,
    const int* __restrict__ ph_ids, const float* __restrict__ ph_valid) {
  const int W = Q + P;
  const int r = i / W, c = i % W, row = r0 + r;
  if (row >= B) return kPadKey;
  if (c >= Q) {
    const int p = c - Q;
    const int t = ph_ids[(size_t)row * P + p];
    if (!(ph_valid[(size_t)row * P + p] > 0.f) || t < 0 || t == kTermPad)
      return kPadKey;
    return ((unsigned long long)(uint32_t)t << 32) |
           (uint32_t)((r << 16) | kPhraseFlag | p);
  }
  const int* trow = tq + (size_t)row * Q;
  const int* act_of = (s == 1 && qnb != nullptr) ? qnb : qn;
  int act = act_of != nullptr ? act_of[row] : Q;
  act = act < 0 ? 0 : (act > Q ? Q : act);
  const int t = trow[c];
  if (c >= act || t < 0 || t == kTermPad) return kPadKey;
  int m = 0;
  for (int c2 = 0; c2 < act; ++c2) {
    if (trow[c2] == t) {
      if (c2 < c) return kPadKey;  // not the row's first copy
      ++m;
    }
  }
  return ((unsigned long long)(uint32_t)t << 32) | (uint32_t)((r << 16) | m);
}

// One block per (row tile, section) (section 0 reads columns < qn, or all
// Q when qn is null; section 1 those < qnb, or qn without it): each thread makes the keys of a run
// of the tile's candidates, a block-wide scan compacts the real ones to
// the front of shared memory, and they are bitonic-sorted (padded to the
// next power of two of their count, not of the candidates'); the block
// writes the tile's N entries, pads last. The title's blocks also write
// each row's required phrase positions.
__global__ void __launch_bounds__(kBuildThreads)
build_tables_kernel(const int* __restrict__ tq, int B, int Q,
                    const int* __restrict__ qn, const int* __restrict__ qnb,
                    const int* __restrict__ ph_ids,
                    const float* __restrict__ ph_valid, int P, int R, int N,
                    Tables out) {
  extern __shared__ unsigned long long keys[];
  __shared__ int warp_total[kBuildThreads / 32];
  const int s = blockIdx.y;
  const int tile = blockIdx.x;
  const int r0 = tile * R;
  const int per = (N + blockDim.x - 1) / blockDim.x;
  const int i0 = threadIdx.x * per, i1 = min(i0 + per, N);
  int cnt = 0;
  for (int i = i0; i < i1; ++i)
    cnt += candidate_key(i, s, r0, B, Q, P, tq, qn, qnb, ph_ids, ph_valid) != kPadKey;
  // block-wide exclusive scan of cnt
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  if (warp == 0) {
    int t = lane < n_warps ? warp_total[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    warp_total[lane] = t;
  }
  __syncthreads();
  int at = x - cnt + (warp > 0 ? warp_total[warp - 1] : 0);
  const int n_real = warp_total[n_warps - 1];
  for (int i = i0; i < i1; ++i) {
    const unsigned long long k =
        candidate_key(i, s, r0, B, Q, P, tq, qn, qnb, ph_ids, ph_valid);
    if (k != kPadKey) keys[at++] = k;
  }
  int NP = 1;
  while (NP < n_real) NP <<= 1;
  for (int i = n_real + threadIdx.x; i < NP; i += blockDim.x) keys[i] = kPadKey;
  __syncthreads();
  for (int k = 2; k <= NP; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < NP; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const size_t base = (size_t)(s * gridDim.x + tile) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const unsigned long long k = i < n_real ? keys[i] : kPadKey;
    out.term[base + i] = (int)(k >> 32);
    out.pay[base + i] = (int)(uint32_t)k;
  }
  if (s == 0 && out.req != nullptr) {
    for (int r = threadIdx.x; r < R && r0 + r < B; r += blockDim.x) {
      int req = 0;
      for (int p = 0; p < P; ++p)
        if (ph_valid[(size_t)(r0 + r) * P + p] > 0.f) req |= 1 << p;
      out.req[r0 + r] = (req & 1) ? req : 0;
    }
  }
}

// Launch the build of `sections` tables per row tile on `st` (P = 0:
// keyword entries only; req written only when out.req is not null).
__host__ inline int launch_build(const int* tq, int B, int Q, const int* qn,
                                 const int* qnb, const int* ph_ids,
                                 const float* ph_valid, int P, int R, int N,
                                 int sections, Tables out, cudaStream_t st) {
  if (R < 1 || R > kRowsMax || Q < 1 || Q > kQMax || N != R * (Q + P) ||
      N > kEntriesMax || sections < 1 || sections > 2)
    return (int)cudaErrorInvalidValue;
  int NP = 1;
  while (NP < N) NP <<= 1;
  const size_t smem = (size_t)NP * 8;
  cudaError_t e = cudaFuncSetAttribute(
      build_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + R - 1) / R, sections);
  build_tables_kernel<<<grid, kBuildThreads, smem, st>>>(
      tq, B, Q, qn, qnb, ph_ids, ph_valid, P, R, N, out);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace ss
