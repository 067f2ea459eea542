// The rank's finalize in one pass: the hot fold's add, the candidacy, the
// phrase fold's add, cosine, the blend, the -inf mask and the top-k's
// per-128-doc chunk maxima.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it (spaghettisearch_tpu/ops/scoring.py finalize_scores, _fold_hot,
// the candidacy, exact_top_k's chunk max). On the card the same chain ran
// as a dozen PyTorch elementwise passes over [B, D] f32; this kernel is
// their fusion. For query row b and doc d < D, in the composition's order:
//
//     bs    = bs + hot                                    (hot present)
//     cand  = (tc + fl) + (bc + (hot > 0)) > 0            (counts given)
//           | ts + bs > 0 || fl > 0                       (counts elided)
//     ts, bs = ts + pt, bs + pb                           (phrase fold)
//     qmag  = sqrt(qlen[b])
//     t, u  = ts / (mag_t[d] * qmag), bs / (mag_b[d] * qmag)   NaN -> 0
//     sqd   = 0 + sum_c tp[b, c] * pr[d, c]
//     out   = ((w_pr*sqd + w_t*t) + w_b*u) * scale  if cand else -inf
//     cmax[b, m] = max over out[b, 128m : 128m + 128]
//
// `out` is [B, M*128] (M = ceil(D / 128)) with -inf past D, so the top-k
// gathers whole chunks of it. The arithmetic uses the round-to-nearest
// intrinsics, which nvcc never contracts into FMAs, so each value is the
// bits the separate passes give; with C > 1 only sqd's order of adds may
// differ from cuBLAS's. cmax takes PyTorch's amax rule: a NaN wins, else
// the larger. Compiled without --use_fast_math: isnan() and IEEE division
// keep NaN -> 0 and +inf exactly.
//
// What bounds it on the H100: bytes. Per call it reads ts, bs, the hot
// GEMM's output and the counts where given, each [B, D] f32 once, and
// writes `out` once (B=128, D=1.25M, no counts: 2.56 GB, 0.76 ms at
// 3.35 TB/s); mag_t, mag_b and pagerank are D-long and come from L2 to
// all but the first block of a chunk range.
//
// Design: one warp per (row, 128-doc chunk), each lane four consecutive
// docs as one float4 of each stream (streaming loads and stores, ld.cs /
// st.cs, since nothing reads them again but the top-k's k chunks), and a
// shuffle max gives the chunk's cmax. A block is 8 warps on 8 consecutive
// rows of the same 4 chunks, and the blocks of one chunk range are
// consecutive, so the doc-long arrays are read from memory once per range.
// Templates follow what the caller passes: the hot fold, the counts, the
// phrase fold, C == 1 (else a loop over the C categories, none included),
// and whether every stream allows float4 (rows 16-byte aligned); the
// scalar variant serves the rest. The doc-long arrays have stride 1.
#include <math.h>
#include <stdint.h>

namespace ss {
namespace fin {

constexpr int kWarps = 8;           // rows of a block
constexpr int kChunks = 4;          // 128-doc chunks a warp walks
constexpr int kChunk = 128;         // docs of a chunk: 32 lanes x 4
constexpr int kThreads = kWarps * 32;

struct Args {
  const float* ts; long long ts_rs;
  const float* bs; long long bs_rs;
  const float* hot; long long hot_rs;
  const float* tc; long long tc_rs;
  const float* bc; long long bc_rs;
  const float* ph; long long ph_rs, ph_ds, ph_cs;  // [B, D, 3]: tw, bw, flag
  const float* mag_t;
  const float* mag_b;
  const float* pr; long long pr_ds, pr_cs; int C;  // [D, C]
  const float* qlen;
  const float* tp; long long tp_rs, tp_cs;          // [B, C]
  float w_pr, w_t, w_b, scale;
  int B, D, M;
  float* out;   // [B, M * kChunk]
  float* cmax;  // [B, M]
};

// PyTorch's amax rule on the card (a NaN wins, else the larger)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// four docs [d0, d0 + 4) of a row: streamed (read once) or through the
// read-only cache (the doc-long arrays every row reads)
template <bool VEC, bool STREAM>
__device__ __forceinline__ void load4(const float* __restrict__ p, int d0,
                                      int D, float (&v)[4]) {
  if (VEC) {
    const float4* q = reinterpret_cast<const float4*>(p + d0);
    const float4 x = STREAM ? __ldcs(q) : __ldg(q);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = d0 + j < D ? (STREAM ? __ldcs(p + d0 + j) : __ldg(p + d0 + j)) : 0.f;
  }
}

__device__ __forceinline__ float normalize(float s, float mag, float qmag) {
  const float n = __fdiv_rn(s, __fmul_rn(mag, qmag));
  return isnan(n) ? 0.f : n;
}

// C1: one topic category (else C of them, none included, in a loop)
template <bool HOT, bool COUNTS, bool PH, bool C1, bool VEC>
__global__ void __launch_bounds__(kThreads) finalize_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int n_row_groups = (a.B + kWarps - 1) / kWarps;
  const int b = (blockIdx.x % n_row_groups) * kWarps + (threadIdx.x >> 5);
  const int m0 = (blockIdx.x / n_row_groups) * kChunks;
  if (b >= a.B) return;  // a whole warp: no block-wide sync follows
  const float qmag = __fsqrt_rn(__ldg(a.qlen + b));
  const float tp0 = C1 ? __ldg(a.tp + b * a.tp_rs) : 0.f;
  const float* ts = a.ts + b * a.ts_rs;
  const float* bs = a.bs + b * a.bs_rs;
  const float* hot = HOT ? a.hot + b * a.hot_rs : nullptr;
  const float* tc = COUNTS ? a.tc + b * a.tc_rs : nullptr;
  const float* bc = COUNTS ? a.bc + b * a.bc_rs : nullptr;
  const float* ph = PH ? a.ph + b * a.ph_rs : nullptr;
  float* out = a.out + (long long)b * a.M * kChunk;
  const int m1 = min(a.M, m0 + kChunks);
  for (int m = m0; m < m1; ++m) {
    const int d0 = m * kChunk + lane * 4;
    float f[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (d0 < a.D) {  // VEC: D % 4 == 0, so all four docs or none
      float t[4], s[4], mt[4], mb[4], h[4], ct[4], cb[4], pr[4];
      load4<VEC, true>(ts, d0, a.D, t);
      load4<VEC, true>(bs, d0, a.D, s);
      load4<VEC, false>(a.mag_t, d0, a.D, mt);
      load4<VEC, false>(a.mag_b, d0, a.D, mb);
      if (HOT) load4<VEC, true>(hot, d0, a.D, h);
      if (COUNTS) {
        load4<VEC, true>(tc, d0, a.D, ct);
        load4<VEC, true>(bc, d0, a.D, cb);
      }
      if (C1) load4<VEC, false>(a.pr, d0, a.D, pr);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + j;
        if (!VEC && d >= a.D) break;
        float pt = 0.f, pb = 0.f, fl = 0.f;
        if (PH) {
          const float* e = ph + d * a.ph_ds;
          pt = __ldcs(e);
          pb = __ldcs(e + a.ph_cs);
          fl = __ldcs(e + 2 * a.ph_cs);
        }
        float sj = s[j];
        if (HOT) sj = __fadd_rn(sj, h[j]);
        bool cand;
        if (COUNTS) {
          const float cbj = HOT ? __fadd_rn(cb[j], h[j] > 0.f ? 1.f : 0.f) : cb[j];
          const float ctj = PH ? __fadd_rn(ct[j], fl) : ct[j];
          cand = __fadd_rn(ctj, cbj) > 0.f;
        } else {
          cand = __fadd_rn(t[j], sj) > 0.f || (PH && fl > 0.f);
        }
        float tj = t[j];
        if (PH) {
          tj = __fadd_rn(tj, pt);
          sj = __fadd_rn(sj, pb);
        }
        const float tn = normalize(tj, mt[j], qmag);
        const float un = normalize(sj, mb[j], qmag);
        float sqd = 0.f;
        if (C1) {
          sqd = __fadd_rn(sqd, __fmul_rn(tp0, pr[j]));
        } else {
          const float* tpb = a.tp + b * a.tp_rs;
          const float* prd = a.pr + d * a.pr_ds;
          for (int c = 0; c < a.C; ++c)
            sqd = __fadd_rn(sqd, __fmul_rn(__ldg(tpb + c * a.tp_cs),
                                           __ldg(prd + c * a.pr_cs)));
        }
        const float blend = __fadd_rn(
            __fadd_rn(__fmul_rn(a.w_pr, sqd), __fmul_rn(a.w_t, tn)),
            __fmul_rn(a.w_b, un));
        if (cand) f[j] = __fmul_rn(blend, a.scale);
      }
    }
    __stcs(reinterpret_cast<float4*>(out + m * kChunk + lane * 4),
           make_float4(f[0], f[1], f[2], f[3]));
    float v = max_nan(max_nan(f[0], f[1]), max_nan(f[2], f[3]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) a.cmax[(long long)b * a.M + m] = v;
  }
}

template <bool HOT, bool COUNTS, bool PH, bool C1>
int launch_vec(const Args& a, bool vec, int blocks, cudaStream_t st) {
  if (vec)
    finalize_kernel<HOT, COUNTS, PH, C1, true><<<blocks, kThreads, 0, st>>>(a);
  else
    finalize_kernel<HOT, COUNTS, PH, C1, false><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool HOT, bool COUNTS, bool PH>
int launch_c(const Args& a, bool vec, int blocks, cudaStream_t st) {
  if (a.C == 1) return launch_vec<HOT, COUNTS, PH, true>(a, vec, blocks, st);
  return launch_vec<HOT, COUNTS, PH, false>(a, vec, blocks, st);
}

template <bool HOT, bool COUNTS>
int launch_ph(const Args& a, bool vec, int blocks, cudaStream_t st) {
  if (a.ph) return launch_c<HOT, COUNTS, true>(a, vec, blocks, st);
  return launch_c<HOT, COUNTS, false>(a, vec, blocks, st);
}

}  // namespace fin
}  // namespace ss

// Null hot, tc/bc (both or neither) and ph select the variants; strides
// are in elements. `vec` (the wrapper checked every row stream, the
// doc-long arrays and D for 16-byte float4 access) picks the float4 loads.
extern "C" int ss_finalize(
    const float* ts, long long ts_rs, const float* bs, long long bs_rs,
    const float* hot, long long hot_rs, const float* tc, long long tc_rs,
    const float* bc, long long bc_rs, const float* ph, long long ph_rs,
    long long ph_ds, long long ph_cs, const float* mag_t, const float* mag_b,
    const float* pr, long long pr_ds, long long pr_cs, int C,
    const float* qlen, const float* tp, long long tp_rs, long long tp_cs,
    float w_pr, float w_t, float w_b, float scale, int B, int D, int vec,
    float* out, float* cmax, void* stream) {
  using namespace ss::fin;
  if (B < 1 || D < 1 || C < 0 || (tc == nullptr) != (bc == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{ts, ts_rs, bs, bs_rs, hot, hot_rs, tc, tc_rs, bc, bc_rs,
         ph, ph_rs, ph_ds, ph_cs, mag_t, mag_b, pr, pr_ds, pr_cs, C,
         qlen, tp, tp_rs, tp_cs, w_pr, w_t, w_b, scale,
         B, D, (D + kChunk - 1) / kChunk, out, cmax};
  const long long blocks = (long long)((B + kWarps - 1) / kWarps) *
                           ((a.M + kChunks - 1) / kChunks);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  if (hot) {
    if (tc) return launch_ph<true, true>(a, v, (int)blocks, st);
    return launch_ph<true, false>(a, v, (int)blocks, st);
  }
  if (tc) return launch_ph<false, true>(a, v, (int)blocks, st);
  return launch_ph<false, false>(a, v, (int)blocks, st);
}
