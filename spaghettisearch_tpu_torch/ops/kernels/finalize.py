"""The rank's finalize in one pass (csrc/finalize.cu).

Everything between the membership kernel (K1, K2, K3 or the CSR scatter)
and the top-k's selection, for one query batch:

    bs      = bs + hot                              (hot: the hot fold's GEMM output)
    cand    = tc + bc (+ flag) (+ (hot > 0)) > 0    (counts given)
            | ts + bs > 0 | flag > 0                (counts elided)
    ts, bs  = ts + phrase title w, bs + phrase body w   (phrase: the sparse fold)
    final   = finalize_scores(...)                  cosine, NaN -> 0, sqd, blend, -inf mask
    cmax    = per-128-doc chunk maxima of final, padded with -inf

`finalize_chunked` is the wrapper: on CUDA tensors it launches the
hand-written kernel, on CPU tensors it runs `plain_finalize_chunked`, the
same chain as PyTorch passes (ops/scoring.py finalize_scores inside it),
which is also the on-card reference. Which inputs the caller passes (hot,
counts, phrase fold, topic categories) picks the kernel's variant. Each
call counts on TRACER as `scoring.finalize.kernel` or
`scoring.finalize.plain` (the other counter gains 0, so /stats shows both)
and runs inside TRACER.range("scoring.finalize").

Both routes return (final, cmax): final [B, D] is the first D columns of
a [B, M*CHUNK] buffer whose pad holds -inf (M = ceil(D / CHUNK)), cmax
[B, M] its chunk maxima; ops/scoring.py exact_top_k(final, k, cmax=cmax)
starts its chunk route from them.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SCORE_SCALE, W_BODY, W_PAGERANK, W_TITLE
from ...utils.timing import TRACER

#: docs of a chunk (csrc/finalize.cu kChunk; exact_top_k's default chunk)
CHUNK = 128
#: launches of the CUDA kernel since the last reset
LAUNCHES = 0
#: (w_pagerank, w_title, w_body, scale) of the reference formula
REFERENCE_BLEND = (W_PAGERANK, W_TITLE, W_BODY, SCORE_SCALE)

_P, _L, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ARGTYPES = [
    _P, _L, _P, _L,  # ts, bs and their row strides
    _P, _L,  # hot
    _P, _L, _P, _L,  # tc, bc
    _P, _L, _L, _L,  # phrase fold [B, D, 3] and its strides
    _P, _P,  # mag_title, mag_body
    _P, _L, _L, _I,  # pagerank [D, C], its strides, C
    _P, _P, _L, _L,  # query_len, topic_probs [B, C], its strides
    _F, _F, _F, _F,  # w_pagerank, w_title, w_body, scale
    _I, _I, _I,  # B, D, float4 loads
    _P, _P,  # out, cmax
    _P,  # stream
]


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def library():
    """The built finalize library (compiled on first use)."""
    from ._build import load_library

    built = load_library("finalize")
    fn = built.lib.ss_finalize
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return built


def _count(route: str) -> None:
    TRACER.count(f"scoring.finalize.{route}")
    TRACER.count("scoring.finalize." + ("plain" if route == "kernel" else "kernel"), 0)


def plain_finalize_chunked(
    ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs,
    weights=REFERENCE_BLEND, *, hot=None, phrase=None,
):
    """The plain version of the kernel (same contract as finalize_chunked):
    the PyTorch passes the lanes ran before the kernel, in their order."""
    from ..scoring import finalize_scores

    b, d = ts.shape
    if hot is not None:  # the hot fold's add; a hot-only doc is a candidate too
        with TRACER.range("scoring.hot"):
            hot = hot[:, :d]
            bs = bs + hot
            if bc is not None:
                bc = bc + (hot > 0).to(bs.dtype)
    with TRACER.range("scoring.counts"):
        if tc is None:  # counts elided: every weight > 0, candidacy <=> score > 0
            cand = ts + bs > 0
            if phrase is not None:
                cand = cand | (phrase[:, :, 2] > 0)
            tc = cand.to(ts.dtype)
            bc = torch.zeros_like(tc)
        elif phrase is not None:
            tc = tc + phrase[:, :, 2]
    if phrase is not None:
        with TRACER.range("scoring.fold"):
            ts = ts + phrase[:, :, 0]
            bs = bs + phrase[:, :, 1]
    final = finalize_scores(
        ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs, weights
    )
    pad = (-d) % CHUNK
    if pad:
        final = torch.nn.functional.pad(final, (0, pad), value=-float("inf"))
    cmax = final.view(b, -1, CHUNK).amax(dim=2)
    return final[:, :d], cmax


def _vec_ok(t: torch.Tensor | None) -> bool:
    """float4 access to every row: 16-byte aligned start and row stride."""
    return t is None or (t.data_ptr() % 16 == 0 and (t.dim() == 1 or t.stride(0) % 4 == 0))


def finalize_chunked(
    ts: torch.Tensor,  # f32 [B, D] title scores
    tc: torch.Tensor | None,  # f32 [B, D] title counts (None: counts elided)
    bs: torch.Tensor,  # f32 [B, D] body scores
    bc: torch.Tensor | None,  # f32 [B, D] body counts (None with tc)
    mag_title: torch.Tensor,  # f32 [D]
    mag_body: torch.Tensor,  # f32 [D]
    pagerank: torch.Tensor,  # f32 [D, C]
    query_len: torch.Tensor,  # f32 [B]
    topic_probs: torch.Tensor,  # f32 [B, C]
    weights=REFERENCE_BLEND,  # (w_pagerank, w_title, w_body, scale)
    *,
    hot: torch.Tensor | None = None,  # f32 [B, >= D] the hot GEMM's output, read in place
    phrase: torch.Tensor | None = None,  # f32 [B, D, 3] phrase fold (title w, body w, flag)
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (final [B, D] in a -inf padded [B, M*128] buffer, cmax [B, M]).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if (tc is None) != (bc is None):
        raise ValueError("tc and bc: both or neither")
    dev = ts.device
    if dev.type == "cpu":
        _count("plain")
        return plain_finalize_chunked(
            ts, tc, bs, bc, mag_title, mag_body, pagerank, query_len, topic_probs,
            weights, hot=hot, phrase=phrase,
        )
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    b, d = ts.shape
    c = pagerank.shape[1]
    # rows are read with stride 1 (the CSR route's counts are strided views)
    ts, bs, tc, bc, hot = (t if t is None or t.stride(-1) == 1 else t.contiguous()
                           for t in (ts, bs, tc, bc, hot))
    rows = {"ts": ts, "bs": bs, "tc": tc, "bc": bc, "hot": hot}
    for name, t in {**rows, "mag_title": mag_title, "mag_body": mag_body,
                    "pagerank": pagerank, "query_len": query_len,
                    "topic_probs": topic_probs, "phrase": phrase}.items():
        if t is not None and (t.dtype != torch.float32 or t.device != dev):
            raise ValueError(f"{name}: want float32 on {dev}, got {t.dtype} on {t.device}")
    for name, t in rows.items():
        if t is None:
            continue
        if t.dim() != 2 or t.shape[0] != b or not (
            t.shape[1] >= d if name == "hot" else t.shape[1] == d
        ):
            raise ValueError(f"{name}: want [{b}, {d}] ([{b}, >= {d}] for hot), got "
                             f"{tuple(t.shape)}")
    if phrase is not None and (phrase.dim() != 3 or phrase.shape != (b, d, 3)):
        raise ValueError(f"phrase: want [{b}, {d}, 3], got {tuple(phrase.shape)}")
    if pagerank.dim() != 2 or pagerank.shape[0] != d or topic_probs.shape != (b, c):
        raise ValueError("pagerank [D, C] and topic_probs [B, C] disagree")
    mag_title, mag_body, query_len = (
        t.contiguous() for t in (mag_title, mag_body, query_len)
    )
    if mag_title.shape != (d,) or mag_body.shape != (d,) or query_len.shape != (b,):
        raise ValueError("mag_title, mag_body [D] or query_len [B] disagree")
    if c == 1 and pagerank.stride(0) != 1:
        pagerank = pagerank.contiguous()
    m = -(-d // CHUNK)
    out = torch.empty((b, m * CHUNK), dtype=torch.float32, device=dev)
    cmax = torch.empty((b, m), dtype=torch.float32, device=dev)
    vec = d % 4 == 0 and all(_vec_ok(t) for t in (*rows.values(), mag_title, mag_body))
    vec = vec and (c != 1 or _vec_ok(pagerank[:, 0]))
    w_pr, w_title, w_body, scale = weights
    ph_strides = phrase.stride() if phrase is not None else (0, 0, 0)

    def ptr(t):
        return None if t is None else t.data_ptr()

    def rs(t):
        return 0 if t is None else t.stride(0)

    lib = library().lib
    with TRACER.range("scoring.finalize"), torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_finalize(
            ts.data_ptr(), ts.stride(0), bs.data_ptr(), bs.stride(0),
            ptr(hot), rs(hot), ptr(tc), rs(tc), ptr(bc), rs(bc), ptr(phrase), *ph_strides,
            mag_title.data_ptr(), mag_body.data_ptr(),
            pagerank.data_ptr(), pagerank.stride(0), pagerank.stride(1), c,
            query_len.data_ptr(), topic_probs.data_ptr(),
            topic_probs.stride(0), topic_probs.stride(1),
            w_pr, w_title, w_body, scale, b, d, int(vec),
            out.data_ptr(), cmax.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"finalize kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    _count("kernel")
    return out[:, :d], cmax
