"""K4: both sections' membership scoring + score finalization in one pass.

The counterpart of spaghettisearch_tpu/ops/kernels/fused.py
pallas_fused_final_scores. For one query batch:

    per section s: score_s, count_s as K1 (all Q terms, no hot split)
    sqd[b, d]   = topic_probs[b] . pagerankT[:, d]
    norm_s      = score_s / (mag_s[d] * sqrt(qlen[b]))     (NaN -> 0, +inf kept)
    final[b, d] = (0.33*sqd + 0.38*norm_title + 0.29*norm_body) * 100
    final       = -inf where count_title + count_body == 0

`fused_final_scores` is the wrapper: on CUDA tensors it launches the
hand-written kernel (csrc/fused.cu: the build of one probe table per row
tile, probe.py, then both sections' sweeps against it and the finalize) or
raises; on CPU tensors it runs `plain_fused_final_scores` (two plain
section sweeps + finalize_scores), which is also the on-card reference.
Production keeps the unfused keyword path (models/blended.py);
ops/scoring.py score_queries_fused drives this one.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SCORE_SCALE, W_BODY, W_PAGERANK, W_TITLE
from . import probe
from .membership import Q_MAX, _check, plain_section_scores

#: topic categories the kernel takes (csrc/fused.cu kCMax)
C_MAX = 64

#: launches of the CUDA kernel since the last reset
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # title ftT, fwT, Tt
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # body ftT, fwT, Tb
    ctypes.c_int,  # D
    ctypes.c_void_p, ctypes.c_void_p,  # mag_title, mag_body
    ctypes.c_void_p, ctypes.c_int,  # pagerankT, C
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # tq, B, Q
    ctypes.c_void_p, ctypes.c_void_p,  # query_len, topic_probs
    ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,  # blend
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table scratch, rows per tile, entries per tile
    ctypes.c_void_p,  # out
    ctypes.c_void_p,  # stream
]


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def library():
    """The built K4 library (compiled on first use)."""
    from ._build import load_library

    built = load_library("fused")
    fn = built.lib.ss_fused
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return built


def plain_fused_final_scores(
    title_ftT, title_fwT, body_ftT, body_fwT, mag_title, mag_body, pagerankT,
    term_ids, query_len, topic_probs,
):
    """The plain version of K4 (same contract as fused_final_scores)."""
    from ..scoring import finalize_scores

    ts, tc = plain_section_scores(title_ftT, title_fwT, term_ids)
    bs, bc = plain_section_scores(body_ftT, body_fwT, term_ids)
    return finalize_scores(
        ts, tc, bs, bc, mag_title, mag_body, pagerankT.T, query_len, topic_probs
    )


def fused_final_scores(
    title_ftT: torch.Tensor,  # int32 [Tt, D]
    title_fwT: torch.Tensor,  # f32 [Tt, D]
    body_ftT: torch.Tensor,  # int32 [Tb, D]
    body_fwT: torch.Tensor,  # f32 [Tb, D]
    mag_title: torch.Tensor,  # f32 [D]
    mag_body: torch.Tensor,  # f32 [D]
    pagerankT: torch.Tensor,  # f32 [C, D]
    term_ids: torch.Tensor,  # int32 [B, Q]
    query_len: torch.Tensor,  # f32 [B]
    topic_probs: torch.Tensor,  # f32 [B, C]
) -> torch.Tensor:
    """-> final [B, D] blended scores (-inf for non-candidates). Every
    column of term_ids is read (negative ids and int32 max never match).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if term_ids.device.type == "cpu":
        return plain_fused_final_scores(
            title_ftT, title_fwT, body_ftT, body_fwT, mag_title, mag_body,
            pagerankT, term_ids, query_len, topic_probs,
        )
    if term_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {term_ids.device}")
    dev = term_ids.device
    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    b, q = term_ids.shape
    c = pagerankT.shape[0]
    for t, name, dt, nd in (
        (title_ftT, "title_ftT", torch.int32, 2), (title_fwT, "title_fwT", torch.float32, 2),
        (body_ftT, "body_ftT", torch.int32, 2), (body_fwT, "body_fwT", torch.float32, 2),
        (mag_title, "mag_title", torch.float32, 1), (mag_body, "mag_body", torch.float32, 1),
        (pagerankT, "pagerankT", torch.float32, 2), (term_ids, "term_ids", torch.int32, 2),
        (query_len, "query_len", torch.float32, 1), (topic_probs, "topic_probs", torch.float32, 2),
    ):
        _check(t, name, dt, nd, dev)
    if (
        title_fwT.shape != (tt, d) or body_fwT.shape != (tb, d) or body_ftT.shape[1] != d
        or mag_title.shape != (d,) or mag_body.shape != (d,) or pagerankT.shape[1] != d
    ):
        raise ValueError("index arrays disagree on D")
    if query_len.shape != (b,) or topic_probs.shape != (b, c):
        raise ValueError("query rows disagree on [B, C]")
    if not 1 <= q <= Q_MAX:
        raise ValueError(f"Q={q} outside [1, {Q_MAX}]")
    if not 1 <= c <= C_MAX:
        raise ValueError(f"C={c} topic categories outside [1, {C_MAX}]")
    rows = probe.row_tile(b)
    n = rows * q
    tables = probe.scratch(b, rows, n, dev, sections=1)
    out = torch.empty((b, d), dtype=torch.float32, device=dev)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_fused(
            title_ftT.data_ptr(), title_fwT.data_ptr(), tt,
            body_ftT.data_ptr(), body_fwT.data_ptr(), tb, d,
            mag_title.data_ptr(), mag_body.data_ptr(), pagerankT.data_ptr(), c,
            term_ids.data_ptr(), b, q, query_len.data_ptr(), topic_probs.data_ptr(),
            W_PAGERANK, W_TITLE, W_BODY, SCORE_SCALE, tables.data_ptr(), rows, n,
            out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    return out
