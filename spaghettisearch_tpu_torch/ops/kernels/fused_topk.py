"""K5: both sections' membership scoring, a finalize and an exact top-k in
one kernel pair, so the [B, D] score matrix never exists.

The counterpart of experiments/fused2_probe.py build_kernel, the TPU
prototype of a fused scorer (which never compiled on the TPU). It computes
that prototype's function, not the production blend:

    ts, tc = the title's membership score and count (all Q terms; a term
             given twice counts twice)        bs, bc likewise for the body
    tn     = ts / (mag_title[d] * sqrt(qlen[b]))   NaN -> 0, x/0 stays inf
    final  = (0.38 * tn + 0.29 * bn) * 100,  -inf where tc + bc == 0
    -> the k_pad largest finals per row, descending, equal values by
       ascending doc id; slots past the row's candidates hold -inf, id 0

`fused_topk` is the wrapper: on CUDA tensors it launches the hand-written
kernels (csrc/fused_topk.cu: K4's probe table per row tile, a sweep and
per-block top-k into partials, which share each row's running k-th value
as a threshold, then a merge) or raises; on CPU tensors it runs `plain_fused_topk`, the plain
PyTorch version (two plain section sweeps, the finalize above,
ops/scoring.py's lowest-index top-k), which is also the on-card reference.
Doc ids are positions of the index's doc axis (permuted ids under the
doc-sorted layout), as the prototype returns them. `chunks_per_block`
plans the launch (host logic the CPU tests reach).
"""

from __future__ import annotations

import ctypes

import torch

from ...config import SCORE_SCALE, W_BODY, W_TITLE
from . import probe
from .membership import Q_MAX, _check, plain_section_scores

#: rows of a row tile (at most probe.ROWS_MAX): two [R, 128] f32 sum arrays
#: per block, 5 blocks per SM at 32
ROWS = 32
#: docs of a chunk, one per thread (csrc/probe.cuh kDocs)
DOCS = 128
#: list length the kernel holds (one entry per lane: csrc/fused_topk.cu kKMax)
K_MAX = 32

#: launches of the CUDA kernels (sweep + merge, one call) since the last reset
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # title ftT, fwT, Tt
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # body ftT, fwT, Tb
    ctypes.c_int,  # D
    ctypes.c_void_p, ctypes.c_void_p,  # mag_title, mag_body
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # tq, B, Q
    ctypes.c_void_p,  # query_len
    ctypes.c_float, ctypes.c_float, ctypes.c_float,  # title weight, body weight, scale
    ctypes.c_int, ctypes.c_int,  # k_pad, chunks per block
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table scratch, rows per tile, entries per tile
    ctypes.c_void_p,  # thresholds [B]
    ctypes.c_void_p, ctypes.c_void_p,  # partial values, ids
    ctypes.c_void_p, ctypes.c_void_p,  # out values, ids
    ctypes.c_void_p,  # stream
]


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def library():
    """The built K5 library (compiled on first use)."""
    from ._build import load_library

    built = load_library("fused_topk")
    fn = built.lib.ss_fused_topk
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return built


def prototype_final(ts, tc, bs, bc, mag_title, mag_body, query_len):
    """The prototype's finalize -> final [B, D] (-inf off the candidates)."""
    qmag = torch.sqrt(query_len)[:, None]
    tn = ts / (mag_title[None, :] * qmag)
    bn = bs / (mag_body[None, :] * qmag)
    tn = torch.where(torch.isnan(tn), 0.0, tn)
    bn = torch.where(torch.isnan(bn), 0.0, bn)
    final = (W_TITLE * tn + W_BODY * bn) * SCORE_SCALE  # the prototype's 0.38, 0.29, 100
    return torch.where(tc + bc > 0, final, -float("inf"))


def plain_fused_topk(
    title_ftT, title_fwT, body_ftT, body_fwT, mag_title, mag_body, term_ids, query_len,
    k_pad: int = 16,
):
    """The plain version of K5 (same contract as fused_topk)."""
    from ..scoring import _top_k_lowest_index

    ts, tc = plain_section_scores(title_ftT, title_fwT, term_ids)
    bs, bc = plain_section_scores(body_ftT, body_fwT, term_ids)
    final = prototype_final(ts, tc, bs, bc, mag_title, mag_body, query_len)
    b, d = final.shape
    vals, ids = _top_k_lowest_index(final, min(k_pad, d))
    if k_pad > d:
        vals = torch.nn.functional.pad(vals, (0, k_pad - d), value=-float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k_pad - d))
    ids = torch.where(vals == -float("inf"), 0, ids).to(torch.int32)
    return vals, ids


def chunks_per_block(d: int, b: int, rows: int, sms: int) -> int:
    """128-doc chunks each block sweeps: enough blocks for about two waves
    of 5 resident blocks per SM, and no more partials than that needs."""
    blocks = -(-d // DOCS) * -(-b // rows)
    return max(1, min(64, -(-blocks // (10 * sms))))


def fused_topk(
    title_ftT: torch.Tensor,  # int32 [Tt, D]
    title_fwT: torch.Tensor,  # f32 [Tt, D]
    body_ftT: torch.Tensor,  # int32 [Tb, D]
    body_fwT: torch.Tensor,  # f32 [Tb, D]
    mag_title: torch.Tensor,  # f32 [D]
    mag_body: torch.Tensor,  # f32 [D]
    term_ids: torch.Tensor,  # int32 [B, Q] (ids >= 0; sentinels never match)
    query_len: torch.Tensor,  # f32 [B]
    k_pad: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (values f32 [B, k_pad], doc ids int32 [B, k_pad]). CPU tensors
    take the plain version; CUDA tensors launch the kernels."""
    if term_ids.device.type == "cpu":
        return plain_fused_topk(title_ftT, title_fwT, body_ftT, body_fwT, mag_title,
                                mag_body, term_ids, query_len, k_pad)
    if term_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {term_ids.device}")
    dev = term_ids.device
    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    b, q = term_ids.shape
    for t, name, dt, nd in (
        (title_ftT, "title_ftT", torch.int32, 2), (title_fwT, "title_fwT", torch.float32, 2),
        (body_ftT, "body_ftT", torch.int32, 2), (body_fwT, "body_fwT", torch.float32, 2),
        (mag_title, "mag_title", torch.float32, 1), (mag_body, "mag_body", torch.float32, 1),
        (term_ids, "term_ids", torch.int32, 2), (query_len, "query_len", torch.float32, 1),
    ):
        _check(t, name, dt, nd, dev)
    if title_fwT.shape != (tt, d) or body_fwT.shape != (tb, d) or body_ftT.shape[1] != d:
        raise ValueError("forward tiles disagree on [T, D]")
    if mag_title.shape != (d,) or mag_body.shape != (d,) or query_len.shape != (b,):
        raise ValueError("mags or query_len disagree with [B, D]")
    if not 1 <= q <= Q_MAX:
        raise ValueError(f"Q={q} outside [1, {Q_MAX}]")
    if not 1 <= k_pad <= K_MAX:
        raise ValueError(f"k_pad={k_pad} outside [1, {K_MAX}]")
    rows = min(b, ROWS)
    n = rows * q
    tables = probe.scratch(b, rows, n, dev, sections=1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunks = chunks_per_block(d, b, rows, sms)
    n_chunks = -(-d // DOCS)
    n_parts = -(-n_chunks // chunks)  # blocks along the doc axis
    thr = torch.empty(b, dtype=torch.int32, device=dev)
    part_v = torch.empty((n_parts, b, k_pad), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_parts, b, k_pad), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k_pad), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k_pad), dtype=torch.int32, device=dev)
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_fused_topk(
            title_ftT.data_ptr(), title_fwT.data_ptr(), tt,
            body_ftT.data_ptr(), body_fwT.data_ptr(), tb, d,
            mag_title.data_ptr(), mag_body.data_ptr(),
            term_ids.data_ptr(), b, q, query_len.data_ptr(), W_TITLE, W_BODY, SCORE_SCALE,
            k_pad, chunks,
            tables.data_ptr(), rows, n, thr.data_ptr(), part_v.data_ptr(), part_i.data_ptr(),
            vals.data_ptr(), ids.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused top-k kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    return vals, ids
