"""K1: forward-membership keyword scoring, both sections in one pass, and
K3, its one-section entry point.

K1 is the counterpart of spaghettisearch_tpu/ops/kernels/membership.py
pallas_forward_scores_2sec, K3 of pallas_forward_scores (the custom-blend
route scores each section with it). For one query batch and each section:

    mult[b, d, j]  = #occurrences of ft[d, j] among query b's terms
    score[b, d]    = sum_j fw[d, j] * mult[b, d, j]
    count[b, d]    = sum_j mult[b, d, j]

`forward_scores_2sec` (K1) and `forward_scores` (K3) are the wrappers: on
CUDA tensors they launch the hand-written kernels (csrc/membership.cu) or
raise; on CPU tensors they run `plain_forward_scores_2sec` /
`plain_section_scores`, the plain PyTorch versions of the same functions
(the counterpart of the JAX package's XLA twin forward_section_scores,
doc-blocked). The plain versions are also the on-card references.

Layout: the index is passed transposed, ftT/fwT [T, D] (doc axis
contiguous), with each doc's real slots first and -1 pads after; query pads
are sentinels (>= n_words or int32 max) that never match. qn/qnb (active
term counts) and body_tmax (doc-sorted layout) only narrow the kernels'
work: terms past a row's count are sentinels and slots past a block's tmax
are pads, so the plain version, which ignores them, computes the same
result. Both kernels read their query terms through the probe tables of
probe.py: K1 through a title table (terms past qn leave it) and a body
table (past qnb), K3 through one table per row tile (terms past qn leave
it). Rows need no order and no padding.
"""

from __future__ import annotations

import ctypes

import torch

from . import probe

#: granularity of body_tmax (device_index DOC_BLOCK)
TMAX_BLOCK = 512
#: query term columns the kernels take (csrc/probe.cuh kQMax)
Q_MAX = 32

#: launches of the CUDA kernels since the last reset (each wrapper adds one
#: per launch and nowhere else): K1 (both sections) and K3 (one section)
LAUNCHES = 0
LAUNCHES_1SEC = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # title ftT, fwT, Tt
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # body ftT, fwT, Tb
    ctypes.c_int,  # D
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # term_ids, B, Q
    ctypes.c_void_p, ctypes.c_void_p,  # qn, qnb (either may be null)
    ctypes.c_void_p, ctypes.c_int,  # body_tmax, tmax_block
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table scratch, rows per tile, entries per tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outs
    ctypes.c_void_p,  # stream
]
_ARGTYPES_TABLES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # term_ids, B, Q
    ctypes.c_void_p, ctypes.c_void_p,  # qn, qnb
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ph_ids, ph_valid, P
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows, entries, sections
    ctypes.c_void_p,  # table scratch
    ctypes.c_void_p,  # stream
]
_ARGTYPES_1SEC = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # ftT, fwT, T, D
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # tq, B, Q, qn
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table scratch, rows per tile, entries per tile
    ctypes.c_void_p, ctypes.c_void_p,  # outs
    ctypes.c_void_p,  # stream
]


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_1SEC
    LAUNCHES = LAUNCHES_1SEC = 0


def library():
    """The built K1/K3 library (compiled on first use)."""
    from ._build import load_library

    built = load_library("membership")
    for fn, argtypes in (
        (built.lib.ss_membership2, _ARGTYPES), (built.lib.ss_membership1, _ARGTYPES_1SEC),
        (built.lib.ss_probe_tables, _ARGTYPES_TABLES),
    ):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return built


# --------------------------------------------------------------------- #
# plain PyTorch version
# --------------------------------------------------------------------- #


def plain_section_scores(
    ftT: torch.Tensor,  # int32 [T, D]
    fwT: torch.Tensor,  # f32 [T, D]
    term_ids: torch.Tensor,  # int32 [B, Q]
    n_blocks: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (score [B, D], count [B, D]); duplicate query terms count once
    per occurrence. Doc-blocked so the [B, T, Db] intermediates stay small."""
    t, d = ftT.shape
    b, q = term_ids.shape
    score = torch.zeros((b, d), dtype=torch.float32, device=ftT.device)
    count = torch.zeros_like(score)
    db = max(-(-d // n_blocks), 1)
    for d0 in range(0, d, db):
        ft = ftT[:, d0 : d0 + db]
        mult = torch.zeros((b, t, ft.shape[1]), dtype=torch.float32, device=ft.device)
        for qi in range(q):
            mult += (ft[None, :, :] == term_ids[:, qi, None, None]).float()
        score[:, d0 : d0 + db] = (mult * fwT[None, :, d0 : d0 + db]).sum(1)
        count[:, d0 : d0 + db] = mult.sum(1)
    return score, count


def plain_forward_scores_2sec(
    title_ftT, title_fwT, body_ftT, body_fwT, term_ids, qn=None, *,
    emit_counts: bool = True, qnb=None, body_tmax=None, n_blocks: int = 16,
):
    """The plain version of K1 (same contract as forward_scores_2sec)."""
    from ..scoring import mask_cold

    ts, tc = plain_section_scores(title_ftT, title_fwT, term_ids, n_blocks)
    bs, bc = plain_section_scores(
        body_ftT, body_fwT, mask_cold(term_ids, qnb), n_blocks
    )
    if not emit_counts:
        return ts, None, bs, None
    return ts, tc, bs, bc


# --------------------------------------------------------------------- #
# the kernel's wrapper
# --------------------------------------------------------------------- #


def _check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.dtype != dtype or t.dim() != ndim or t.device != device:
        raise ValueError(
            f"{name}: want {dtype} {ndim}-d on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _int32(x: torch.Tensor, name: str, b: int, device) -> torch.Tensor:
    """A [b] per-row count as the kernels read it: int32, contiguous."""
    if x.shape != (b,) or x.device != device:
        raise ValueError(f"{name}: want [{b}] on {device}, got {tuple(x.shape)} on {x.device}")
    return x.to(torch.int32).contiguous()


def forward_scores_2sec(
    title_ftT: torch.Tensor,  # int32 [Tt, D]
    title_fwT: torch.Tensor,  # f32 [Tt, D]
    body_ftT: torch.Tensor,  # int32 [Tb, D]
    body_fwT: torch.Tensor,  # f32 [Tb, D]
    term_ids: torch.Tensor,  # int32 [B, Q]
    qn: torch.Tensor | None = None,  # int32 [B] active term counts (sorted desc)
    *,
    emit_counts: bool = True,
    qnb: torch.Tensor | None = None,  # int32 [B] cold-term counts (hot split)
    body_tmax: torch.Tensor | None = None,  # int32 [D // 512] (doc-sorted)
):
    """-> (title score, title count, body score, body count), each [B, D];
    counts are None when emit_counts=False (candidacy <=> score > 0, valid
    iff every index weight is positive). With qnb the body sweep reads the
    cold slots only (mask_cold). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if term_ids.device.type == "cpu":
        return plain_forward_scores_2sec(
            title_ftT, title_fwT, body_ftT, body_fwT, term_ids, qn,
            emit_counts=emit_counts, qnb=qnb, body_tmax=body_tmax,
        )
    if term_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {term_ids.device}")
    dev = term_ids.device
    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    b, q = term_ids.shape
    for t, name, dt, nd in (
        (title_ftT, "title_ftT", torch.int32, 2), (title_fwT, "title_fwT", torch.float32, 2),
        (body_ftT, "body_ftT", torch.int32, 2), (body_fwT, "body_fwT", torch.float32, 2),
        (term_ids, "term_ids", torch.int32, 2),
    ):
        _check(t, name, dt, nd, dev)
    if title_fwT.shape != (tt, d) or body_fwT.shape != (tb, d) or body_ftT.shape[1] != d:
        raise ValueError("forward tiles disagree on [T, D]")
    if not 1 <= q <= Q_MAX:
        raise ValueError(f"Q={q} outside [1, {Q_MAX}]")
    if body_tmax is not None:
        _check(body_tmax, "body_tmax", torch.int32, 1, dev)
        if d % TMAX_BLOCK or body_tmax.shape[0] != d // TMAX_BLOCK:
            raise ValueError(f"body_tmax {tuple(body_tmax.shape)} vs D={d}")
    if qn is not None:
        qn = _int32(qn, "qn", b, dev)
    if qnb is not None:
        qnb = _int32(qnb, "qnb", b, dev)
    rows = probe.row_tile(b)
    n = rows * q
    tables = probe.scratch(b, rows, n, dev)
    n_out = 4 if emit_counts else 2
    outs = [torch.empty((b, d), dtype=torch.float32, device=dev) for _ in range(n_out)]
    if emit_counts:
        ts, tc, bs, bc = outs
    else:
        (ts, bs), tc, bc = outs, None, None
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_membership2(
            title_ftT.data_ptr(), title_fwT.data_ptr(), tt,
            body_ftT.data_ptr(), body_fwT.data_ptr(), tb, d,
            term_ids.data_ptr(), b, q,
            None if qn is None else qn.data_ptr(), None if qnb is None else qnb.data_ptr(),
            None if body_tmax is None else body_tmax.data_ptr(), TMAX_BLOCK,
            tables.data_ptr(), rows, n,
            ts.data_ptr(), None if tc is None else tc.data_ptr(),
            bs.data_ptr(), None if bc is None else bc.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"membership kernel launch failed (cudaError {err})")
    global LAUNCHES
    LAUNCHES += 1
    return ts, tc, bs, bc


def forward_scores(
    ftT: torch.Tensor,  # int32 [T, D]
    fwT: torch.Tensor,  # f32 [T, D]
    term_ids: torch.Tensor,  # int32 [B, Q]
    qn: torch.Tensor | None = None,  # int32 [B] active term counts
    *,
    emit_counts: bool = True,
):
    """K3: one section -> (score [B, D], count [B, D] | None). CPU tensors
    take the plain version; CUDA tensors launch the kernel (its table
    build, then the sweep)."""
    if term_ids.device.type == "cpu":
        score, count = plain_section_scores(ftT, fwT, term_ids)
        return score, (count if emit_counts else None)
    if term_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {term_ids.device}")
    dev = term_ids.device
    t, d = ftT.shape
    b, q = term_ids.shape
    _check(ftT, "ftT", torch.int32, 2, dev)
    _check(fwT, "fwT", torch.float32, 2, dev)
    _check(term_ids, "term_ids", torch.int32, 2, dev)
    if fwT.shape != (t, d):
        raise ValueError("forward tiles disagree on [T, D]")
    if not 1 <= q <= Q_MAX:
        raise ValueError(f"Q={q} outside [1, {Q_MAX}]")
    if qn is not None:
        qn = _int32(qn, "qn", b, dev)
    rows = probe.row_tile(b)
    n = rows * q
    tables = probe.scratch(b, rows, n, dev, sections=1)
    score = torch.empty((b, d), dtype=torch.float32, device=dev)
    count = torch.empty_like(score) if emit_counts else None
    lib = library().lib
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ss_membership1(
            ftT.data_ptr(), fwT.data_ptr(), t, d, term_ids.data_ptr(), b, q,
            None if qn is None else qn.data_ptr(), tables.data_ptr(), rows, n,
            score.data_ptr(), None if count is None else count.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"one-section membership kernel launch failed (cudaError {err})")
    global LAUNCHES_1SEC
    LAUNCHES_1SEC += 1
    return score, count
