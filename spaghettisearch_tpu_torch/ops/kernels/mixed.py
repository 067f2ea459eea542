"""K2: fused keyword + dense phrase scoring (the mixed lane).

The counterpart of spaghettisearch_tpu/ops/kernels/mixed.py
pallas_mixed_scores_2sec. It computes K1's keyword scores for both sections
and folds in phrase matches found in the doc-major position planes

    posT[c*T + t, d] = c-th UNIQUE position of doc d's term slot t, POS_BIG pad

with the reference semantics (retrieval/phrase.go:53-109 +
main_retrieve.go:62-78), exactly as the JAX package's kernel and twin:
  - a doc matches only if EVERY phrase term occurs in title OR body;
  - the title contributes sum(term title weights) only when every term has
    a title entry and the title positional chain holds; body likewise;
  - chain: some position of term 0 such that term i occurs at pos0 + i;
  - a single-term phrase matches wherever the term occurs (sentinel -100
    anchor/meta positions included);
  - phrase-matched docs are candidates even with zero keyword overlap.

`mixed_scores_2sec` is the wrapper: on CUDA tensors it launches the
hand-written kernel (csrc/mixed.cu) or raises; on CPU tensors it runs
`plain_mixed_scores`, the plain PyTorch version (the counterpart of the
JAX package's XLA twin mixed_forward_scores, doc-blocked), which is also
the on-card reference. The kernel reads keyword and phrase terms through
one probe table per section (probe.py build_tables).

body_tmax and tmax_stage (the doc-sorted layout's per-512-doc-block slot
bound, the JAX kernel's parameters of the same names) only narrow the
kernel's work: slots past a block's tmax are pads, so the plain version,
which ignores them, computes the same result, and the kernel with a bound
gives its unbounded results bit for bit. "kw" bounds the kernel's one
sweep of the body slots (keyword and phrase hits together), "phrase" the
rescan of a doc's body slots after its phrase-hit log overflowed, "both"
both (csrc/mixed.cu says why these are the two loops here).

Value-domain invariants (shared with the JAX package): real positions are
-100 or in [0, POS_REAL_MAX); the pad is POS_BIG (finite, exactly
representable in f32); an absent (doc, term) selects position 0.0, which is
only compared where the all-terms-found requirement masks it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import probe
from .membership import Q_MAX, TMAX_BLOCK, _check, _int32, plain_section_scores

#: pad value for absent position slots (see the module docstring)
POS_BIG = float(1 << 24)
#: everything below this is a real position
POS_REAL_MAX = float(1 << 23)
#: int16 plane encoding: POS16_PAD encodes POS_BIG, every real value
#: (-100 included) round-trips exactly; planes with a real position beyond
#: POS16_MAX keep f32
POS16_PAD = 32767
POS16_MAX = 32000.0
#: kernel limits (csrc/mixed.cu kPMax, kCMax)
P_MAX = 16
C_MAX = 32

#: tmax_stage -> the loops body_tmax bounds (csrc/mixed.cu kTmaxSweep = 1,
#: kTmaxRescan = 2)
TMAX_STAGES = {"kw": 1, "phrase": 2, "both": 3}

#: launches of the CUDA kernel since the last reset, and of those the ones
#: with the body bound (body_tmax)
LAUNCHES = 0
LAUNCHES_TMAX = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # title ftT, fwT, Tt
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # body ftT, fwT, Tb
    ctypes.c_int,  # D
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # title posT, Ct, int16?
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # body posT, Cb, int16?
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # term_ids, B, Q
    ctypes.c_void_p, ctypes.c_void_p,  # qn, qnb (qnb may be null)
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # ph_ids, ph_valid, P
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # body_tmax, tmax_block, stage mask
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # table scratch, rows per tile, entries per tile
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outs
    ctypes.c_void_p,  # stream
]


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_TMAX
    LAUNCHES = LAUNCHES_TMAX = 0


def library():
    """The built K2 library (compiled on first use)."""
    from ._build import load_library

    built = load_library("mixed")
    fn = built.lib.ss_mixed
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return built


def quantize_posT(posT_np):
    """Host-side int16 encoding of a doc-major position plane ([C*T, D]
    f32, values in {-100} ∪ [0, POS16_MAX] ∪ {POS_BIG}); None when some
    real position is too large to encode. Chunked to bound transients."""
    if posT_np.size == 0:
        return posT_np.astype(np.int16)
    mx = float(
        posT_np.max(initial=-100.0, where=posT_np < POS_REAL_MAX)
    )
    if mx > POS16_MAX:
        return None
    out = np.empty(posT_np.shape, np.int16)
    rows = posT_np.shape[0]
    step = max(1, (64 << 20) // max(posT_np.shape[1] * 4, 1))
    for r0 in range(0, rows, step):
        blk = posT_np[r0 : r0 + step]
        np.copyto(
            out[r0 : r0 + step],
            np.where(blk >= POS_REAL_MAX, np.float32(POS16_PAD), blk).astype(
                np.int16
            ),
        )
    return out


def deq_posT(x: torch.Tensor) -> torch.Tensor:
    """int16 plane -> the exact f32 plane (identity on f32): upcast + one
    select mapping POS16_PAD -> POS_BIG, as the kernel does per load."""
    if x.dtype != torch.int16:
        return x
    xf = x.float()
    return torch.where(xf >= float(POS16_PAD), torch.full_like(xf, POS_BIG), xf)


# --------------------------------------------------------------------- #
# plain PyTorch version
# --------------------------------------------------------------------- #


def plain_mixed_scores(
    title_ftT, title_fwT, body_ftT, body_fwT,  # [T, D]
    title_posT, body_posT,  # [C*T, D] f32 or int16
    term_ids,  # int32 [B, Q]
    ph_ids,  # int32 [B, P]
    ph_valid,  # f32 [B, P]
    qnb=None,  # int32 [B] cold-term counts (hot split; cold slots first)
    n_blocks: int = 16,
):
    """-> (ts, tc, bs, bc) each [B, D], phrase folded in; counts add the
    phrase candidacy flag."""
    from ..scoring import mask_cold

    ts, tc = plain_section_scores(title_ftT, title_fwT, term_ids, n_blocks)
    bs, bc = plain_section_scores(body_ftT, body_fwT, mask_cold(term_ids, qnb), n_blocks)
    add_t, add_b, flag = plain_phrase_delta(
        title_ftT, title_fwT, body_ftT, body_fwT, title_posT, body_posT,
        ph_ids, ph_valid, emit_flag=True, n_blocks=n_blocks,
    )
    return ts + add_t, tc + flag, bs + add_b, bc


def plain_phrase_delta(
    title_ftT, title_fwT, body_ftT, body_fwT,  # [T, D]
    title_posT, body_posT,  # [C*T, D] f32 or int16
    ph_ids,  # int32 [B, P]
    ph_valid,  # f32 [B, P]
    pn=None,  # int32 [B] active phrase slots: not needed (see below)
    *,
    emit_flag: bool = False,
    n_blocks: int = 16,
):
    """The phrase half of the mixed lane alone (K6's plain version) ->
    (add_t, add_b, flag | None), each f32 [B, D]: a section's add is the
    sum of the row's valid phrase-term weights there where the section
    holds every valid term and the chain holds, else 0; flag is 1 where
    either section matched. Valid slots are read from ph_valid (pn, which
    counts them, only narrows the kernels' work)."""
    tpos_all = deq_posT(title_posT)
    bpos_all = deq_posT(body_posT)
    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    ct = tpos_all.shape[0] // tt
    cb = bpos_all.shape[0] // tb
    dev = title_ftT.device
    add_t = torch.zeros((ph_ids.shape[0], d), dtype=torch.float32, device=dev)
    add_b = torch.zeros_like(add_t)
    flag = torch.zeros_like(add_t) if emit_flag else None
    # only rows whose slot 0 is valid hold a phrase, and slots past the last
    # valid one of every row constrain nothing: both cuts are exact
    valid = ph_valid > 0.0  # [B, P]
    rows = valid[:, 0].nonzero().flatten()
    if rows.numel() == 0:
        return add_t, add_b, flag
    p = int(valid.any(0).nonzero().max()) + 1
    ph_ids, valid = ph_ids[rows, :p], valid[rows, :p]
    b = rows.numel()
    db = max(-(-d // n_blocks), 1)

    def term(ft, fw, pos, pid):  # ft/fw [T, Db], pos [C, T, Db], pid [B]
        eqf = (ft[None, :, :] == pid[:, None, None]).float()  # [B, T, Db]
        w = (eqf * fw[None]).sum(1)  # [B, Db]
        found = eqf.sum(1) > 0.0
        sel = torch.einsum("btd,ctd->bdc", eqf, pos)  # [B, Db, C]
        return found, w, sel

    for d0 in range(0, d, db):
        d1 = min(d0 + db, d)
        n = d1 - d0
        tft, tfw = title_ftT[:, d0:d1], title_fwT[:, d0:d1]
        bft, bfw = body_ftT[:, d0:d1], body_fwT[:, d0:d1]
        tpos = tpos_all[:, d0:d1].reshape(ct, tt, n)
        bpos = bpos_all[:, d0:d1].reshape(cb, tb, n)
        present = torch.ones((b, n), dtype=torch.bool, device=dev)
        t_all = present.clone()
        b_all = present.clone()
        sum_tw = torch.zeros((b, n), dtype=torch.float32, device=dev)
        sum_bw = torch.zeros_like(sum_tw)
        anchor_t = anchor_b = hit_t = hit_b = None
        for pi in range(p):
            v = valid[:, pi][:, None]
            tf_found, tw, tsel = term(tft, tfw, tpos, ph_ids[:, pi])
            bf_found, bw, bsel = term(bft, bfw, bpos, ph_ids[:, pi])
            tf_eff = tf_found | ~v
            bf_eff = bf_found | ~v
            present &= tf_eff | bf_eff
            t_all &= tf_eff
            b_all &= bf_eff
            sum_tw += torch.where(v, tw, 0.0)
            sum_bw += torch.where(v, bw, 0.0)
            if pi == 0:
                anchor_t, anchor_b = tsel, bsel
                hit_t = anchor_t < POS_REAL_MAX  # [B, Db, C]
                hit_b = anchor_b < POS_REAL_MAX
            else:
                fp = float(pi)
                m_t = (tsel[:, :, None, :] == anchor_t[:, :, :, None] + fp).any(-1)
                m_b = (bsel[:, :, None, :] == anchor_b[:, :, :, None] + fp).any(-1)
                hit_t &= m_t | ~v[..., None]
                hit_b &= m_b | ~v[..., None]
        t_ok = present & t_all & hit_t.any(-1)
        b_ok = present & b_all & hit_b.any(-1)
        add_t[rows, d0:d1] = torch.where(t_ok, sum_tw, 0.0)
        add_b[rows, d0:d1] = torch.where(b_ok, sum_bw, 0.0)
        if emit_flag:
            flag[rows, d0:d1] = (t_ok | b_ok).float()
    return add_t, add_b, flag


# --------------------------------------------------------------------- #
# the kernel's wrapper
# --------------------------------------------------------------------- #


def mixed_scores_2sec(
    title_ftT, title_fwT, body_ftT, body_fwT,  # [T, D] int32 / f32
    title_posT, body_posT,  # [C*T, D] f32 or int16 (quantize_posT planes)
    term_ids,  # int32 [B, Q]
    qn,  # int32 [B] active keyword slots
    ph_ids,  # int32 [B, P] (sentinel pad)
    ph_valid,  # f32 [B, P] 1/0
    pn,  # int32 [B] active phrase slots (0 = keyword-only row)
    *,
    emit_counts: bool = True,
    qnb=None,  # int32 [B] cold-term counts (hot split)
    body_tmax=None,  # int32 [D // 512] (doc-sorted layout)
    tmax_stage: str = "kw",  # the loops body_tmax bounds: "kw", "phrase", "both"
):
    """-> (title score, title count, body score, body count), each [B, D],
    phrase weights/candidacy folded in (counts None when emit_counts=False:
    candidacy <=> score > 0, valid iff every index weight is positive). The
    valid phrase slots are read from ph_valid; pn, like the plain version,
    the kernel does not need. body_tmax bounds the body loops tmax_stage
    names (the module docstring); it is read at 512 docs, as K1 reads it.
    The JAX kernel's tc, its Mosaic chunk of body slot rows, has no
    counterpart: a thread here walks its own doc's slots, so there are no
    chunks to size. CPU tensors take the plain version (which needs no
    bound); CUDA tensors launch the kernel."""
    d = title_ftT.shape[1]
    if tmax_stage not in TMAX_STAGES:
        raise ValueError(f"tmax_stage {tmax_stage!r}: one of {sorted(TMAX_STAGES)}")
    if body_tmax is not None:
        _check(body_tmax, "body_tmax", torch.int32, 1, term_ids.device)
        if d % TMAX_BLOCK or body_tmax.shape[0] != d // TMAX_BLOCK:
            raise ValueError(f"body_tmax {tuple(body_tmax.shape)} vs D={d}")
    if term_ids.device.type == "cpu":
        ts, tc, bs, bc = plain_mixed_scores(
            title_ftT, title_fwT, body_ftT, body_fwT, title_posT, body_posT,
            term_ids, ph_ids, ph_valid, qnb=qnb,
        )
        return (ts, tc, bs, bc) if emit_counts else (ts, None, bs, None)
    if term_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {term_ids.device}")
    dev = term_ids.device
    tt, d = title_ftT.shape
    tb = body_ftT.shape[0]
    b, q = term_ids.shape
    p = ph_ids.shape[1]
    for t, name, dt, nd in (
        (title_ftT, "title_ftT", torch.int32, 2), (title_fwT, "title_fwT", torch.float32, 2),
        (body_ftT, "body_ftT", torch.int32, 2), (body_fwT, "body_fwT", torch.float32, 2),
        (term_ids, "term_ids", torch.int32, 2), (ph_ids, "ph_ids", torch.int32, 2),
        (ph_valid, "ph_valid", torch.float32, 2),
        (title_posT, "title_posT", title_posT.dtype, 2),
        (body_posT, "body_posT", body_posT.dtype, 2),
    ):
        _check(t, name, dt, nd, dev)
    for pos, name, tsec in ((title_posT, "title_posT", tt), (body_posT, "body_posT", tb)):
        if pos.dtype not in (torch.int16, torch.float32):
            raise ValueError(f"{name}: int16 or float32 planes, got {pos.dtype}")
        if pos.shape[1] != d or pos.shape[0] % tsec or not 1 <= pos.shape[0] // tsec <= C_MAX:
            raise ValueError(f"{name} {tuple(pos.shape)} vs T={tsec}, D={d}")
    if title_fwT.shape != (tt, d) or body_fwT.shape != (tb, d) or body_ftT.shape[1] != d:
        raise ValueError("forward tiles disagree on [T, D]")
    if not 1 <= q <= Q_MAX or not 1 <= p <= P_MAX or ph_valid.shape != (b, p):
        raise ValueError(f"Q={q} / P={p} outside the kernel's limits")
    if max(tt, tb) > 0x7FFF:
        raise ValueError(f"T={max(tt, tb)} past the kernel's slot log (32767)")
    qn = _int32(qn, "qn", b, dev)
    qnb = None if qnb is None else _int32(qnb, "qnb", b, dev)
    rows = probe.row_tile(b)
    n = rows * (q + p)
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
        err = lib.ss_mixed(
            title_ftT.data_ptr(), title_fwT.data_ptr(), tt,
            body_ftT.data_ptr(), body_fwT.data_ptr(), tb, d,
            title_posT.data_ptr(), title_posT.shape[0] // tt,
            int(title_posT.dtype == torch.int16),
            body_posT.data_ptr(), body_posT.shape[0] // tb,
            int(body_posT.dtype == torch.int16),
            term_ids.data_ptr(), b, q, qn.data_ptr(),
            None if qnb is None else qnb.data_ptr(),
            ph_ids.data_ptr(), ph_valid.data_ptr(), p,
            None if body_tmax is None else body_tmax.data_ptr(), TMAX_BLOCK,
            TMAX_STAGES[tmax_stage],
            tables.data_ptr(), rows, n,
            ts.data_ptr(), None if tc is None else tc.data_ptr(),
            bs.data_ptr(), None if bc is None else bc.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"mixed kernel launch failed (cudaError {err})")
    global LAUNCHES, LAUNCHES_TMAX
    LAUNCHES += 1
    LAUNCHES_TMAX += body_tmax is not None
    return ts, tc, bs, bc


def mixed_scores_padded(
    title_ftT, title_fwT, body_ftT, body_fwT, title_posT, body_posT,
    term_ids, qn, ph_ids, ph_valid, pn,
    *, emit_counts: bool = True, qnb=None, derive: bool = True,
    body_tmax=None, tmax_stage: str = "kw",
):
    """Run the mixed scorer on any batch size (the wrapper row-pads to the
    kernel's 8-row blocks and slices back) and derive candidacy counts when
    elided. The single pad/dispatch contract of the mixed lane, as in the
    JAX package. body_tmax stays at
    the index's 512-doc blocks (the JAX package repeats it down to its
    256-doc grid; this kernel reads it per warp, as K1 does)."""
    b = term_ids.shape[0]
    if qn is None:
        qn = torch.full((b,), term_ids.shape[1], dtype=torch.int32, device=term_ids.device)
    ts, tc, bs, bc = mixed_scores_2sec(
        title_ftT, title_fwT, body_ftT, body_fwT, title_posT, body_posT,
        term_ids, qn, ph_ids, ph_valid, pn, emit_counts=emit_counts, qnb=qnb,
        body_tmax=body_tmax, tmax_stage=tmax_stage,
    )
    if not derive:  # caller folds hot-term scores first, then derives
        return ts, tc, bs, bc
    return derive_mixed_counts(ts, tc, bs, bc)


def derive_mixed_counts(ts, tc, bs, bc):
    """Fill in the candidacy counts the count-elided variant drops: valid
    iff every index weight is positive — then candidacy <=> score > 0, and
    the title count carries the whole flag (finalize sums tc + bc)."""
    if tc is None:
        tc = (ts + bs > 0).to(ts.dtype)
        bc = torch.zeros_like(tc)
    return ts, tc, bs, bc
