"""Device-resident index: the snapshot's arrays as torch tensors on one
device, with the padding/sentinel layout the scoring kernels expect.

The counterpart of spaghettisearch_tpu/retrieval/device_index.py. Every
constant and gate is kept as it is there (DOC_BLOCK, DOC_TERM_CAP, the
doc-sorted layout, the posT budgets, the hot-cache budget) so the two
packages build the same arrays from the same snapshot; re-deriving the
TPU-sized residency gates for the H100's 80 GB is later work (ROADMAP.md).
`from_snapshot` accepts the JAX package's IndexSnapshot as well as this
package's copy: both hold numpy arrays.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..index.snapshot import IndexSnapshot, SectionCSR

#: doc-axis padding granularity (the TPU scorer's doc block; kept for parity)
DOC_BLOCK = 512

#: bound on per-doc dense forward terms (an index with a doc beyond it is
#: scored through the exact CSR path)
DOC_TERM_CAP = 4096

#: doc-sorted layout switches on automatically at and above this padded doc
#: count (see spaghettisearch_tpu/retrieval/device_index.py for the
#: measurement behind it); tie semantics stay canonical — exact_top_k
#: re-normalizes to (score desc, natural id asc) after the doc_map gather
DOC_SORT_MIN_DOCS = 1 << 16

#: body term-axis chunk rows for the doc-sorted layout; body T is padded to
#: a multiple of this
DOC_SORT_TC = 32


def _doc_sort_pays(nt: np.ndarray) -> bool:
    """Project whether the bounded sweep wins on THIS corpus: the doc-sorted
    layout pads body T to a multiple of DOC_SORT_TC and sweeps
    ceil(block_tmax/32)*32 rows per block, vs the natural layout's static
    T_pad. Gate on the projected per-block sweep from the sorted nt
    distribution."""
    t_nat = -(-max(int(nt.max(initial=1)), 1) // 8) * 8
    srt = np.sort(nt)[::-1]
    tmax = srt[:: DOC_BLOCK].astype(np.int64)  # per-block max = block head
    swept = np.maximum(-(-tmax // DOC_SORT_TC) * DOC_SORT_TC, DOC_SORT_TC)
    return float(swept.mean()) <= 0.9 * t_nat


def _doc_sort_perm(
    nt: np.ndarray, d_pad: int
) -> tuple[np.ndarray, np.ndarray]:
    """Doc permutation for the bounded membership sweep: sort docs by
    descending distinct-term count so DOC_BLOCK blocks are T-homogeneous,
    then reorder whole blocks in the JAX package's snake order (kept for
    parity; the GPU kernel's doc blocks are independent). Returns (perm
    [d_pad] new-pos -> old-doc, tmax [nb] per new block max nt)."""
    order = np.argsort(-nt, kind="stable")
    tmax0 = nt[order].reshape(-1, DOC_BLOCK).max(axis=1)
    blk_order = np.argsort(-tmax0, kind="stable")
    half_a, half_b = [], []
    for i, blk in enumerate(blk_order):
        (half_a if i % 4 in (0, 3) else half_b).append(blk)
    blocks = np.array(half_a + half_b, dtype=np.int64)
    perm = order.reshape(-1, DOC_BLOCK)[blocks].reshape(-1)
    return perm, tmax0[blocks].astype(np.int32)


def _round_up(n: int, m: int = 128) -> int:
    return max(((n + m - 1) // m) * m, m)


class ForwardArrays(NamedTuple):
    """Doc-major forward index in both layouts: [D, T] and transposed
    [T, D] (doc axis contiguous, the kernels' layout); fj maps each
    doc-term to its CSR posting."""

    ft: torch.Tensor | np.ndarray  # int32 [D_pad, T]
    fw: torch.Tensor | np.ndarray  # f32 [D_pad, T]
    fj: torch.Tensor | np.ndarray  # int32 [D_pad, T] posting index
    ftT: torch.Tensor  # int32 [T, D_pad]
    fwT: torch.Tensor  # f32 [T, D_pad]


#: pos_mat is only materialized while P_pad * pos_cap * 4 bytes stays under
#: this budget (it only accelerates the sparse phrase matcher; the
#: per-element position gather is exact)
POS_MAT_BUDGET_BYTES = 512 << 20

#: doc-major positions (posT) are built while the resident plane per
#: section stays under this budget AND the per-posting unique-position
#: count stays <= POS_T_C_MAX (TPU-sized gates, kept for parity)
POS_T_BUDGET_BYTES = 4 << 30
POS_T_C_MAX = 32

#: store posT planes as int16 when every real position fits (kernels/mixed.py
#: quantize_posT); dequantized exactly per load
POS_T_INT16 = True

#: hot-term dense weight cache (body section): the H highest-df terms get
#: their exact [D_pad] tf-idf rows stored dense, so a query's hot terms cost
#: ONE f32 matmul instead of a compare sweep each. H = min(HOT_H_MAX,
#: budget / (D_pad*4)).
HOT_W_BUDGET_BYTES = 2 << 30
HOT_H_MAX = 512
HOT_MAX_DPAD = 1_400_000
#: above this padded doc count the doc-major ft/fw/fj stay host-side and
#: upload lazily (DeviceSection.fwd_device)
FWD_DEV_MAX_DPAD = 1_400_000


def _build_hot_cache(
    csr: SectionCSR, d_pad: int, inv_perm: np.ndarray | None = None
) -> tuple[np.ndarray, dict[int, int]] | None:
    """Dense [H_pad, D_pad] f32 weight rows for the top-H df terms plus the
    term-id -> hot-slot map. None when the section is empty or the budget
    leaves no useful H. Only valid for candidacy-by-score engines (all
    weights > 0): callers gate on has_zero_weight. With inv_perm (doc-sorted
    layout) columns live in permuted doc space, matching the forward
    arrays."""
    n_post = csr.n_postings
    if n_post == 0:
        return None
    n_words = csr.post_offsets.shape[0] - 1
    df = np.diff(csr.post_offsets[: n_words + 1])
    h = min(HOT_H_MAX, int(HOT_W_BUDGET_BYTES // max(d_pad * 4, 1)), n_words)
    if h >= 128:
        h = (h // 128) * 128
    if h < 8:
        return None
    top = np.argsort(-df, kind="stable")[:h]
    top = top[df[top] > 0]
    if top.size == 0:
        return None
    h_pad = _round_up(int(top.size), 128)  # pad rows 0
    w = np.zeros((h_pad, d_pad), np.float32)
    for slot, wid in enumerate(top.tolist()):
        s, e = int(csr.post_offsets[wid]), int(csr.post_offsets[wid + 1])
        cols = csr.doc_ids[s:e]
        if inv_perm is not None:
            cols = inv_perm[cols]
        w[slot, cols] = csr.weights[s:e]
    return w, {int(wid): slot for slot, wid in enumerate(top.tolist())}


def _build_posT(
    csr: SectionCSR, fj: np.ndarray, d_pad: int, pos_big: float,
    bytes_per_el: int = 4,
) -> tuple[np.ndarray, int] | None:
    """Doc-major positions for the mixed kernel (see build_posT_raw)."""
    return build_posT_raw(
        csr.pos_offsets, csr.positions, csr.n_postings, csr.doc_ids.shape[0],
        fj, d_pad, pos_big, bytes_per_el=bytes_per_el,
    )


def build_posT_raw(
    pos_offsets: np.ndarray,  # int32 [>= n_post+1] (padded tail repeats ok)
    positions: np.ndarray,
    n_post: int,
    p_pad: int,  # padded posting-slot count fj indexes into
    fj: np.ndarray,  # int32 [D, T] posting index per doc-term slot
    d_pad: int,
    pos_big: float,
    bytes_per_el: int = 4,  # 2 when the caller will quantize to int16
) -> tuple[np.ndarray, int] | None:
    """Doc-major positions for the mixed kernel:

        posT[c*T + t, d] = c-th UNIQUE position of doc d's term-slot t

    (c-major rows). Pad = pos_big (finite). Duplicate positions within a
    posting carry no chain information and are blanked, which also caps C
    at the max UNIQUE position count. Returns None when C would exceed
    POS_T_C_MAX or the array would exceed POS_T_BUDGET_BYTES. Same numpy
    build as the JAX package."""
    d, t = fj.shape
    pos_off = pos_offsets.astype(np.int64)
    if n_post == 0:
        return np.full((1 * t, d_pad), pos_big, np.float32), 1
    l_total = int(pos_off[n_post])
    plen = np.diff(pos_off[: n_post + 1])
    raw = positions[:l_total]
    seg_first = np.zeros(max(l_total, 1), bool)
    seg_first[pos_off[:n_post][plen > 0]] = True
    dup = np.empty(max(l_total, 1), bool)
    dup[0] = False
    if l_total:
        dup[1:] = (raw[1:] == raw[:-1]) & ~seg_first[1:]
    if l_total == 0 or not bool(dup.any()):
        c = max(int(plen.max(initial=1)), 1)
        if c > POS_T_C_MAX or c * t * d_pad * bytes_per_el > POS_T_BUDGET_BYTES:
            return None
        pos_u = raw
        off_u = np.zeros(p_pad + 1, np.int64)
        off_u[: n_post + 1] = pos_off[: n_post + 1]
        off_u[n_post + 1 :] = off_u[n_post]
    else:
        keep = ~dup[:l_total]
        pos_u = raw[keep]
        ksum = np.zeros(l_total + 1, np.int64)
        np.cumsum(keep, out=ksum[1:])
        uniq = ksum[pos_off[1 : n_post + 1]] - ksum[pos_off[:n_post]]
        c = max(int(uniq.max(initial=1)), 1)
        if c > POS_T_C_MAX or c * t * d_pad * bytes_per_el > POS_T_BUDGET_BYTES:
            return None
        off_u = np.zeros(p_pad + 1, np.int64)
        off_u[1 : n_post + 1] = np.cumsum(uniq)
        off_u[n_post + 1 :] = off_u[n_post]
    out = np.empty((c * t, d_pad), np.float32)
    if d_pad > d:
        out[:, d:] = pos_big
    l_guard = max(len(pos_u) - 1, 0)
    pos_u = (
        np.concatenate([pos_u, [pos_big]]).astype(np.float32)
        if len(pos_u) else np.array([pos_big], np.float32)
    )
    off_u32 = off_u.astype(np.int32) if off_u[-1] < 2**31 - c - 1 else off_u
    chunk = max(1, (64 << 20) // max(t * c * 4, 1))  # bound transient memory
    ar_c = np.arange(c, dtype=np.int32)[:, None, None]  # [C, 1, 1]
    for d0 in range(0, d, chunk):
        d1 = min(d0 + chunk, d)
        fj_blk = fj[d0:d1].T  # [T, db]
        start = off_u32[fj_blk]
        end = off_u32[fj_blk + 1]
        idx = start[None] + ar_c  # [C, T, db]
        valid = idx < end[None]
        pos = np.where(valid, pos_u[np.minimum(idx, l_guard)], pos_big)
        out[:, d0:d1] = pos.reshape(c * t, d1 - d0)
    return out, c


def _put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@dataclass
class DeviceSection:
    offsets: torch.Tensor  # int32 [V+2]; row V is the sentinel empty row
    doc_ids: torch.Tensor  # int32 [P_pad]
    weights: torch.Tensor  # f32 [P_pad]
    pos_offsets: torch.Tensor  # int32 [P_pad+1]
    positions: torch.Tensor  # f32 [L_pad]
    fwd: ForwardArrays
    # fixed-width per-posting position rows [P_pad, pos_cap], inf-padded:
    # row gathers for the sparse phrase matcher (ops/phrase.py
    # match_phrase_fwd); None when over POS_MAT_BUDGET_BYTES
    pos_mat: torch.Tensor | None = None
    # doc-major positions [C*T_pad, D_pad] for the mixed kernel; None when
    # over budget / C too wide (phrases then take the sparse lane)
    posT: torch.Tensor | None = None
    pos_c: int = 0
    # True when some doc's dense forward row was truncated (doc_term_cap)
    dense_truncated: bool = False
    # True when some real posting weight is <= 0: candidacy then needs true
    # counts (the kernels keep their count outputs)
    has_zero_weight: bool = False
    # per-DOC_BLOCK max distinct-term count (int32 [D_pad // DOC_BLOCK]);
    # body section under the doc-sorted layout only
    tmax_blocks: torch.Tensor | None = None
    device: torch.device | None = None
    _fwd_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def fwd_device(self) -> ForwardArrays:
        """The forward arrays with ft/fw/fj ON DEVICE. Above
        FWD_DEV_MAX_DPAD those stay host-side at build; this uploads them
        once, under a lock, and memoizes the result."""
        with self._fwd_lock:
            f = self.fwd
            if not isinstance(f.ft, np.ndarray):
                return f
            f = ForwardArrays(
                ft=_put(f.ft, self.device), fw=_put(f.fw, self.device),
                fj=_put(f.fj, self.device), ftT=f.ftT, fwT=f.fwT,
            )
            self.fwd = f
            return f

    @classmethod
    def from_csr(
        cls, csr: SectionCSR, n_docs: int, d_pad: int, device: torch.device,
        doc_term_cap: int | None = None, pos_cap: int | None = None,
        perm: np.ndarray | None = None,  # [d_pad] new pos -> old doc
        inv_full: np.ndarray | None = None,  # [n_docs+1] old -> new, pad -> d_pad
        tmax_blocks: np.ndarray | None = None,  # body only (doc-sorted)
        t_multiple: int = 8,
    ) -> "DeviceSection":
        from ..ops.kernels.mixed import POS_BIG, quantize_posT

        if doc_term_cap is None:
            doc_term_cap = DOC_TERM_CAP
        pos_mat = None
        p_pad = csr.doc_ids.shape[0]
        if pos_cap and p_pad * pos_cap * 4 <= POS_MAT_BUDGET_BYTES:
            n_post = csr.n_postings
            pm = np.full((p_pad, pos_cap), np.inf, np.float32)
            if n_post:
                pidx = csr.pos_offsets[:n_post, None] + np.arange(
                    pos_cap, dtype=np.int64
                )
                pvalid = pidx < csr.pos_offsets[1 : n_post + 1, None]
                pm[:n_post] = np.where(
                    pvalid,
                    csr.positions[np.minimum(pidx, csr.positions.shape[0] - 1)],
                    np.inf,
                )
            pos_mat = _put(pm, device)
        # append sentinel row (empty range) for unknown/padded term ids
        offsets = np.concatenate([csr.post_offsets, csr.post_offsets[-1:]])
        n_post = csr.n_postings
        max_terms = int(np.bincount(
            csr.doc_ids[:n_post], minlength=max(n_docs, 1)
        ).max(initial=0)) if n_post else 0
        truncated = doc_term_cap is not None and max_terms > doc_term_cap
        zero_w = bool(n_post) and bool((csr.weights[:n_post] <= 0).any())
        ft, fw, fj = csr.forward_with_postings(n_docs, doc_term_cap=doc_term_cap)
        pad_rows = d_pad - n_docs
        ft = np.concatenate([ft, np.full((pad_rows, ft.shape[1]), -1, np.int32)])
        fw = np.concatenate([fw, np.zeros((pad_rows, fw.shape[1]), np.float32)])
        fj = np.concatenate(
            [fj, np.full((pad_rows, fj.shape[1]), csr.doc_ids.shape[0] - 1, np.int32)]
        )
        if perm is not None:
            ft, fw, fj = ft[perm], fw[perm], fj[perm]
        t_col_pad = (-ft.shape[1]) % t_multiple
        if t_col_pad:
            ft = np.concatenate(
                [ft, np.full((d_pad, t_col_pad), -1, np.int32)], axis=1
            )
            fw = np.concatenate(
                [fw, np.zeros((d_pad, t_col_pad), np.float32)], axis=1
            )
            fj = np.concatenate(
                [fj, np.full((d_pad, t_col_pad), csr.doc_ids.shape[0] - 1, np.int32)],
                axis=1,
            )
        posT = None
        pos_c = 0
        if not truncated:  # truncated rows route to CSR anyway
            built = _build_posT(
                csr, fj, d_pad, POS_BIG,
                bytes_per_el=2 if POS_T_INT16 else 4,
            )
            if built is not None:
                posT_np, pos_c = built
                if POS_T_INT16:
                    q16 = quantize_posT(posT_np)
                    if q16 is not None:
                        posT_np = q16
                if (posT_np.dtype != np.int16
                        and posT_np.nbytes > POS_T_BUDGET_BYTES):
                    posT_np, pos_c = None, 0
                posT = _put(posT_np, device) if posT_np is not None else None
        fwd_eager = d_pad <= FWD_DEV_MAX_DPAD or posT is None or truncated
        fwd = ForwardArrays(
            ft=_put(ft, device) if fwd_eager else ft,
            fw=_put(fw, device) if fwd_eager else fw,
            fj=_put(fj, device) if fwd_eager else fj,
            ftT=_put(ft.T, device),
            fwT=_put(fw.T, device),
        )
        doc_ids_np = csr.doc_ids if inv_full is None else inv_full[csr.doc_ids]
        return cls(
            offsets=_put(offsets.astype(np.int32), device),
            doc_ids=_put(doc_ids_np, device),
            weights=_put(csr.weights, device),
            pos_offsets=_put(csr.pos_offsets, device),
            positions=_put(csr.positions, device),
            fwd=fwd,
            pos_mat=pos_mat,
            posT=posT,
            pos_c=pos_c,
            dense_truncated=truncated,
            has_zero_weight=zero_w,
            tmax_blocks=(
                None if tmax_blocks is None
                else _put(tmax_blocks.astype(np.int32), device)
            ),
            device=device,
        )


@dataclass
class DeviceIndex:
    title: DeviceSection
    body: DeviceSection
    mag_title: torch.Tensor  # f32 [D_pad]
    mag_body: torch.Tensor  # f32 [D_pad]
    pagerank: torch.Tensor  # f32 [D_pad, C] (C >= 1; zeros when no topics)
    pagerankT: torch.Tensor  # f32 [C, D_pad]
    n_docs: int  # true doc count (hydration bound)
    n_docs_padded: int
    n_words: int
    posting_cap: int  # covers max df across both sections
    pos_cap: int  # covers max positions per posting
    device: torch.device
    # hot-term dense body-weight cache (see _build_hot_cache)
    hot_body_w: torch.Tensor | None = None  # f32 [H_pad, D_pad]
    hot_body_map: dict[int, int] | None = None  # term id -> hot slot
    # doc-sorted layout: every doc-axis array lives in permuted doc space;
    # doc_perm maps permuted position -> natural doc id (pads -> >= n_docs)
    doc_perm: torch.Tensor | None = None  # int32 [D_pad]
    doc_perm_np: np.ndarray | None = None

    @classmethod
    def from_snapshot(
        cls, snap: IndexSnapshot, device: torch.device | str,
        doc_sort: bool | None = None,
    ) -> "DeviceIndex":
        """Place a snapshot (this package's IndexSnapshot or the JAX
        package's: both hold numpy arrays) on `device`."""
        device = torch.device(device)
        d_pad = _round_up(max(snap.n_docs, 1), DOC_BLOCK)

        def section_nt(csr: SectionCSR) -> np.ndarray:
            n_post = csr.n_postings
            if not n_post:
                return np.zeros(d_pad, np.int32)
            return np.bincount(
                csr.doc_ids[:n_post], minlength=d_pad
            ).astype(np.int32)

        # doc-sorted layout: default-on at the large-corpus tier; off when
        # any dense row would truncate
        title_nt = section_nt(snap.title)
        body_nt = section_nt(snap.body)
        truncatable = (
            int(title_nt.max(initial=0)) > DOC_TERM_CAP
            or int(body_nt.max(initial=0)) > DOC_TERM_CAP
        )
        if doc_sort is None:
            doc_sort = d_pad >= DOC_SORT_MIN_DOCS and _doc_sort_pays(body_nt)
        doc_sort = doc_sort and not truncatable and snap.n_docs > 0
        perm = inv_full = body_tmax = None
        t_multiple = 8
        if doc_sort:
            perm, body_tmax = _doc_sort_perm(body_nt, d_pad)
            inv = np.empty(d_pad, np.int32)
            inv[perm] = np.arange(d_pad, dtype=np.int32)
            inv_full = np.empty(snap.n_docs + 1, np.int32)
            inv_full[: snap.n_docs] = inv[: snap.n_docs]
            inv_full[snap.n_docs] = d_pad  # CSR pad doc id -> out-of-range
            t_multiple = DOC_SORT_TC

        def pad_docs(a: np.ndarray) -> np.ndarray:
            out = np.zeros((d_pad,) + a.shape[1:], dtype=a.dtype)
            out[: a.shape[0]] = a
            return out[perm] if perm is not None else out

        if snap.pagerank is not None and snap.pagerank.shape[1] > 0:
            pr = snap.pagerank
        else:
            pr = np.zeros((snap.n_docs, 1), dtype=np.float32)
        posting_cap = _round_up(max(snap.title.max_df, snap.body.max_df, 1))
        pos_cap = _round_up(max(snap.title.max_positions, snap.body.max_positions, 1), 8)
        title = DeviceSection.from_csr(
            snap.title, snap.n_docs, d_pad, device, pos_cap=pos_cap,
            perm=perm, inv_full=inv_full, t_multiple=t_multiple,
        )
        body = DeviceSection.from_csr(
            snap.body, snap.n_docs, d_pad, device, pos_cap=pos_cap,
            perm=perm, inv_full=inv_full, tmax_blocks=body_tmax,
            t_multiple=t_multiple,
        )
        hot_w = hot_map = None
        if d_pad <= HOT_MAX_DPAD and not (
            title.has_zero_weight
            or body.has_zero_weight
            or title.dense_truncated
            or body.dense_truncated
        ):
            built = _build_hot_cache(
                snap.body, d_pad,
                inv_perm=None if inv_full is None else inv_full[: snap.n_docs],
            )
            if built is not None:
                hot_np, hot_map = built
                hot_w = _put(hot_np, device)
        return cls(
            title=title,
            body=body,
            mag_title=_put(pad_docs(snap.mag_title), device),
            mag_body=_put(pad_docs(snap.mag_body), device),
            pagerank=_put(pad_docs(pr), device),
            pagerankT=_put(pad_docs(pr).T, device),
            n_docs=snap.n_docs,
            n_docs_padded=d_pad,
            n_words=snap.n_words,
            posting_cap=posting_cap,
            pos_cap=pos_cap,
            device=device,
            hot_body_w=hot_w,
            hot_body_map=hot_map,
            doc_perm=None if perm is None else _put(perm.astype(np.int32), device),
            doc_perm_np=None if perm is None else perm.astype(np.int32),
        )

    @property
    def n_categories(self) -> int:
        return int(self.pagerank.shape[1])

    @property
    def match_pad(self) -> int:
        """Doc-id pad for matcher outputs and phrase fold arrays: real ids
        are < match_pad. The natural layout pads postings with n_docs; the
        doc-sorted layout scatters real docs across [0, d_pad) (device
        doc_ids are remapped), so its pad is d_pad."""
        return self.n_docs_padded if self.doc_perm is not None else self.n_docs

    @property
    def dense_truncated(self) -> bool:
        return self.title.dense_truncated or self.body.dense_truncated

    @property
    def pos_dense(self) -> bool:
        """True when both sections carry the doc-major position planes the
        mixed kernel reads."""
        return self.title.posT is not None and self.body.posT is not None

    @property
    def has_zero_weight(self) -> bool:
        return self.title.has_zero_weight or self.body.has_zero_weight

    def device_bytes(self) -> int:
        """Bytes of every tensor this index holds on its device."""
        return sum(
            v.numel() * v.element_size()
            for v in _flatten(self).values()
            if isinstance(v, torch.Tensor)
        )


_SECTION_FIELDS = (
    "offsets", "doc_ids", "weights", "pos_offsets", "positions", "pos_mat", "posT",
    "tmax_blocks",
)
_FWD_FIELDS = ("ft", "fw", "fj", "ftT", "fwT")
_INDEX_FIELDS = (
    "mag_title", "mag_body", "pagerank", "pagerankT", "hot_body_w", "doc_perm",
)


def _flatten(index) -> dict:
    out = {}
    for sec in ("title", "body"):
        s = getattr(index, sec)
        for f in _SECTION_FIELDS:
            out[f"{sec}.{f}"] = getattr(s, f)
        for f in _FWD_FIELDS:
            out[f"{sec}.fwd.{f}"] = getattr(s.fwd, f)
        out[f"{sec}.pos_c"] = s.pos_c
        out[f"{sec}.dense_truncated"] = s.dense_truncated
        out[f"{sec}.has_zero_weight"] = s.has_zero_weight
    for f in _INDEX_FIELDS:
        out[f] = getattr(index, f)
    for f in ("n_docs", "n_docs_padded", "n_words", "posting_cap", "pos_cap"):
        out[f] = getattr(index, f)
    out["hot_body_map"] = index.hot_body_map
    return out


def _to_numpy(v):
    if v is None or isinstance(v, (bool, int, float, dict)):
        return v
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def index_arrays(index: DeviceIndex) -> dict:
    """Every array of this package's DeviceIndex as host numpy (None for
    absent ones), keyed like arrays_from_jax."""
    return {k: _to_numpy(v) for k, v in _flatten(index).items()}


def arrays_from_jax(jax_device_index) -> dict:
    """The same dict from the JAX package's DeviceIndex (its arrays convert
    with np.asarray; nothing here imports jax) — the state carried across
    the two packages, compared array for array by the parity tests."""
    return {k: _to_numpy(v) for k, v in _flatten(jax_device_index).items()}
