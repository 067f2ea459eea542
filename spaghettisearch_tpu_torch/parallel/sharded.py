"""Doc-sharded scale-out: the sharded index, its scorers and PageRank (the
counterpart of spaghettisearch_tpu/parallel/sharded.py).

Layout, as in the JAX package:
- documents are split into contiguous id ranges, one per shard;
- each shard holds a complete local CSR (its docs' postings for every word),
  so any query term is resolvable locally: queries broadcast, docs shard;
- one block per shard per query batch: local phrase matching -> local
  scoring on the hand-written kernels (K1 for keyword batches, K2 for the
  mixed lane) -> local top-k; then the S [B, k] pieces go to the mesh's
  first device and one merged top-k picks the batch's results. Only B*k*S
  scores leave a shard, never a [B, D] score matrix.

The JAX package runs the blocks as one shard_map program (the all-gather
rides ICI). Here one process runs them in turn (parallel/mesh.py): every
launch is asynchronous, so shards on different cards overlap, and the
"all-gather" is a copy of each [B, k] piece to the first device. There is
no compile, so nothing is cached but the scorer closures the engine keys by
scorer_meta. The host builders (_repeat_blocks, _shard_csr,
_shard_hot_cache) are the JAX package's numpy code: both packages build
equal arrays from one snapshot, and the residency gates stay its own.

Scorer inputs are host arrays (numpy); each block's batch rows are put on
its shard's device, and the results come back on the mesh's first device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..index.snapshot import IndexSnapshot, SectionCSR
from ..ops.kernels import membership as _k1
from ..ops.kernels import mixed as _k2
from ..ops.kernels.mixed import POS_BIG, quantize_posT
from ..ops.pagerank import _iterate
from ..ops.phrase import match_phrase_batch, match_phrase_fwd_batch
from ..ops.scoring import _top_k_lowest_index, exact_top_k, finalize_scores, hot_body_scores
from ..retrieval.device_index import (
    POS_T_BUDGET_BYTES,
    POS_T_INT16,
    ForwardArrays,
    build_posT_raw,
)
from .mesh import Mesh

#: bound on per-doc dense forward terms (matches DeviceSection's default)
DOC_TERM_CAP = 4096


def _repeat_blocks(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat gather indices for variable-length blocks [starts[i], starts[i]+lens[i])."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    shift = np.repeat(np.cumsum(lens) - lens, lens)
    return np.arange(total, dtype=np.int64) - shift + np.repeat(starts, lens)


def _shard_csr(
    csr: SectionCSR, n_shards: int, docs_per_shard: int, t_pad: int,
    inv_perm: np.ndarray | None = None,  # [S, Dl] local natural -> permuted
    t_multiple: int = 8,
) -> dict[str, np.ndarray]:
    """Split a global CSR into per-shard local CSRs (stacked [S, ...] at
    equal widths), plus per-shard doc-major forward views (ft word ids, fw
    weights, fj posting index into the shard-LOCAL padded posting arrays)
    and the mixed kernel's position planes (posT, None when over budget or
    when a dense row was truncated). With inv_perm (the doc-sorted layout)
    every doc-axis structure comes out in PERMUTED local doc space: CSR
    doc ids are remapped through inv_perm, row order untouched."""
    n_words = csr.post_offsets.shape[0] - 1
    n_post = csr.n_postings
    word_of_post = np.repeat(
        np.arange(n_words, dtype=np.int32), np.diff(csr.post_offsets)
    )
    doc = csr.doc_ids[:n_post]
    shard_of_post = doc // docs_per_shard

    parts = []
    for s in range(n_shards):
        sel = np.flatnonzero(shard_of_post == s)
        counts = np.bincount(word_of_post[sel], minlength=n_words)
        offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        starts = csr.pos_offsets[sel]
        lens = (csr.pos_offsets[sel + 1] - starts).astype(np.int64)
        pos_offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        local_doc = (doc[sel] - s * docs_per_shard).astype(np.int32)
        if inv_perm is not None:
            local_doc = inv_perm[s][local_doc]
        parts.append(
            dict(
                offsets=offsets,
                doc_ids=local_doc,
                weights=csr.weights[sel],
                pos_offsets=pos_offsets,
                positions=csr.positions[_repeat_blocks(starts, lens)],
            )
        )

    def stack(key: str, pad_value, width: int, tail_fill: bool = False) -> np.ndarray:
        arrs = [p[key] for p in parts]
        out = np.full((n_shards, width), pad_value, dtype=arrs[0].dtype)
        for s, a in enumerate(arrs):
            out[s, : a.shape[0]] = a
            if tail_fill and a.shape[0]:
                out[s, a.shape[0] :] = a[-1]
        return out

    def rounded(key: str, extra: int = 1) -> int:
        return -(-(max(p[key].shape[0] for p in parts) + extra) // 128) * 128

    post_width = rounded("doc_ids")

    truncated = t_pad > DOC_TERM_CAP
    t_pad = min(t_pad, DOC_TERM_CAP)
    t_pad = -(-t_pad // t_multiple) * t_multiple
    ft = np.full((n_shards, docs_per_shard, t_pad), -1, np.int32)
    fw = np.zeros((n_shards, docs_per_shard, t_pad), np.float32)
    fj = np.full((n_shards, docs_per_shard, t_pad), post_width - 1, np.int32)
    for s, p in enumerate(parts):
        n_local = p["doc_ids"].shape[0]
        if n_local == 0:
            continue
        w_of = np.repeat(
            np.arange(n_words, dtype=np.int32), np.diff(p["offsets"])
        )
        keep = np.arange(n_local, dtype=np.int64)
        if truncated:
            rank_order = np.lexsort((-p["weights"], p["doc_ids"]))
            docs_r = p["doc_ids"][rank_order]
            off = np.concatenate(
                [[0], np.cumsum(np.bincount(docs_r, minlength=docs_per_shard))]
            )
            rank_in_doc = np.arange(n_local, dtype=np.int64) - off[docs_r]
            keep = rank_order[rank_in_doc < DOC_TERM_CAP]
        order = keep[np.argsort(p["doc_ids"][keep], kind="stable")]
        docs_s = p["doc_ids"][order]
        row_off = np.zeros(docs_per_shard + 1, np.int64)
        # bincount+cumsum, NOT np.add.at (10-30x slower on multi-M arrays)
        row_off[1:] = np.cumsum(np.bincount(docs_s, minlength=docs_per_shard))
        slot = np.arange(len(order), dtype=np.int64) - row_off[docs_s]
        ft[s, docs_s, slot] = w_of[order]
        fw[s, docs_s, slot] = p["weights"][order]
        fj[s, docs_s, slot] = order.astype(np.int32)

    posT = None
    pos_c = 0
    if not truncated:
        shard_posT = []
        for s, p in enumerate(parts):
            n_post_local = p["doc_ids"].shape[0]
            off_ext = np.full(post_width + 1, 0, np.int32)
            off_ext[: n_post_local + 1] = p["pos_offsets"]
            off_ext[n_post_local + 1 :] = p["pos_offsets"][-1]
            built = build_posT_raw(
                off_ext, p["positions"], n_post_local, post_width,
                fj[s], docs_per_shard, POS_BIG,
                bytes_per_el=2 if POS_T_INT16 else 4,
            )
            if built is None:
                shard_posT = None
                break
            shard_posT.append(built)
        if shard_posT is not None:
            pos_c = max(c for _, c in shard_posT)
            posT = np.full(
                (n_shards, pos_c * t_pad, docs_per_shard), POS_BIG, np.float32
            )
            for s, (arr, c) in enumerate(shard_posT):
                posT[s, : c * t_pad] = arr
            if POS_T_INT16:
                q16 = quantize_posT(posT.reshape(n_shards * pos_c * t_pad, -1))
                if q16 is not None:
                    posT = q16.reshape(posT.shape)
                elif pos_c * t_pad * docs_per_shard * 4 > POS_T_BUDGET_BYTES:
                    posT, pos_c = None, 0

    return dict(
        posT=posT,
        pos_c=pos_c,
        offsets=stack("offsets", 0, rounded("offsets"), tail_fill=True),
        doc_ids=stack("doc_ids", docs_per_shard, post_width),
        weights=stack("weights", 0.0, post_width),
        pos_offsets=stack("pos_offsets", 0, post_width + 1, tail_fill=True),
        positions=stack("positions", np.inf, rounded("positions")),
        ft=ft, fw=fw, fj=fj, truncated=truncated,
    )


def _shard_hot_cache(
    csr: SectionCSR, n_shards: int, dl: int,
    inv_perm: np.ndarray | None = None,  # [S, Dl] local natural -> permuted
) -> tuple[np.ndarray, dict[int, int]] | None:
    """Per-shard slices [S, H_pad, Dl] of the hot-term dense weight cache
    (cf. device_index._build_hot_cache): the top-H GLOBAL-df body terms get
    exact dense weight rows. The hot set (and the term id -> slot map) is
    global, so every shard answers the same hot split; the H budget is per
    shard."""
    from ..retrieval.device_index import HOT_H_MAX, HOT_W_BUDGET_BYTES, _round_up

    n_post = csr.n_postings
    if n_post == 0:
        return None
    n_words = csr.post_offsets.shape[0] - 1
    df = np.diff(csr.post_offsets[: n_words + 1])
    h = min(HOT_H_MAX, int(HOT_W_BUDGET_BYTES // max(dl * 4, 1)), n_words)
    if h < 8:
        return None
    top = np.argsort(-df, kind="stable")[:h]
    top = top[df[top] > 0]
    if top.size == 0:
        return None
    h_pad = _round_up(int(top.size), 128)
    w = np.zeros((n_shards, h_pad, dl), np.float32)
    for slot, wid in enumerate(top.tolist()):
        s, e = int(csr.post_offsets[wid]), int(csr.post_offsets[wid + 1])
        cols = csr.doc_ids[s:e]
        shard = cols // dl
        local = cols % dl
        if inv_perm is not None:
            local = inv_perm[shard, local]
        w[shard, slot, local] = csr.weights[s:e]
    return w, {int(wid): slot for slot, wid in enumerate(top.tolist())}


@dataclass
class ShardSection:
    """One section of one shard, with device_index.DeviceSection's names."""

    offsets: torch.Tensor  # int32 [V_pad]: rows past V repeat the last offset
    doc_ids: torch.Tensor  # int32 [P_pad] local ids (permuted when doc-sorted), pad Dl
    weights: torch.Tensor  # f32 [P_pad]
    pos_offsets: torch.Tensor  # int32 [P_pad + 1]
    positions: torch.Tensor  # f32 [L_pad], inf pad
    fwd: ForwardArrays  # ft/fw/fj [Dl, T], ftT/fwT [T, Dl]
    posT: torch.Tensor | None = None  # [C*T, Dl] int16 or f32 position planes
    tmax_blocks: torch.Tensor | None = None  # body, doc-sorted: int32 [Dl // 512]


@dataclass
class Shard:
    """One shard's arrays on its device. The names follow DeviceIndex, so
    the kernel checks (ops/kernels/check.py) take a shard as they take a
    single-device index."""

    title: ShardSection
    body: ShardSection
    mag_title: torch.Tensor  # f32 [Dl]
    mag_body: torch.Tensor  # f32 [Dl]
    pagerank: torch.Tensor  # f32 [Dl, C]
    hot_body_w: torch.Tensor | None  # f32 [H_pad, Dl]
    hot_body_map: dict[int, int] | None  # the global hot set
    doc_perm: torch.Tensor | None  # int32 [Dl] permuted -> local natural id
    n_words: int
    n_docs_padded: int  # Dl
    device: torch.device

    def tensors(self) -> list[torch.Tensor]:
        out = []
        for x in (self.title, self.body, self):
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                out += list(v) if isinstance(v, ForwardArrays) else [v]
        return [v for v in out if isinstance(v, torch.Tensor)]

    def device_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tensors())

    def to(self, device: torch.device) -> "Shard":
        def mv(v):
            return v.to(device) if isinstance(v, torch.Tensor) else v

        def section(sec: ShardSection) -> ShardSection:
            moved = {f.name: mv(getattr(sec, f.name)) for f in dataclasses.fields(sec)}
            return ShardSection(**{**moved, "fwd": ForwardArrays(*map(mv, sec.fwd))})

        return dataclasses.replace(
            self, title=section(self.title), body=section(self.body),
            mag_title=mv(self.mag_title), mag_body=mv(self.mag_body),
            pagerank=mv(self.pagerank), hot_body_w=mv(self.hot_body_w),
            doc_perm=mv(self.doc_perm), device=torch.device(device),
        )


def _put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _doc_grid(mesh: Mesh, axis: str) -> np.ndarray:
    """The mesh's devices as [rows, S]: the doc axis last, every other axis
    flattened into replica rows."""
    s = mesh.shape[axis]
    return np.moveaxis(mesh.devices, mesh.axis_names.index(axis), -1).reshape(-1, s)


@dataclass
class ShardedIndex:
    mesh: Mesh
    axis: str
    n_shards: int
    n_docs: int  # global (unpadded)
    docs_per_shard: int
    n_words: int
    posting_cap: int
    pos_cap: int
    # rows[r][s]: shard s on the r-th device row of the mesh (the doc axis
    # across, the other axes flattened down); rows on the same devices
    # share their Shard objects
    rows: list[list[Shard]]
    dense_truncated: bool = False  # some doc's dense row was capped
    has_zero_weight: bool = False  # some posting weight <= 0 (idf-0 corner)
    hot_body_map: dict[int, int] | None = None  # term id -> hot slot

    @property
    def shards(self) -> list[Shard]:
        return self.rows[0]

    @property
    def pos_dense(self) -> bool:
        """True when every shard carries both sections' position planes
        (the mixed kernel's layout; cf. DeviceIndex.pos_dense)."""
        return all(
            sh.title.posT is not None and sh.body.posT is not None
            for row in self.rows for sh in row
        )

    @property
    def hot_body_w(self) -> list[torch.Tensor] | None:
        w = [sh.hot_body_w for sh in self.shards]
        return None if w[0] is None else w

    @property
    def doc_perm(self) -> list[torch.Tensor] | None:
        p = [sh.doc_perm for sh in self.shards]
        return None if p[0] is None else p

    def device_bytes(self) -> list[int]:
        """Bytes each shard of the first row holds on its device."""
        return [sh.device_bytes() for sh in self.shards]

    @classmethod
    def from_snapshot(
        cls,
        snap: IndexSnapshot,
        mesh: Mesh,
        axis: str = "d",
        weights: str = "tfidf",  # "bm25": per-posting Okapi weights instead
        doc_sort: bool | None = None,  # None: auto-gate like DeviceIndex
    ) -> "ShardedIndex":
        """Shard a snapshot (this package's IndexSnapshot or the JAX
        package's) over `mesh`'s `axis`: the JAX package's host build, then
        shard s's arrays on its device in every device row."""
        if weights == "bm25":
            from ..models.bm25 import bm25_posting_weights

            snap = dataclasses.replace(
                snap,
                title=dataclasses.replace(
                    snap.title, weights=bm25_posting_weights(snap.title, snap.n_docs)
                ),
                body=dataclasses.replace(
                    snap.body, weights=bm25_posting_weights(snap.body, snap.n_docs)
                ),
            )
        from ..retrieval.device_index import (
            DOC_SORT_MIN_DOCS,
            DOC_SORT_TC,
            _doc_sort_pays,
            _doc_sort_perm,
        )

        n_shards = mesh.shape[axis]
        dl = -(-max(snap.n_docs, 1) // n_shards)
        dl = -(-dl // 512) * 512  # doc-block aligned local doc count

        def nt_of(csr: SectionCSR) -> np.ndarray:
            n_post = csr.n_postings
            if n_post == 0:
                return np.zeros(n_shards * dl, np.int32)
            out = np.zeros(n_shards * dl, np.int64)
            out[: max(snap.n_docs, 1)] = np.bincount(
                csr.doc_ids[:n_post], minlength=max(snap.n_docs, 1)
            )
            return out.astype(np.int32)

        title_nt = nt_of(snap.title)
        body_nt = nt_of(snap.body)
        truncatable = (
            int(title_nt.max(initial=0)) > DOC_TERM_CAP
            or int(body_nt.max(initial=0)) > DOC_TERM_CAP
        )
        # the doc-sorted gate of DeviceIndex on the PER-SHARD padded count:
        # each shard sorts its own docs and runs its own sweep
        if doc_sort is None:
            doc_sort = dl >= DOC_SORT_MIN_DOCS and _doc_sort_pays(body_nt)
        doc_sort = doc_sort and not truncatable and snap.n_docs > 0
        perm_all = inv_all = body_tmax_np = None
        t_multiple = 8
        if doc_sort:
            t_multiple = DOC_SORT_TC
            nt2 = body_nt.reshape(n_shards, dl)
            perm_all = np.empty((n_shards, dl), np.int64)
            inv_all = np.empty((n_shards, dl), np.int32)
            tmaxes = []
            for s in range(n_shards):
                p, tm = _doc_sort_perm(nt2[s], dl)
                perm_all[s] = p
                inv_all[s, p] = np.arange(dl, dtype=np.int32)
                tmaxes.append(tm)
            body_tmax_np = np.stack(tmaxes).astype(np.int32)

        def t_pad_of(csr: SectionCSR) -> int:
            n_post = csr.n_postings
            if n_post == 0:
                return 1
            per_doc = np.bincount(
                csr.doc_ids[:n_post], minlength=max(snap.n_docs, 1)
            )
            return max(int(per_doc.max()), 1)

        title_np = _shard_csr(
            snap.title, n_shards, dl, t_pad_of(snap.title),
            inv_perm=inv_all, t_multiple=t_multiple,
        )
        body_np = _shard_csr(
            snap.body, n_shards, dl, t_pad_of(snap.body),
            inv_perm=inv_all, t_multiple=t_multiple,
        )

        def pad_docs(arr: np.ndarray) -> np.ndarray:
            out = np.zeros((n_shards * dl,) + arr.shape[1:], dtype=arr.dtype)
            out[: arr.shape[0]] = arr
            out = out.reshape((n_shards, dl) + arr.shape[1:])
            if perm_all is not None:
                out = np.stack([out[s][perm_all[s]] for s in range(n_shards)])
            return out

        if snap.pagerank is not None and snap.pagerank.shape[1] > 0:
            pr = snap.pagerank
        else:
            pr = np.zeros((snap.n_docs, 1), dtype=np.float32)
        posting_cap = min(
            -(-max(snap.title.max_df, snap.body.max_df, 1) // 128) * 128,
            title_np["doc_ids"].shape[1],
        )
        has_zero_w = bool(
            (snap.title.weights[: snap.title.n_postings] <= 0).any()
            or (snap.body.weights[: snap.body.n_postings] <= 0).any()
        )
        hot_np = hot_map = None
        if not (has_zero_w or title_np["truncated"] or body_np["truncated"]):
            built = _shard_hot_cache(snap.body, n_shards, dl, inv_perm=inv_all)
            if built is not None:
                hot_np, hot_map = built
        mags = pad_docs(snap.mag_title), pad_docs(snap.mag_body), pad_docs(pr)

        def section(np_d: dict, s: int, dev, tmax=None) -> ShardSection:
            return ShardSection(
                **{k: _put(np_d[k][s], dev)
                   for k in ("offsets", "doc_ids", "weights", "pos_offsets", "positions")},
                fwd=ForwardArrays(
                    ft=_put(np_d["ft"][s], dev), fw=_put(np_d["fw"][s], dev),
                    fj=_put(np_d["fj"][s], dev),
                    ftT=_put(np_d["ft"][s].T, dev), fwT=_put(np_d["fw"][s].T, dev),
                ),
                posT=None if np_d["posT"] is None else _put(np_d["posT"][s], dev),
                tmax_blocks=None if tmax is None else _put(tmax[s], dev),
            )

        grid = _doc_grid(mesh, axis)
        shards = [
            Shard(
                title=section(title_np, s, dev),
                body=section(body_np, s, dev, body_tmax_np),
                mag_title=_put(mags[0][s], dev),
                mag_body=_put(mags[1][s], dev),
                pagerank=_put(mags[2][s], dev),
                hot_body_w=None if hot_np is None else _put(hot_np[s], dev),
                hot_body_map=hot_map,
                doc_perm=None if perm_all is None else _put(perm_all[s].astype(np.int32), dev),
                n_words=snap.n_words,
                n_docs_padded=dl,
                device=dev,
            )
            for s, dev in enumerate(grid[0])
        ]
        rows = [shards] + [
            [sh if sh.device == dev else sh.to(dev) for sh, dev in zip(shards, grid[r])]
            for r in range(1, grid.shape[0])
        ]
        return cls(
            mesh=mesh,
            axis=axis,
            n_shards=n_shards,
            n_docs=snap.n_docs,
            docs_per_shard=dl,
            n_words=snap.n_words,
            posting_cap=posting_cap,
            pos_cap=-(-max(snap.title.max_positions, snap.body.max_positions, 1) // 8) * 8,
            rows=rows,
            dense_truncated=bool(title_np["truncated"] or body_np["truncated"]),
            has_zero_weight=has_zero_w,
            hot_body_map=hot_map,
        )


def scorer_meta(sidx: ShardedIndex) -> tuple:
    """The static facts a sharded scorer depends on. Two indexes with equal
    meta (same mesh geometry and padded dims) share scorers: the engine
    keys them by it, so a /refresh that keeps the geometry reuses them."""
    hot = sidx.hot_body_w
    return (
        sidx.mesh, sidx.axis, sidx.docs_per_shard,
        sidx.posting_cap, sidx.pos_cap, sidx.dense_truncated,
        sidx.pos_dense, sidx.has_zero_weight,
        0 if hot is None else int(hot[0].shape[0]),
        sidx.doc_perm is not None,
    )


def index_args(
    sidx: ShardedIndex, mixed: bool = False,
    hot: bool = False, doc_sorted: bool = False,
) -> list[tuple]:
    """Per shard, the arrays a scorer reads, in the JAX package's block
    order: 23 base arrays, + the 2 position planes (mixed), + the hot-term
    weight cache (hot), + doc_perm and body_tmax (doc_sorted)."""
    out = []
    for sh in sidx.shards:
        t, bd = sh.title, sh.body
        args = (
            t.offsets, t.doc_ids, t.weights, t.pos_offsets, t.positions,
            bd.offsets, bd.doc_ids, bd.weights, bd.pos_offsets, bd.positions,
            sh.mag_title, sh.mag_body, sh.pagerank,
            t.fwd.ft, t.fwd.fw, t.fwd.fj, bd.fwd.ft, bd.fwd.fw, bd.fwd.fj,
            t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT,
        )
        if mixed:
            args += (t.posT, bd.posT)
        if hot:
            args += (sh.hot_body_w,)
        if doc_sorted:
            args += (sh.doc_perm, bd.tmax_blocks)
        out.append(args)
    return out


# --------------------------------------------------------------------- #
# the scorers: one block per shard, then the merge
# --------------------------------------------------------------------- #


def _batch_axis(mesh: Mesh, axis: str, batch_axis: str | None) -> str | None:
    """The query-row axis: given, or any mesh axis other than the doc axis
    with more than one device (the JAX package's auto-detection)."""
    if batch_axis is None:
        others = [a for a in mesh.axis_names if a != axis and mesh.shape[a] > 1]
        batch_axis = others[0] if others else None
    return batch_axis


def _fold(b: int, dl: int, ph_row, ph_docs, ph_tw, ph_bw, ph_fl):
    """Scatter the compressed phrase rows' matches onto their batch rows ->
    (title weight, body weight, match flag), each [b, dl]. Rows mapped to b
    and docs at dl are pads and drop (the JAX package's scatter over a
    [b+1, dl+1] accumulator, whose mode="drop" also drops the CSR
    matcher's int32-max pad docs: here they go to the pad column)."""
    acc = torch.zeros(((b + 1) * (dl + 1), 3), dtype=torch.float32, device=ph_docs.device)
    docs = torch.where((ph_docs >= 0) & (ph_docs < dl), ph_docs, dl)
    idx = ph_row.clamp(max=b).long()[:, None] * (dl + 1) + docs.long()
    acc.index_add_(0, idx.reshape(-1), torch.stack([ph_tw, ph_bw, ph_fl], dim=-1).reshape(-1, 3))
    acc = acc.view(b + 1, dl + 1, 3)[:b, :dl]
    return acc[:, :, 0], acc[:, :, 1], acc[:, :, 2]


def _hot_fold(shard: Shard, hot_sids, bs, bc, dl: int):
    hot = hot_body_scores(shard.hot_body_w, hot_sids)[:, :dl]
    bs = bs + hot
    if bc is not None:  # true-count path: hot candidacy counts too
        bc = bc + (hot > 0).to(bs.dtype)
    return bs, bc


def _local_top_k(final, k: int, shard: Shard, s: int, dl: int, doc_sorted: bool):
    """The shard's top-k with global ids: the doc-sorted layout maps back to
    local natural ids first, then the shard's id offset s * Dl."""
    scores, ids = exact_top_k(final, min(k, dl), doc_map=shard.doc_perm if doc_sorted else None)
    return scores, ids + s * dl


def _merge(parts: list[tuple], k: int, device: torch.device):
    """The S [b, k_l] (scores, ids) pieces, gathered on `device` in shard
    order, -> the merged top-k: lax.top_k over the flat [b, S*k_l] row
    (values descending, ties to the lower flat position, so shard-major)."""
    scores = torch.cat([p[0].to(device) for p in parts], dim=1)
    ids = torch.cat([p[1].to(device) for p in parts], dim=1)
    top_s, pos = _top_k_lowest_index(scores, min(k, scores.shape[1]))
    return top_s, torch.gather(ids, 1, pos)


def _run_rows(sidx: ShardedIndex, batch_axis: str | None, batch: dict, shared: dict, block, k: int):
    """Split the host batch arrays over the query rows, put each row's
    slice (and the `shared` arrays) on every shard's device once, run
    block(shard, s, qi, inputs) per shard, merge each row's pieces on the
    mesh's first device and stack the rows. -> (scores [B, k], ids [B, k])."""
    n_rows = sidx.mesh.shape[batch_axis] if batch_axis else 1
    b = next(iter(batch.values())).shape[0]
    if b % n_rows:
        raise ValueError(f"batch of {b} rows does not split over {n_rows} query rows")
    b_row = b // n_rows
    first = sidx.rows[0][0].device
    out = []
    for qi in range(n_rows):
        placed: dict[torch.device, dict] = {}
        parts = []
        for s, shard in enumerate(sidx.rows[qi]):
            x = placed.get(shard.device)
            if x is None:
                x = {key: _put(v[qi * b_row : (qi + 1) * b_row], shard.device)
                     for key, v in batch.items()}
                x.update({key: _put(v, shard.device) for key, v in shared.items()})
                placed[shard.device] = x
            parts.append(block(shard, s, qi, x))
        out.append(_merge(parts, k, first))
    if n_rows == 1:
        return out[0]
    return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])


def make_sharded_scorer(
    sidx_or_meta,
    topk: int,
    batch_axis: str | None = None,
    scoring: str = "blended",  # "bm25": boosted field sums, no cosine/PR
    title_boost: float = 2.0,
    body_boost: float = 1.0,
):
    """The sharded keyword step (with the sparse phrase lane's matcher).

    Accepts a ShardedIndex or its scorer_meta(). Returns
    run(sidx, term_ids [B,Q], qlen [B], topic_probs [B,C],
        phrase_term_ids [BP,P] or [P], phrase_valid, gen_idx, phrase_rows,
        qn [B], qnb [B], hot_sids [B,Q]) ->
    (scores [B,K], global doc ids [B,K]) on the mesh's first device; the
    inputs are host arrays. Any ShardedIndex with this meta can be passed.
    Pass phrase_valid all-False for keyword-only batches.

    Per shard, as the JAX package's block: the phrase matcher (the forward
    matcher, or the exact CSR matcher when dense rows were truncated) on the
    compressed [BP, P] phrase axis, K1 with the qn bound, the hot split (qnb
    + the hot matmul, reference blend only), the doc-sorted T bound and
    count elision when every weight is positive; the phrase fold,
    candidacy, finalize (or the BM25 boosted sum) and the local top-k.

    On a 2-D mesh (make_mesh2d) the batch also splits over `batch_axis`
    (auto-detected: any axis but the doc axis): each query row scores B/n_q
    queries against the whole doc-sharded index. B must divide by n_q."""
    meta = scorer_meta(sidx_or_meta) if isinstance(sidx_or_meta, ShardedIndex) else sidx_or_meta
    mesh, ax, dl, cap, pcap, dense_truncated, _, has_zero_w, hot_h, doc_sorted = meta
    # the hot split rides the reference blend only; BM25 sums need true
    # counts for candidacy
    use_hot = hot_h > 0 and scoring != "bm25"
    emit_counts = has_zero_w or scoring == "bm25"
    batch_axis = _batch_axis(mesh, ax, batch_axis)
    k = topk

    def block(shard: Shard, s: int, qi: int, x: dict, has_phrase: bool):
        t, bd = shard.title, shard.body
        b = x["term_ids"].shape[0]
        if has_phrase:
            if dense_truncated:  # capped dense rows would under-match
                ph = match_phrase_batch(
                    t.offsets, t.doc_ids, t.weights, t.pos_offsets, t.positions,
                    bd.offsets, bd.doc_ids, bd.weights, bd.pos_offsets, bd.positions,
                    x["ph_ids"], x["ph_valid"], x["gen"],
                    posting_cap=cap, pos_cap=pcap, n_docs=dl,
                )
            else:
                ph = match_phrase_fwd_batch(
                    t.fwd.ft, t.fwd.fj, t.weights, t.pos_offsets, t.positions,
                    bd.fwd.ft, bd.fwd.fj, bd.weights, bd.pos_offsets, bd.positions,
                    t.offsets, t.doc_ids, bd.offsets, bd.doc_ids,
                    x["ph_ids"], x["ph_valid"], x["gen"],
                    posting_cap=cap, pos_cap=pcap, n_docs=dl,
                )
        ts, tc, bs, bc = _k1.forward_scores_2sec(
            t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, x["term_ids"], x["qn"],
            emit_counts=emit_counts, qnb=x["qnb"] if use_hot else None,
            body_tmax=bd.tmax_blocks if doc_sorted else None,
        )
        if use_hot:
            bs, bc = _hot_fold(shard, x["hot_sids"], bs, bc, dl)
        d_fl = None
        if has_phrase:  # keyword-only batches skip the scatter
            # phrase_rows are GLOBAL batch indices: this query row holds
            # [qi*b, (qi+1)*b); the rest drop
            local = x["ph_row"] - qi * b
            row = torch.where((local >= 0) & (local < b), local, b)
            d_ts, d_bs, d_fl = _fold(b, dl, row, *ph)
            ts = ts + d_ts
            bs = bs + d_bs
        if tc is None:  # counts elided: all weights > 0, candidacy by score
            cand = ts + bs > 0
            tc = (cand if d_fl is None else cand | (d_fl > 0)).to(ts.dtype)
            bc = torch.zeros_like(tc)
        elif d_fl is not None:
            tc = tc + d_fl
        if scoring == "bm25":
            final = title_boost * ts + body_boost * bs
            final = torch.where(tc + bc > 0, final, torch.full_like(final, -float("inf")))
        else:
            final = finalize_scores(
                ts, tc, bs, bc, shard.mag_title, shard.mag_body, shard.pagerank,
                x["qlen"], x["topic_probs"],
            )
        return _local_top_k(final, k, shard, s, dl, doc_sorted)

    def run(sidx, term_ids, qlen, topic_probs, ph_ids, ph_valid, gen_idx,
            phrase_rows=None, qn=None, qnb=None, hot_sids=None):
        term_ids = np.asarray(term_ids, np.int32)
        b, q = term_ids.shape
        ph_ids = np.asarray(ph_ids, np.int32)
        ph_valid = np.asarray(ph_valid, bool)
        gen_idx = np.asarray(gen_idx, np.int32)
        if ph_ids.ndim == 1:  # one [P] phrase set broadcast to every row
            ph_ids = np.repeat(ph_ids[None], b, axis=0)
            ph_valid = np.repeat(ph_valid[None], b, axis=0)
            gen_idx = np.repeat(np.atleast_1d(gen_idx), b)
            phrase_rows = None
        if phrase_rows is None:
            phrase_rows = np.arange(b, dtype=np.int32)
        if qn is None:  # full-width sweep (sentinel slots never match)
            qn = np.full((b,), q, np.int32)
        if qnb is None:  # no hot split: every slot is cold
            qnb = qn
        if hot_sids is None:
            hot_sids = np.full((b, q), -1, np.int32)
        has_phrase = bool(ph_valid.any())
        batch = {
            "term_ids": term_ids, "qlen": np.asarray(qlen, np.float32),
            "topic_probs": np.asarray(topic_probs, np.float32),
            "qn": np.asarray(qn, np.int32), "qnb": np.asarray(qnb, np.int32),
            "hot_sids": np.asarray(hot_sids, np.int32),
        }
        shared = {}
        if has_phrase:
            # only the rows holding a phrase go to the matcher: a row with
            # no valid term matches nothing (the JAX package pads the axis
            # to 1 or B rows to bound its compiled shapes)
            live = ph_valid.any(axis=1)
            shared = {"ph_ids": ph_ids[live], "ph_valid": ph_valid[live], "gen": gen_idx[live],
                      "ph_row": np.asarray(phrase_rows, np.int32)[live]}
        return _run_rows(
            sidx, batch_axis, batch, shared,
            lambda shard, s, qi, x: block(shard, s, qi, x, has_phrase), k,
        )

    return run


def make_sharded_mixed_scorer(
    sidx_or_meta,
    topk: int,
    batch_axis: str | None = None,
):
    """The fused mixed lane on the mesh: per shard, K2 (keyword scoring and
    dense in-kernel phrase matching with per-ROW phrase inputs), the hot
    fold, candidacy, finalize and the local top-k; then the merge (cf. the
    single-device engine's fused lane). Needs the position planes
    (ShardedIndex.pos_dense) and untruncated dense rows.

    Returns run(sidx, term_ids [B,Q], qlen [B], topic_probs [B,C],
    ph_ids [B,P], ph_valid [B,P] f32, qn [B], pn [B], qnb [B],
    hot_sids [B,Q]) -> (scores [B,K], global doc ids [B,K]). Reference
    blend only. As in the JAX package, no body_tmax on this lane."""
    meta = scorer_meta(sidx_or_meta) if isinstance(sidx_or_meta, ShardedIndex) else sidx_or_meta
    mesh, ax, dl, cap, pcap, dense_truncated, pos_dense, has_zero_w, hot_h, doc_sorted = meta
    use_hot = hot_h > 0
    if not pos_dense or dense_truncated:
        raise ValueError("mixed scorer needs the dense position layout")
    batch_axis = _batch_axis(mesh, ax, batch_axis)
    k = topk

    def block(shard: Shard, s: int, qi: int, x: dict):
        t, bd = shard.title, shard.body
        # candidacy is derived AFTER the hot fold: a doc matched only by a
        # hot body term must still become a candidate
        ts, tc, bs, bc = _k2.mixed_scores_padded(
            t.fwd.ftT, t.fwd.fwT, bd.fwd.ftT, bd.fwd.fwT, t.posT, bd.posT,
            x["term_ids"], x["qn"], x["ph_ids"], x["ph_valid"], x["pn"],
            emit_counts=has_zero_w, qnb=x["qnb"] if use_hot else None, derive=False,
        )
        if use_hot:
            bs, bc = _hot_fold(shard, x["hot_sids"], bs, bc, bs.shape[1])
        ts, tc, bs, bc = _k2.derive_mixed_counts(ts, tc, bs, bc)
        final = finalize_scores(
            ts, tc, bs, bc, shard.mag_title, shard.mag_body, shard.pagerank,
            x["qlen"], x["topic_probs"],
        )
        return _local_top_k(final, k, shard, s, dl, doc_sorted)

    def run(sidx, term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
            qnb=None, hot_sids=None):
        term_ids = np.asarray(term_ids, np.int32)
        b, q = term_ids.shape
        if qnb is None:
            qnb = qn
        if hot_sids is None:
            hot_sids = np.full((b, q), -1, np.int32)
        batch = {
            "term_ids": term_ids, "qlen": np.asarray(qlen, np.float32),
            "topic_probs": np.asarray(topic_probs, np.float32),
            "ph_ids": np.asarray(ph_ids, np.int32),
            "ph_valid": np.asarray(ph_valid, np.float32),
            "qn": np.asarray(qn, np.int32), "pn": np.asarray(pn, np.int32),
            "qnb": np.asarray(qnb, np.int32), "hot_sids": np.asarray(hot_sids, np.int32),
        }
        return _run_rows(sidx, batch_axis, batch, {}, block, k)

    return run


def sharded_pagerank(
    mesh: Mesh,
    edge_src: np.ndarray,  # int32 [E] sorted by dst
    edge_dst: np.ndarray,  # int32 [E]
    outdeg: np.ndarray,  # f32 [N]
    n_pages: np.ndarray,  # f32 [C]
    n_nodes: int,
    damping: float = 0.75,
    eps: float = 1e-20,
    max_iters: int = 200,
    axis: str = "d",
    stats: dict | None = None,
) -> torch.Tensor:
    """PageRank power iteration (the reference model of ops/pagerank.py)
    with the edge set sharded over the mesh: each shard owns a contiguous
    destination-node range and sums its in-edges on its device with the
    deterministic int32-CSR segment_reduce of ops/pagerank.py; the pieces
    are concatenated into the replicated rank vector on the mesh's first
    device every iteration. One host read of delta per iteration (the JAX
    package's stop rule). -> ranks [C, N] f32 on the first device; `stats`
    receives the iteration count and the last delta."""
    s = mesh.shape[axis]
    nl = -(-max(n_nodes, 1) // s)
    n_pad = s * nl
    devs = list(_doc_grid(mesh, axis)[0])
    first = devs[0]
    edge_src = np.asarray(edge_src, np.int32)
    edge_dst = np.asarray(edge_dst, np.int32)

    outdeg_p = np.zeros(n_pad, np.float32)
    outdeg_p[:n_nodes] = outdeg
    valid = np.zeros(n_pad, np.float32)
    valid[:n_nodes] = 1.0
    shard_of_edge = edge_dst // nl
    shards = []
    for i, dev in enumerate(devs):
        sel = np.flatnonzero(shard_of_edge == i)
        local = edge_dst[sel] - i * nl
        order = np.argsort(local, kind="stable")
        offsets = np.zeros(nl + 1, np.int32)
        offsets[1:] = np.cumsum(np.bincount(local, minlength=nl))
        shards.append((_put(edge_src[sel][order], dev), _put(offsets, dev), dev))

    teleport = 1.0 - damping
    inv_out = _put(
        np.where(outdeg_p > 0, damping / np.maximum(outdeg_p, 1), 0.0).astype(np.float32), first
    )
    valid_t = _put(valid, first)[:, None]
    r0 = _put(1.0 / np.asarray(n_pages, np.float32), first)[None, :] * valid_t  # [N_pad, C]

    def step(r: torch.Tensor, it: int) -> torch.Tensor:
        contrib = r * inv_out[:, None]
        pieces = []
        for src, offsets, dev in shards:
            c = contrib.to(dev)
            pieces.append(
                torch.segment_reduce(c.index_select(0, src), "sum", offsets=offsets, axis=0)
            )
        inherited = torch.cat([p.to(first) for p in pieces])
        total = contrib.sum(dim=0) + teleport * n_nodes
        base = r if it == 0 else 0.0
        return (base + inherited + teleport * valid_t) / total

    return _iterate(step, r0, eps, max_iters, stats)[:n_nodes].t()
