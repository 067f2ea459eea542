"""Columnar index snapshots: the device-resident form of the inverted index.

The reference keeps postings as JSON rows in an LSM tree and walks them
row-at-a-time with goroutines (database/database.go, retrieval/). The
TPU-native representation is padded CSR in HBM:

per section (title/body):
  post_offsets  int32 [V+1]   postings range per word_id
  doc_ids       int32 [P_pad] doc_id per posting, sorted per row; pad = n_docs
  weights       f32   [P_pad] normTF (or normTF*idf once weighted)
  pos_offsets   int32 [P+1]   positions range per posting
  positions     f32   [L_pad] sorted ascending; meta/anchor sentinel -100;
                              pad = +inf (matches nothing)

plus doc-level arrays: magnitudes [D] per section, PageRank [D, C].

Doc ids and word ids are assigned by sorted hash, so snapshots are
deterministic functions of store content.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..store.tables import Database

_PAD = 128


def _pad_to(n: int, m: int = _PAD) -> int:
    """Next multiple of m strictly greater than n: gather kernels use the
    final pad slot as an always-safe sentinel, so at least one must exist."""
    return (n // m + 1) * m


@dataclass
class SectionCSR:
    post_offsets: np.ndarray  # int32 [V+1]
    doc_ids: np.ndarray  # int32 [P_pad]
    weights: np.ndarray  # f32  [P_pad]
    pos_offsets: np.ndarray  # int32 [P_pad+1]
    positions: np.ndarray  # f32  [L_pad]
    n_postings: int
    max_df: int
    max_positions: int

    @classmethod
    def build(
        cls,
        rows: dict[str, dict[str, list[float]]],
        word_id: dict[str, int],
        doc_id: dict[str, int],
        n_words: int,
        n_docs: int,
    ) -> "SectionCSR":
        counts = np.zeros(n_words + 1, dtype=np.int64)
        for wh, row in rows.items():
            counts[word_id[wh] + 1] = len(row)
        post_offsets = np.cumsum(counts).astype(np.int32)
        n_post = int(post_offsets[-1])

        p_pad = _pad_to(n_post)
        doc_ids = np.full(p_pad, n_docs, dtype=np.int32)
        weights = np.zeros(p_pad, dtype=np.float32)
        pos_counts = np.zeros(p_pad + 1, dtype=np.int64)
        max_df = 0
        max_pos = 0

        # fill postings sorted by doc_id within each word row
        pos_lists: list[list[float]] = [[] for _ in range(n_post)]
        for wh, row in rows.items():
            base = int(post_offsets[word_id[wh]])
            max_df = max(max_df, len(row))
            entries = sorted((doc_id[dh], vals) for dh, vals in row.items())
            for k, (did, vals) in enumerate(entries):
                j = base + k
                doc_ids[j] = did
                weights[j] = np.float32(vals[0])
                plist = sorted(vals[1:])
                pos_lists[j] = plist
                pos_counts[j + 1] = len(plist)
                max_pos = max(max_pos, len(plist))

        pos_offsets = np.cumsum(pos_counts[: n_post + 1]).astype(np.int32)
        # extend offsets so padded posting slots map to an empty range
        pos_offsets = np.concatenate(
            [pos_offsets, np.full(p_pad - n_post, pos_offsets[-1], dtype=np.int32)]
        )
        l_pad = _pad_to(int(pos_offsets[n_post]))
        positions = np.full(l_pad, np.inf, dtype=np.float32)
        cursor = 0
        for plist in pos_lists:
            positions[cursor : cursor + len(plist)] = plist
            cursor += len(plist)

        return cls(
            post_offsets=post_offsets,
            doc_ids=doc_ids,
            weights=weights,
            pos_offsets=pos_offsets,
            positions=positions,
            n_postings=n_post,
            max_df=max_df,
            max_positions=max_pos,
        )

    def forward(self, n_docs: int) -> tuple[np.ndarray, np.ndarray]:
        """Doc-major ("forward") view: per-doc term ids + weights.

        -> (ft int32 [D, T_pad] with -1 padding, fw f32 [D, T_pad]).
        This is the layout the TPU keyword scorer consumes: scoring becomes a
        dense compare/weighted-reduce over [B, D, T] with no scatter/gather
        (ops/scoring.py), which measures ~200x faster than scatter-add on
        TPU. T_pad is the max distinct terms of any doc, rounded up."""
        ft, fw, _ = self.forward_with_postings(n_docs)
        return ft, fw

    def forward_with_postings(
        self, n_docs: int, doc_term_cap: int | None = 4096
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """forward() plus fj int32 [D, T_pad]: each doc-term's global posting
        index into this CSR (pad slots point at the CSR's always-empty final
        pad posting), used by the phrase kernel to jump from a matched
        doc-term straight to its position list.

        doc_term_cap bounds T_pad: forward-array memory scales with the
        LONGEST document's distinct-term count, so one pathological page
        (tens of thousands of distinct words) would otherwise multiply HBM
        use for the whole corpus. Docs past the cap keep only their
        top-cap terms by weight in the DENSE view (logged); the CSR stays
        complete, so the parity-oracle scatter path remains exact. Pass
        None for the exact (unbounded) dense view."""
        n_words = self.post_offsets.shape[0] - 1
        n_post = self.n_postings
        word_of_post = np.repeat(
            np.arange(n_words, dtype=np.int32), np.diff(self.post_offsets)
        )
        docs = self.doc_ids[:n_post]
        post_idx = np.arange(n_post, dtype=np.int64)
        counts = np.bincount(docs, minlength=n_docs) if n_post else np.zeros(n_docs, np.int64)
        if doc_term_cap is not None and n_post and counts.max(initial=0) > doc_term_cap:
            import logging

            n_over = int((counts > doc_term_cap).sum())
            logging.getLogger("spaghettisearch.index").warning(
                "dense forward view truncating %d doc(s) with >%d distinct "
                "terms to their top-%d by weight (max was %d); CSR paths "
                "stay exact",
                n_over, doc_term_cap, doc_term_cap, int(counts.max()),
            )
            # rank each doc's postings by descending weight, keep top-cap
            rank_order = np.lexsort((-self.weights[:n_post], docs))
            docs_r = docs[rank_order]
            off = np.concatenate([[0], np.cumsum(np.bincount(docs_r, minlength=n_docs))])
            rank_in_doc = np.arange(n_post, dtype=np.int64) - off[docs_r]
            keep = rank_in_doc < doc_term_cap
            post_idx = rank_order[keep]
            docs = docs[post_idx]
            counts = np.bincount(docs, minlength=n_docs)
        order = post_idx[np.argsort(docs, kind="stable")]
        docs_s = self.doc_ids[order]
        t_pad = max(-(-int(counts.max(initial=0)) // 8) * 8, 8)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        slot = np.arange(len(order), dtype=np.int64) - offsets[docs_s]
        ft = np.full((n_docs, t_pad), -1, np.int32)
        fw = np.zeros((n_docs, t_pad), np.float32)
        fj = np.full((n_docs, t_pad), self.doc_ids.shape[0] - 1, np.int32)
        ft[docs_s, slot] = word_of_post[order]
        fw[docs_s, slot] = self.weights[order]
        fj[docs_s, slot] = order.astype(np.int32)
        return ft, fw, fj

    @classmethod
    def from_flat(
        cls,
        row_keys: np.ndarray,  # S32 [R] word hashes (any order)
        row_offsets: np.ndarray,  # u64 [R+1] into postings
        doc_hashes: np.ndarray,  # S32 [P]
        weights: np.ndarray,  # f64 [P]
        pos_offsets: np.ndarray,  # u64 [P+1]
        positions: np.ndarray,  # f64 [L]
        word_sorted: np.ndarray,  # S32 [V] sorted global word hashes
        doc_sorted: np.ndarray,  # S32 [D] sorted doc census
    ) -> "SectionCSR":
        """Vectorized CSR assembly from a flat postings export — O(P log P)
        numpy instead of the per-posting Python loop in build()."""
        n_words, n_docs = len(word_sorted), len(doc_sorted)
        n_post = len(weights)
        row_offsets = row_offsets.astype(np.int64)
        pos_offsets64 = pos_offsets.astype(np.int64)

        word_of_row = np.searchsorted(word_sorted, row_keys)
        word_of_post = np.repeat(word_of_row, np.diff(row_offsets))
        doc_of_post = np.searchsorted(doc_sorted, doc_hashes)
        if n_post:
            bad = doc_of_post >= n_docs
            if n_docs:
                safe = np.where(bad, 0, doc_of_post)
                bad = bad | (doc_sorted[safe] != doc_hashes)
            if bad.any():
                raise KeyError(doc_hashes[bad][0].decode())
        doc_of_post = doc_of_post.astype(np.int32)

        order = np.lexsort((doc_of_post, word_of_post))
        counts = np.bincount(word_of_post, minlength=n_words)
        post_offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)

        p_pad = _pad_to(n_post)
        doc_ids = np.full(p_pad, n_docs, dtype=np.int32)
        doc_ids[:n_post] = doc_of_post[order]
        w = np.zeros(p_pad, dtype=np.float32)
        w[:n_post] = weights[order]

        pos_len = np.diff(pos_offsets64)
        pos_len_o = pos_len[order]
        new_pos_off = np.concatenate([[0], np.cumsum(pos_len_o)]).astype(np.int32)
        # gather each posting's position segment into the new order, then
        # sort ascending WITHIN each segment (anchor/meta -100s lead)
        starts = pos_offsets64[:-1][order]
        total = int(pos_len_o.sum())
        if total:
            shift = np.repeat(np.cumsum(pos_len_o) - pos_len_o, pos_len_o)
            src = np.arange(total, dtype=np.int64) - shift + np.repeat(starts, pos_len_o)
            pos = positions[src]
            seg = np.repeat(np.arange(n_post, dtype=np.int64), pos_len_o)
            pos = pos[np.lexsort((pos, seg))]
        else:
            pos = np.zeros(0, np.float64)
        pos_offsets_out = np.concatenate(
            [new_pos_off, np.full(p_pad - n_post, new_pos_off[-1], dtype=np.int32)]
        )
        l_pad = _pad_to(total)
        positions_out = np.full(l_pad, np.inf, dtype=np.float32)
        positions_out[:total] = pos

        return cls(
            post_offsets=post_offsets,
            doc_ids=doc_ids,
            weights=w,
            pos_offsets=pos_offsets_out,
            positions=positions_out,
            n_postings=n_post,
            max_df=int(counts.max(initial=0)),
            max_positions=int(pos_len.max(initial=0)),
        )

    def df(self, word_ids: np.ndarray) -> np.ndarray:
        """Document frequency per word id; the unknown-word sentinel
        (id >= n_words) has df 0."""
        wid = np.asarray(word_ids)
        n_words = self.post_offsets.shape[0] - 1
        safe = np.minimum(wid, n_words - 1)
        raw = self.post_offsets[safe + 1] - self.post_offsets[safe]
        return np.where(wid < n_words, raw, 0)


@dataclass
class IndexSnapshot:
    doc_hashes: list[str]
    word_hashes: list[str]
    doc_id: dict[str, int]
    word_id: dict[str, int]
    title: SectionCSR
    body: SectionCSR
    mag_title: np.ndarray  # f32 [D]
    mag_body: np.ndarray  # f32 [D]
    categories: list[str] = field(default_factory=list)
    pagerank: np.ndarray | None = None  # f32 [D, C]
    #: directory this snapshot was loaded from (persist.load_snapshot);
    #: None for snapshots built in memory. Gates the hydration sidecar —
    #: derived caches persist next to the snapshot they belong to.
    source_dir: str | None = None

    @property
    def n_docs(self) -> int:
        return len(self.doc_hashes)

    @property
    def n_words(self) -> int:
        return len(self.word_hashes)

    def section(self, name: str) -> SectionCSR:
        return self.title if name == "title" else self.body

    def term_ids(self, word_hashes: list[str]) -> np.ndarray:
        """Map word hashes to ids; unknown words get the sentinel empty row
        (id = n_words, whose postings range is empty)."""
        return np.array(
            [self.word_id.get(h, self.n_words) for h in word_hashes], dtype=np.int32
        )


def export_postings(table) -> tuple[np.ndarray, ...]:
    """Flat postings export of an inverted/raw table: (row_keys S32 [R],
    row_offsets [R+1], doc_hashes S32 [P], weights f64 [P],
    pos_offsets [P+1], positions f64 [L]). Native single-pass parse on the
    C++ backend (native/fastkv.cpp fastkv_export_postings); Python walk
    otherwise."""
    kv = getattr(table, "_kv", None)
    if hasattr(kv, "export_postings"):
        flat = kv.export_postings()
        if flat is not None:
            return flat
    row_keys: list[str] = []
    row_off = [0]
    docs: list[str] = []
    weights: list[float] = []
    pos_off = [0]
    positions: list[float] = []
    for k, row in table.items():
        row_keys.append(k)
        for dh, vals in row.items():
            docs.append(dh)
            if isinstance(vals, list):
                weights.append(vals[0])
                positions.extend(vals[1:])
            else:
                weights.append(vals)
            pos_off.append(len(positions))
        row_off.append(len(docs))
    return (
        np.asarray(row_keys, dtype="S32"),
        np.asarray(row_off, dtype=np.int64),
        np.asarray(docs, dtype="S32"),
        np.asarray(weights, dtype=np.float64),
        np.asarray(pos_off, dtype=np.int64),
        np.asarray(positions, dtype=np.float64),
    )


def build_snapshot(db: Database) -> IndexSnapshot:
    """Snapshot the store into columnar arrays.

    The doc census is every DocInfo row (crawled docs + stub children) —
    the same census the reference uses for idf (its rank table rows,
    ranking/term_weighting.go:12-17, cover exactly these). Postings flow
    through export_postings + SectionCSR.from_flat: one native parse pass
    plus vectorized assembly (the previous per-posting Python loop was the
    /refresh wall-clock at crawl scale)."""
    doc_hashes = sorted(db.doc_info.keys())
    doc_id = {h: i for i, h in enumerate(doc_hashes)}
    doc_sorted = np.asarray(doc_hashes, dtype="S32")

    t_flat = export_postings(db.inv_title)
    b_flat = export_postings(db.inv_body)
    word_sorted = np.union1d(t_flat[0], b_flat[0])
    word_hashes = [h.decode() for h in word_sorted]
    word_id = {h: i for i, h in enumerate(word_hashes)}

    n_words, n_docs = len(word_hashes), len(doc_hashes)
    title = SectionCSR.from_flat(*t_flat, word_sorted, doc_sorted)
    body = SectionCSR.from_flat(*b_flat, word_sorted, doc_sorted)

    mag_title = np.zeros(n_docs, dtype=np.float32)
    mag_body = np.zeros(n_docs, dtype=np.float32)
    for dh, mags in db.doc_magnitude.items():
        i = doc_id.get(dh)
        if i is not None:
            mag_title[i] = np.float32(mags.get("title", 0.0))
            mag_body[i] = np.float32(mags.get("body", 0.0))

    categories: list[str] = sorted(db.topic_meta.keys())
    pagerank = None
    if categories:
        cat_id = {c: j for j, c in enumerate(categories)}
        pagerank = np.zeros((n_docs, len(categories)), dtype=np.float32)
        for dh, ranks in db.doc_rank.items():
            i = doc_id.get(dh)
            if i is None:
                continue
            for c, r in ranks.items():
                j = cat_id.get(c)
                if j is not None:
                    pagerank[i, j] = np.float32(r)

    return IndexSnapshot(
        doc_hashes=doc_hashes,
        word_hashes=word_hashes,
        doc_id=doc_id,
        word_id=word_id,
        title=title,
        body=body,
        mag_title=mag_title,
        mag_body=mag_body,
        categories=categories,
        pagerank=pagerank,
    )


def _slice_section(csr: SectionCSR, n_keep: int) -> SectionCSR:
    """Restrict a section's CSR to doc ids < n_keep (postings stay sorted by
    doc within each word row, so filtering preserves the layout contract)."""
    n_post = csr.n_postings
    n_words = len(csr.post_offsets) - 1
    doc = csr.doc_ids[:n_post]
    keep = doc < n_keep
    word_of = np.repeat(
        np.arange(n_words, dtype=np.int64),
        np.diff(csr.post_offsets.astype(np.int64)),
    )
    counts = np.bincount(word_of[keep], minlength=n_words)
    post_offsets = np.zeros(n_words + 1, np.int64)
    np.cumsum(counts, out=post_offsets[1:])
    new_npost = int(post_offsets[-1])

    p_pad = _pad_to(new_npost)
    doc_ids = np.full(p_pad, n_keep, dtype=np.int32)
    weights = np.zeros(p_pad, dtype=np.float32)
    doc_ids[:new_npost] = doc[keep]
    weights[:new_npost] = csr.weights[:n_post][keep]

    pos_cnt = np.diff(csr.pos_offsets[: n_post + 1].astype(np.int64))
    kept_cnt = pos_cnt[keep]
    pos_offsets = np.zeros(new_npost + 1, np.int64)
    np.cumsum(kept_cnt, out=pos_offsets[1:])
    total = int(pos_offsets[-1])
    l_pad = _pad_to(total)
    positions = np.full(l_pad, np.inf, dtype=np.float32)
    if total:
        starts = csr.pos_offsets[:n_post][keep].astype(np.int64)
        idx = np.repeat(starts - pos_offsets[:-1], kept_cnt) + np.arange(total)
        positions[:total] = csr.positions[idx]
    pos_offsets = np.concatenate(
        [pos_offsets, np.full(p_pad - new_npost, total, dtype=np.int64)]
    ).astype(np.int32)

    return SectionCSR(
        post_offsets=post_offsets.astype(np.int32),
        doc_ids=doc_ids,
        weights=weights,
        pos_offsets=pos_offsets,
        positions=positions,
        n_postings=new_npost,
        max_df=int(counts.max(initial=0)),
        max_positions=int(kept_cnt.max(initial=0)),
    )


def slice_snapshot(snap: IndexSnapshot, n_keep: int) -> IndexSnapshot:
    """The first n_keep docs of a snapshot as a standalone snapshot —
    exactly the doc range shard 0 of a contiguous doc-sharded mesh serves
    (parallel/sharded.py ShardedIndex.from_snapshot), with the GLOBAL term
    weights baked into the postings kept as-is. Built for shard-scale
    device measurements on a single chip (experiments/shard_scale_probe.py)
    and shard-local tooling; per-doc scores equal the full snapshot's."""
    n_keep = min(n_keep, snap.n_docs)
    kept_hashes = snap.doc_hashes[:n_keep]
    return IndexSnapshot(
        doc_hashes=kept_hashes,
        word_hashes=snap.word_hashes,
        doc_id={h: i for i, h in enumerate(kept_hashes)},
        word_id=snap.word_id,
        title=_slice_section(snap.title, n_keep),
        body=_slice_section(snap.body, n_keep),
        mag_title=snap.mag_title[:n_keep],
        mag_body=snap.mag_body[:n_keep],
        categories=snap.categories,
        pagerank=None if snap.pagerank is None else snap.pagerank[:n_keep],
        source_dir=None,
    )
