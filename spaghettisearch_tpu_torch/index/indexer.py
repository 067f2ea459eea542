"""Incremental document indexing into the host store.

Behavioral equivalent of the reference's indexer (reference:
indexer/indexer.go:24-348 `Index`, 350-408 `setInverted`, 420-641
`checkAndUpdate`), restructured: instead of per-word goroutine bursts under a
global mutex, each page's postings are computed in memory and written in one
batch per table. Semantics preserved:

- posting rows: inv[word][doc] = [normTF, pos...] with normTF = freq/maxFreq
  per section; meta/anchor positions use the -100 sentinel.
- anchor texts index into the *title* table under the child's doc hash,
  creating stub DocInfo records for never-crawled children.
- re-index gate: skip when Last-Modified is not newer; when the cached raw
  document content changed, purge the old postings first.

Positions within a posting are stored sorted ascending; the reference stores
them unsorted but sorts before any use (retrieval/util.go:162-203), so the
observable behavior is identical.
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np

from ..config import META_POSITION
from ..store.docinfo import ZERO_TIME, DocInfo
from ..store.tables import _DELETED, Database
from ..text.laundry import laundry
from ..text.page import ParsedPage, parse_page
from ..utils.hashing import md5_hex, md5_str


import struct

_F32 = struct.Struct("<f")


def _f32(x: float) -> float:
    """Round one value through float32: postings are float32 on device and
    in the reference, so the store must hold what the device will see.
    Only normTF needs this — positions are small integers (and the -100
    sentinel), exactly representable in f32 below 2^24 tokens/doc. The
    per-posting numpy round-trip this replaces was ~16% of the bulk
    indexing profile."""
    return _F32.unpack(_F32.pack(x))[0]


def index_page(
    db: Database,
    raw: bytes,
    url: str,
    last_modified: datetime | None = None,
    page_size: int | None = None,
    parent_url: str = "",
    page: ParsedPage | None = None,
) -> str:
    """Index one fetched page. Returns the doc hash."""
    doc_hash = md5_hex(url)
    if last_modified is None:
        last_modified = datetime.now(timezone.utc)

    old: DocInfo | None = db.doc_info.get(doc_hash)
    was_real_doc = False
    if old is not None:
        if last_modified <= old.mod_date:
            return doc_hash  # not newer: skip (reference: indexer.go:59-62)
        if not old.is_stub:
            was_real_doc = True
            cached = db.cached_doc(doc_hash)
            if cached is not None:
                if md5_hex(cached) != md5_hex(raw):
                    _purge_old(db, doc_hash, old, cached)
                # identical content falls through to a harmless re-write,
                # matching the reference's control flow (indexer.go:635-639)

    if page is None:
        page = parse_page(raw, url)

    page_title = page.title_text.split()
    size = page_size if page_size is not None else len(raw)

    word_mapping = {md5_str(w): f for w, f in page.body.freq.items()}
    kids = [md5_str(child) for child in page.links]

    # --- postings for title and body sections ---
    _set_section_postings(db, "title", page.title, doc_hash)
    _set_section_postings(db, "body", page.body, doc_hash)

    # --- anchor-text postings + child stubs ---
    _index_anchors(db, doc_hash, page, kids)

    # --- link graph row ---
    db.doc_children.set(doc_hash, kids)

    # --- this doc's DocInfo ---
    if old is not None and was_real_doc:
        info = DocInfo(
            url=old.url,
            page_title=page_title,
            mod_date=last_modified,
            page_size=size,
            children=kids,
            parents=old.parents,
            words_mapping=word_mapping,
        )
    else:
        parents = dict(old.parents) if old is not None else {}
        if parent_url:
            parents.setdefault(md5_hex(parent_url), [])
        info = DocInfo(
            url=url,
            page_title=page_title,
            mod_date=last_modified,
            page_size=size,
            children=kids,
            parents=parents,
            words_mapping=word_mapping,
        )
    db.doc_info.set(doc_hash, info)

    # summary-visible words, persisted so serving never re-parses the HTML
    db.doc_summary.set(doc_hash, " ".join(page.raw.summary))
    db.note_doc_write()  # invalidate in-process summary caches

    db.cache_doc(doc_hash, raw)
    return doc_hash


def _set_section_postings(db: Database, section: str, stats, doc_hash: str) -> None:
    """Write [normTF, pos...] rows for every term of one section
    (reference: indexer/indexer.go:350-408)."""
    max_freq = float(stats.max_freq)
    if max_freq == 0:
        return
    inv = db.inverted(section)
    raw = db.inverted_raw(section)
    if inv._cache is not None:
        # Bulk fast path: ~160 row touches per page make the per-posting
        # Table dispatches (get_row_for_update x2 + __contains__) the
        # single hottest slice of the crawl-build profile — operate on the
        # write-back cache dicts directly. Word rows are append-only (no
        # delete path exists), so a word seen in the backend can be
        # memoized into the cache by value: the value under md5(w) is w.
        ic, idirty, iget = inv._cache, inv._dirty, inv.get
        rc, rdirty, rget = raw._cache, raw._dirty, raw.get
        word_t = db.word
        wc, wdirty, word_kv = word_t._cache, word_t._dirty, word_t._kv
        items = stats.pos.items()
        # one f64 divide + f32 round per term, vectorized (matches _f32's
        # double-rounding exactly: f64 quotient, then round to f32)
        lens = np.fromiter((len(ps) for _, ps in items), np.float64, len(items))
        ntfs = (lens / max_freq).astype(np.float32).tolist()
        whs = []
        for (word, positions), norm_tf in zip(items, ntfs):
            word_hash = md5_str(word)
            whs.append(word_hash)
            cur = wc.get(word_hash)
            if cur is None or cur is _DELETED:
                # tombstoned or uncached: a backend hit just memoizes (the
                # value under md5(w) is definitionally w), anything else is
                # a fresh word row to write back
                if cur is _DELETED or word_kv.get(word_hash) is None:
                    wdirty.add(word_hash)
                wc[word_hash] = word
            row = ic.get(word_hash)
            if type(row) is not dict:  # absent or tombstone: load/create
                row = iget(word_hash) or {}
                ic[word_hash] = row
            row[doc_hash] = [norm_tf] + sorted(positions)
            rrow = rc.get(word_hash)
            if type(rrow) is not dict:
                rrow = rget(word_hash) or {}
                rc[word_hash] = rrow
            rrow[doc_hash] = norm_tf
        idirty.update(whs)
        rdirty.update(whs)
        return
    with db.word.batch() as bw_word, inv.batch() as bw_inv, raw.batch() as bw_raw:
        for word, positions in stats.pos.items():
            word_hash = md5_hex(word)
            if word_hash not in db.word:
                bw_word.set(word_hash, word)
            norm_tf = _f32(len(positions) / max_freq)
            row = inv.get_row_for_update(word_hash)
            row[doc_hash] = [norm_tf] + sorted(positions)
            rrow = raw.get_row_for_update(word_hash)
            rrow[doc_hash] = norm_tf
            bw_inv.set(word_hash, row)
            bw_raw.set(word_hash, rrow)


def _index_anchors(db: Database, doc_hash: str, page: ParsedPage, kids: list[str]) -> None:
    """Index each child's anchor text into the title table under the child's
    hash (reference: indexer/indexer.go:163-299, the Google-paper trick)."""
    kid_urls = {md5_hex(u): u for u in page.links}
    # rows already updated for an earlier kid in this page; the reference
    # flushes its anchor batch once per kid (indexer.go:293) so later kids
    # observe earlier kids' rows
    pending_rows: dict[str, dict] = {}
    pending_raw: dict[str, dict] = {}  # same read-your-writes for raw rows
    raw = db.inverted_raw("title")
    with (
        db.doc_info.batch() as bw_child,
        db.inv_title.batch() as bw_anchor,
        db.word.batch() as bw_word,
        raw.batch() as bw_raw,
    ):
        for kid in kids:
            anchor_tokens = page.clean_fancy.get(kid, [])
            child_info: DocInfo | None = db.doc_info.get(kid)

            counts: dict[str, int] = {}
            positions: dict[str, list[float]] = {}
            for w in anchor_tokens:
                counts[w] = counts.get(w, 0) + 1
                positions.setdefault(w, []).append(META_POSITION)
            anchor_words = list(counts)

            if child_info is None:
                bw_child.set(
                    kid,
                    DocInfo(
                        url=kid_urls[kid],
                        parents={doc_hash: list(anchor_tokens)},
                        mod_date=ZERO_TIME,
                    ),
                )
                max_freq = max(counts.values(), default=0)
            else:
                child_info.parents[doc_hash] = list(anchor_tokens)
                bw_child.set(kid, child_info)
                # merge the child's raw title words into freq/pos before
                # normalizing, matching indexer.go:240-256 (only anchor words
                # get postings written, but the title inflates maxFreq and can
                # contribute real positions when a stemmed anchor word equals
                # a raw title word)
                for i, w in enumerate(child_info.page_title):
                    counts[w] = counts.get(w, 0) + 1
                    positions.setdefault(w, []).append(float(i))
                max_freq = max(counts.values(), default=0)

            for w in anchor_words:
                word_hash = md5_hex(w)
                norm_tf = _f32(float(counts[w]) / float(max_freq))
                row = pending_rows.get(word_hash)
                if row is None:
                    row = db.inv_title.get(word_hash)
                if row is None:
                    row = {}
                    if word_hash not in db.word:
                        bw_word.set(word_hash, w)
                row[kid] = [norm_tf] + sorted(positions[w])
                pending_rows[word_hash] = row
                bw_anchor.set(word_hash, row)
                rrow = pending_raw.get(word_hash)
                if rrow is None:
                    rrow = raw.get(word_hash) or {}
                rrow[kid] = norm_tf
                pending_raw[word_hash] = rrow
                bw_raw.set(word_hash, rrow)


def _purge_old(
    db: Database, doc_hash: str, old: DocInfo, cached: bytes | None = None
) -> None:
    """Remove a changed document's stale postings and its anchor contributions
    to its children (reference: indexer/indexer.go:420-641).

    Deliberate divergence: the reference enumerates the old title-section
    words from `dI.Page_title` ONLY (indexer.go:452-472), so meta
    description/keywords terms — which ARE indexed into the title table
    with the -100 sentinel (parser.go:59-73) — leak stale postings when a
    page's <meta> content changes. Here the old cached HTML (always present
    when a purge runs: the change gate hashed it) is re-tokenized, so the
    purge set is exactly the old title-section vocabulary. The reference's
    leak is reproduced nowhere; tests/test_indexer.py pins this fix with
    meta-mutating pages forced into the incremental-vs-fresh property."""

    def drop_from_row(inv, word_hash: str, victim: str) -> None:
        row = inv.get(word_hash)
        if row is None or victim not in row:
            return
        if len(row) > 1:
            del row[victim]
            inv.set(word_hash, row)
        else:
            inv.delete(word_hash)

    def drop(section: str, word_hash: str, victim: str) -> None:
        drop_from_row(db.inverted(section), word_hash, victim)
        drop_from_row(db.inverted_raw(section), word_hash, victim)

    title_words: list[str] | None = None
    if cached is not None:
        try:
            old_page = parse_page(cached, old.url)
            title_words = list(old_page.title.pos)  # title + meta terms
        except Exception:
            title_words = None
    if title_words is None:  # no cache/unparseable: reference behavior
        title_words = laundry(" ".join(old.page_title))
    for word in title_words:
        drop("title", md5_hex(word), doc_hash)
    for word_hash in old.words_mapping:
        drop("body", word_hash, doc_hash)

    for child_hash in old.children:
        child: DocInfo | None = db.doc_info.get(child_hash)
        if child is None:
            continue
        anchor_tokens = child.parents.pop(doc_hash, [])
        db.doc_info.set(child_hash, child)
        for w in anchor_tokens:
            drop("title", md5_hex(w), child_hash)
