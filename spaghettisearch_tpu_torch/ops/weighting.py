"""TF-IDF term weighting and per-document vector magnitudes.

Equivalent of the reference's batch job (reference: ranking/term_weighting.go:
10-123): for every inverted row, idf = log2(N/df) with N = the doc-rank-table
census; the stored normalized TF is multiplied in place, and each document
accumulates sum-of-squared weights whose square root is stored per section in
the magnitude table.

Unlike the reference (which multiplies idf into the stored value in place and
therefore corrupts weights when run more than once per store,
term_weighting.go:42), this pass derives each weight from the RAW normTF
shadow tables (inv_title_raw / inv_body_raw) written by the indexer, so it is
idempotent and re-crawl safe. Stores predating the shadow tables fall back to
the stored vals[0] per row — one run behaves exactly like the reference. The
crawl command still runs it after PageRank (which populates the census),
cf. cmd/crawl/start_crawl.go:174-177.

All arithmetic is float32, matching the reference and the device arrays.
"""

from __future__ import annotations

import numpy as np

from ..store.tables import Database


def update_term_weights(db: Database, section: str, total_docs: int | None = None) -> None:
    n = float(total_docs if total_docs is not None else len(db.doc_rank))
    inv = db.inverted(section)
    raw = db.inverted_raw(section)

    # weights multiply in float32; squared weights accumulate in float64,
    # matching the reference's mixed precision (term_weighting.go:37-44).
    # Unlike the reference (which multiplies the stored value in place and
    # therefore corrupts weights when run more than once per store,
    # term_weighting.go:42), the weight derives from the RAW normTF shadow
    # row — this pass is idempotent and re-crawl safe.

    # Native fast path: one C++ pass parses, reweights, and rewrites every
    # row (native/fastkv.cpp fastkv_apply_term_weights) — the previous
    # Python loop was O(total postings) JSON decode+encode, ~50 s at 100k
    # docs. Python fallback below is the semantics oracle (bit-identical,
    # tests/test_weighting_native.py).
    if (
        hasattr(inv._kv, "apply_term_weights")
        and hasattr(raw._kv, "_h")
        # bulk-mode write-back caches must flow the Python path (the native
        # pass reads/writes the backend directly)
        and inv._cache is None
        and raw._cache is None
    ):
        from ..index.snapshot import export_postings

        flat = export_postings(inv)
        if flat is not None and len(flat[0]):
            row_keys, row_offsets = flat[0], flat[1]
            df = np.diff(row_offsets.astype(np.int64))
            idf = np.log2(np.float64(n) / df.astype(np.float64)).astype(np.float32)
            out = inv._kv.apply_term_weights(
                raw._kv, row_keys, idf.astype(np.float64)
            )
            if out is not None:
                docs, sums = out
                with db.doc_magnitude.batch() as bw:
                    for doc_hash, sq in zip(docs, sums):
                        doc_hash = doc_hash.decode()
                        mags = db.doc_magnitude.get(doc_hash) or {}
                        mags[section] = float(np.sqrt(sq))
                        bw.set(doc_hash, mags)
                return
        elif flat is not None:
            return  # empty table: nothing to weight

    page_sq_sum: dict[str, float] = {}
    with inv.batch() as bw:
        for word_hash, row in inv.items():
            idf = np.float32(np.log2(np.float64(n) / np.float64(len(row))))
            rrow = raw.get(word_hash) or {}
            for doc_hash, vals in row.items():
                base = np.float32(rrow.get(doc_hash, vals[0]))
                w = base * idf
                vals[0] = float(w)
                page_sq_sum[doc_hash] = page_sq_sum.get(doc_hash, 0.0) + float(w) * float(w)
            bw.set(word_hash, row)

    with db.doc_magnitude.batch() as bw:
        for doc_hash, sq in page_sq_sum.items():
            mags = db.doc_magnitude.get(doc_hash) or {}
            mags[section] = float(np.sqrt(sq))
            bw.set(doc_hash, mags)
