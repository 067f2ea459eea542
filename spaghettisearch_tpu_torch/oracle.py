"""Reference-semantics retrieval oracle.

A direct, slow re-statement of the Go reference's retrieval math
(retrieval/main_retrieve.go, phrase.go, get_metadata.go) over the host store,
used to verify the device programs produce the same candidates and scores.
"""

from __future__ import annotations

import math
import re

from .store.tables import Database
from .text.laundry import laundry
from .utils.hashing import md5_hex

_PHRASE_RE = re.compile(r'".*?"')


def parse(query: str):
    spans = _PHRASE_RE.findall(query)
    phrases = [s[1:-1] for s in spans]
    stripped = query
    for ph in phrases:
        stripped = stripped.replace('"' + ph + '"', "", 1)
    kw = [md5_hex(w) for w in laundry(" ".join(stripped.split()))]
    ph_tok = [md5_hex(w) for w in laundry(" ".join(phrases))]
    return kw, ph_tok


def _intersect(a, b):
    if a is None or b is None:
        return None
    a, b = sorted(a), sorted(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            out.append(a[i])
            i += 1
            j += 1
        elif a[i] > b[j]:
            j += 1
        else:
            i += 1
    return out


def phrase_docs(db: Database, phrase_hashes: list[str]):
    """-> {doc_hash: (title_weight or None, body_weight or None)}"""
    per_term = []  # per term: {doc: (title_listpos, body_listpos)}
    for i, h in enumerate(phrase_hashes):
        title_row = db.inv_title.get(h) or {}
        body_row = db.inv_body.get(h) or {}
        entry = {}
        for doc, lp in body_row.items():
            entry[doc] = [None, [lp[0]] + [p - i for p in lp[1:]]]
        for doc, lp in title_row.items():
            e = entry.setdefault(doc, [None, None])
            e[0] = [lp[0]] + [p - i for p in lp[1:]]
        per_term.append(entry)

    all_docs = set()
    for e in per_term:
        all_docs |= set(e)

    out = {}
    for doc in all_docs:
        if not all(doc in e for e in per_term):
            continue
        sum_t, sum_b = 0.0, 0.0
        t_int, b_int = None, None
        first_t, first_b = per_term[0][doc]
        if first_b:
            sum_b += first_b[0]
            b_int = first_b[1:]
        if first_t:
            sum_t += first_t[0]
            t_int = first_t[1:]
        for e in per_term[1:]:
            tl, bl = e[doc]
            if not bl:
                b_int = None
            else:
                sum_b += bl[0]
                b_int = _intersect(b_int, bl[1:])
            if not tl:
                t_int = None
            else:
                sum_t += tl[0]
                t_int = _intersect(t_int, tl[1:])
        tw = sum_t if t_int else None
        bw = sum_b if b_int else None
        if tw is not None or bw is not None:
            out[doc] = (tw, bw)
    return out


def retrieve(
    db: Database,
    query: str,
    topk: int = 50,
    topic_probs: dict[str, float] | None = None,
):
    """-> list of (doc_hash, final_rank) sorted desc (ties by doc_hash).

    topic_probs (category -> probability) adds the reference's
    topic-sensitive importance term 0.33 * (probs . pagerank[doc]) for
    candidate docs (main_retrieve.go:87-88 + get_metadata.go:69); None
    reproduces the shipped topic-model-off behavior (sqd = 0)."""
    kw, ph = parse(query)
    qlen = len(kw) + len(ph)
    agg: dict[str, dict[str, list[float]]] = {}

    for h in kw:
        for section, table in (("title", db.inv_title), ("body", db.inv_body)):
            row = table.get(h) or {}
            for doc, lp in row.items():
                agg.setdefault(doc, {"title": [], "body": []})[section].append(lp[0])

    if ph:
        for doc, (tw, bw) in phrase_docs(db, ph).items():
            entry = agg.setdefault(doc, {"title": [], "body": []})
            if tw is not None:
                entry["title"].append(tw)
            if bw is not None:
                entry["body"].append(bw)

    results = []
    qmag = math.sqrt(qlen)
    for doc, w in agg.items():
        mags = db.doc_magnitude.get(doc) or {}
        tr = sum(w["title"])
        br = sum(w["body"])
        denom_t = mags.get("title", 0.0) * qmag
        denom_b = mags.get("body", 0.0) * qmag
        tr = tr / denom_t if denom_t != 0 else (math.inf if tr > 0 else 0.0)
        br = br / denom_b if denom_b != 0 else (math.inf if br > 0 else 0.0)
        sqd = 0.0
        if topic_probs:
            ranks = db.doc_rank.get(doc) or {}
            sqd = sum(p * ranks.get(c, 0.0) for c, p in topic_probs.items())
        final = (0.33 * sqd + 0.38 * tr + 0.29 * br) * 100.0
        results.append((doc, final))

    results.sort(key=lambda kv: (-kv[1], kv[0]))
    return results[:topk]
