"""Dynamic document summaries from the raw-HTML cache.

Reproduces the reference's summary logic (reference:
retrieval/get_metadata.go:79-209): re-extract visible text (pruning
a/nav/title/script/style/noscript/iframe subtrees), find the first word
matching any phrase (consecutively) or any query keyword, and emit a
~20-word window with ellipses; otherwise fall back to the middle 21 words.

Serving-path speed: the reference re-parses the cached HTML and scans every
word per result per query (get_metadata.go:85-191). Here the per-doc text is
parsed once (LRU) together with a first-occurrence index and per-word
position lists, so a keyword match is O(query terms) dict lookups and a
phrase match only probes the first phrase word's occurrences — the linear
scan exists only as the test oracle (tests/test_summary_fast.py).
"""

from __future__ import annotations

import math
import re
from collections import OrderedDict
from threading import Lock

from ..store.tables import Database
from ..text.htmlparse import extract_summary_text

_NON_ALNUM_RUN = re.compile(r"[^a-zA-Z0-9]+")


def _clean(w: str) -> str:
    return _NON_ALNUM_RUN.sub("", w).lower()


# doc text + cleaned tokens + match indexes are query-independent; the lxml
# re-parse is the expensive part of every summary. LRU keyed by
# (db generation, db doc_version, doc hash) — see _doc_index.
_TEXT_CACHE: OrderedDict[str, tuple] = OrderedDict()
_TEXT_CACHE_CAP = 20_000
_TEXT_LOCK = Lock()


def _doc_index(db: Database, doc_hash: str):
    """-> (words, cleaned, first_pos {cleaned word -> first index},
    positions {cleaned word -> [indexes]}) or None when neither the indexed
    summary text nor the raw HTML is available.

    Fast path: the indexer persists the summary-visible words (doc_summary
    table) so serving only splits a string; stores predating that table fall
    back to re-parsing the HTML cache like the reference does.

    Cache keyed by (db.generation, db.doc_version, doc_hash): rows read
    through one store handle are stable unless this process writes docs
    (cache_doc / index_page bump doc_version); appends from OTHER processes
    only become visible via a fresh open, which carries a new generation.
    A hit therefore costs ZERO store reads — round-2 profiling showed the
    per-summary content-hash revalidation read was ~40% of warm hydration."""
    ckey = (db.generation, db.doc_version, doc_hash)
    with _TEXT_LOCK:
        hit = _TEXT_CACHE.get(ckey)
        if hit is not None:
            _TEXT_CACHE.move_to_end(ckey)
            return hit
    text = db.doc_summary.get(doc_hash)
    if text is not None:
        words = text.split()
    else:
        raw = db.cached_doc(doc_hash)
        if raw is None:
            return None
        words = extract_summary_text(raw)
    cleaned = [_clean(w) for w in words]
    first_pos: dict[str, int] = {}
    positions: dict[str, list[int]] = {}
    for i, wc in enumerate(cleaned):
        if wc not in first_pos:
            first_pos[wc] = i
            positions[wc] = [i]
        else:
            positions[wc].append(i)
    entry = (words, cleaned, first_pos, positions)
    with _TEXT_LOCK:
        _TEXT_CACHE[ckey] = entry
        _TEXT_CACHE.move_to_end(ckey)
        while len(_TEXT_CACHE) > _TEXT_CACHE_CAP:
            _TEXT_CACHE.popitem(last=False)
    return entry


def _first_match(
    cleaned: list[str],
    first_pos: dict[str, int],
    positions: dict[str, list[int]],
    query_cleaned: list[str],
    phrase_cleaned: list[list[str]],
) -> int:
    """Index of the first word where any phrase matches consecutively or any
    keyword matches — identical to the reference's forward scan
    (get_metadata.go:131-155), without visiting every word."""
    n = len(cleaned)
    best = n  # sentinel: no match
    for t in query_cleaned:
        i = first_pos.get(t, n)
        if i < best:
            best = i
    for ph in phrase_cleaned:
        if not ph:
            continue
        for i in positions.get(ph[0], ()):
            if i >= best:
                break  # a keyword/earlier phrase already matched sooner
            if all(
                i + k < n and cleaned[i + k] == pw for k, pw in enumerate(ph)
            ):
                best = i
                break
    return best if best < n else -1


def prepare_summary_query(query: str, phrases: list[str]):
    """Query-side token cleaning, hoisted out of the per-result loop (a
    top-50 response would otherwise re-clean the query 50 times). Returns
    hashable tuples: they key the rendered-summary cache."""
    query_tokens = query.lower().replace('"', "").split()
    return (
        tuple(_clean(t) for t in query_tokens),
        tuple(tuple(_clean(t) for t in ph.split()) for ph in phrases),
    )


# rendered summaries are deterministic per (doc content, cleaned query):
# hot (doc, query) pairs skip the match + window entirely
_RESULT_CACHE: OrderedDict[tuple, str] = OrderedDict()
_RESULT_CACHE_CAP = 200_000
_RESULT_LOCK = Lock()

# compact per-doc text bytes for the native renderer: ~1.5 KB per doc, so a
# whole 100k-doc corpus fits the budget (vs the Python index's ~15 KB of
# dict/list objects per doc, which thrashed at serving working-set sizes)
_BYTES_CACHE: OrderedDict[tuple, bytes] = OrderedDict()
_BYTES_BUDGET = 256 << 20
_bytes_size = 0
_BYTES_LOCK = Lock()


def _doc_text_bytes(db: Database, doc_hash: str) -> bytes | None:
    """Indexed summary text as utf-8 bytes (native-renderer input), or None
    when the store predates the doc_summary table (Python fallback path)."""
    global _bytes_size
    ckey = (db.generation, db.doc_version, doc_hash)
    with _BYTES_LOCK:
        hit = _BYTES_CACHE.get(ckey)
        if hit is not None:
            _BYTES_CACHE.move_to_end(ckey)
            return hit
    text = db.doc_summary.get(doc_hash)
    if text is None:
        return None
    raw = text.encode()
    with _BYTES_LOCK:
        _BYTES_CACHE[ckey] = raw
        _bytes_size += len(raw)
        while _bytes_size > _BYTES_BUDGET and _BYTES_CACHE:
            _, old = _BYTES_CACHE.popitem(last=False)
            _bytes_size -= len(old)
    return raw


def get_summary(
    db: Database, doc_hash: str, query: str, phrases: list[str], prepared=None
) -> str:
    if prepared is None:
        prepared = prepare_summary_query(query, phrases)
    query_cleaned, phrase_cleaned = prepared

    rkey = (db.generation, db.doc_version, doc_hash, prepared)
    with _RESULT_LOCK:
        hit = _RESULT_CACHE.get(rkey)
        if hit is not None:
            _RESULT_CACHE.move_to_end(rkey)
            return hit

    out = None
    native = _native()
    if native is not None:
        text = _doc_text_bytes(db, doc_hash)
        if text is not None:
            out = native.render_summary(text, _packed_query(prepared))

    if out is None:
        got = _doc_index(db, doc_hash)
        if got is None:
            return ""
        words, cleaned, first_pos, positions = got
        out = _render(
            words, cleaned, first_pos, positions, query_cleaned, phrase_cleaned
        )
    with _RESULT_LOCK:
        _RESULT_CACHE[rkey] = out
        _RESULT_CACHE.move_to_end(rkey)
        while len(_RESULT_CACHE) > _RESULT_CACHE_CAP:
            _RESULT_CACHE.popitem(last=False)
    return out


from functools import lru_cache


@lru_cache(maxsize=4096)
def _packed_query(prepared):
    """pack_query memo: one C-argument pack per distinct cleaned query."""
    from .native_summary import pack_query

    return pack_query(prepared)


_NATIVE_MOD = "unset"


def _native():
    """The native_summary module when the renderer is buildable, else None."""
    global _NATIVE_MOD
    if _NATIVE_MOD == "unset":
        try:
            from . import native_summary

            _NATIVE_MOD = native_summary if native_summary.native_available() else None
        except Exception:  # noqa: BLE001 — any build/load issue -> Python path
            _NATIVE_MOD = None
    return _NATIVE_MOD


def _render(words, cleaned, first_pos, positions, query_cleaned, phrase_cleaned) -> str:
    match_at = _first_match(cleaned, first_pos, positions, query_cleaned, phrase_cleaned)

    if match_at >= 0:
        i = match_at
        if i - 10 < 0:
            diff = 20 - i
            out = words[:i]
        else:
            diff = 0
            out = ["..."] + words[i - 10 : i]
        span = 10 if diff == 0 else diff
        if i + span <= len(words):
            out += words[i : i + span] + ["..."]
        else:
            out += words[i:]
        return " ".join(out)

    # static fallback: middle window
    if len(words) > 21:
        i = math.ceil(len(words) / 2.0)
        return " ".join(["..."] + words[i - 10 : i + 11] + ["..."])
    return " ".join(words + ["..."])
