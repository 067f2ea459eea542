"""Seeded benchmark corpus, written as store rows or rendered as pages,
with neither lxml nor jax.

`write_corpus` writes, through this package's store.tables.Database (a
copy of the JAX package's), the rows the JAX package's indexer
(spaghettisearch_tpu/index/indexer.py index_page) writes for the pages of
the benchmark corpus (bench.py build_bench_corpus), and `render_pages`
renders those pages as bench.py does: the same seeded draws in the same
order —

  - a vocabulary of n_vocab words `w%05d`, Zipf s=1.05 with the top 40
    terms dropped (the stopword-filtered head);
  - bodies of 40-120 tokens and titles of 2-6;
  - 0-7 links per page to uniformly drawn pages, anchor text = a body word;
  - topic categories General and Science.

Rows written per page: DocInfo (title words, links as children, parents
with their anchor tokens, body term frequencies), doc_summary (the visible
body words), doc_children, raw and weighted `[normTF, pos...]` postings for
title and body, and the word table. The text is generated, so no HTML is
parsed: each vocabulary word is cleaned (laundry) once and token positions
are computed with numpy. Departures from index_page:
  - anchor text is left out: index_page reads a link's text as body words
    of the linking page (after its paragraph) and indexes it into the
    TARGET's title section with the -100 sentinel (_index_anchors); here
    bodies hold only the paragraph and titles only their own words;
  - no raw HTML is cached (summaries come from doc_summary), and
    page_size is the UTF-8 length of the page's title and body text.
doc_rank comes from this package's update_pagerank (ops/pagerank.py, the
reference model, on `device`), as bench.py's corpus gets it from the JAX
package's: the same quirk-mode vector for the General and Science
categories. The idf census N = len(doc_rank) reads it. Then the term
weighting pass runs (ops/weighting.py).
"""

from __future__ import annotations

import time
from datetime import datetime, timezone

import numpy as np

from .store.docinfo import DocInfo
from .store.tables import Database
from .text.laundry import laundry
from .utils.hashing import md5_hex
from .ops.pagerank import update_pagerank
from .ops.weighting import update_term_weights

BASE_URL = "http://bench.local"


def zipf_probs(n_vocab: int, head_drop: int = 40, s: float = 1.05) -> np.ndarray:
    p = 1.0 / np.arange(1, n_vocab + 1) ** s
    p[:head_drop] = 0.0
    return p / p.sum()


def _section_rows(doc: np.ndarray, tok: np.ndarray, n_docs: int) -> tuple:
    """Group one section's cleaned tokens into postings, one run per
    (doc, term). doc/tok: per token (tok = cleaned-term id, -1 for dropped
    tokens), in page order. -> (run term, run doc, run normTF, run position
    lists, per-doc run offsets [n_docs+1], run lengths = term frequency)."""
    keep = tok >= 0
    doc, tok = doc[keep], tok[keep]
    # position = index among the page's KEPT tokens (laundry drops first)
    starts = np.zeros(n_docs + 1, np.int64)
    np.cumsum(np.bincount(doc, minlength=n_docs), out=starts[1:])
    pos = np.arange(len(doc), dtype=np.int64) - starts[doc]
    order = np.lexsort((pos, tok, doc))  # doc, then term, then position
    d_s, t_s, p_s = doc[order], tok[order], pos[order]
    new_run = np.ones(len(d_s), bool)
    new_run[1:] = (d_s[1:] != d_s[:-1]) | (t_s[1:] != t_s[:-1])
    run_start = np.flatnonzero(new_run)
    run_len = np.diff(np.append(run_start, len(d_s)))
    run_doc, run_term = d_s[run_start], t_s[run_start]
    max_freq = np.zeros(n_docs, np.int64)
    np.maximum.at(max_freq, run_doc, run_len)
    # one f64 divide + f32 round per posting (the indexer's bulk path)
    ntf = (run_len / max_freq[run_doc].astype(np.float64)).astype(np.float32)
    pos_f = p_s.astype(np.float64).tolist()
    bounds = np.append(run_start, len(d_s)).tolist()
    plists = [pos_f[bounds[i] : bounds[i + 1]] for i in range(len(run_start))]
    doc_runs = np.zeros(n_docs + 1, np.int64)
    np.cumsum(np.bincount(run_doc, minlength=n_docs), out=doc_runs[1:])
    return run_term.tolist(), run_doc.tolist(), ntf.tolist(), plists, doc_runs, run_len


def _draws(n_pages: int, n_vocab: int, seed: int) -> tuple:
    """The seeded draws of bench.py build_bench_corpus, in its order: the
    vocabulary, body and title lengths, body and title word ids, link
    counts and link targets."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i:05d}" for i in range(n_vocab)]
    probs = zipf_probs(n_vocab)
    body_lens = rng.integers(40, 120, n_pages)
    title_lens = rng.integers(2, 6, n_pages)
    body_words = rng.choice(n_vocab, size=int(body_lens.sum()), p=probs)
    title_words = rng.choice(n_vocab, size=int(title_lens.sum()), p=probs)
    n_links = rng.integers(0, 8, n_pages)
    link_targets = rng.integers(0, n_pages, int(n_links.sum()))
    return vocab, body_lens, title_lens, body_words, title_words, n_links, link_targets


def render_pages(n_pages: int = 100_000, n_vocab: int = 30_000, seed: int = 0) -> dict[str, bytes]:
    """The HTML pages bench.py build_bench_corpus indexes, by path: page i
    is `/p{i}`, its title and body are the seeded draws, and its k-th link
    goes to `/p{j}` with the page's body word k mod len as anchor text."""
    vocab, body_lens, title_lens, body_words, title_words, n_links, link_targets = (
        _draws(n_pages, n_vocab, seed)
    )
    pages = {}
    bo = to = lo = 0
    for i in range(n_pages):
        bw = body_words[bo : bo + int(body_lens[i])]
        tw = title_words[to : to + int(title_lens[i])]
        links = link_targets[lo : lo + int(n_links[i])]
        bo += int(body_lens[i])
        to += int(title_lens[i])
        lo += int(n_links[i])
        anchors = "".join(
            f'<a href="/p{j}">{vocab[bw[k % len(bw)]]}</a>\n' for k, j in enumerate(links)
        )
        pages[f"/p{i}"] = (
            f"<html><head><title>{' '.join(vocab[w] for w in tw)}</title>"
            f"</head><body><p>{' '.join(vocab[w] for w in bw)}</p>\n"
            f"{anchors}</body></html>"
        ).encode()
    return pages


def write_corpus(
    root: str | None,
    n_pages: int = 100_000,
    n_vocab: int = 30_000,
    seed: int = 0,
    log=None,
    device: str = "cuda",
) -> Database:
    """Write the seeded corpus into a fresh Database at `root` (None = in
    memory), run PageRank on `device` and term weighting. Returns the open
    Database."""
    say = log or (lambda msg: None)
    t0 = time.perf_counter()
    vocab, body_lens, title_lens, body_words, title_words, n_links, link_targets = (
        _draws(n_pages, n_vocab, seed)
    )

    # clean each vocabulary word once: term id per vocab id (-1 = dropped)
    terms: list[str] = []
    term_of: dict[str, int] = {}
    vocab_term = np.full(n_vocab, -1, np.int64)
    for v, w in enumerate(vocab):
        toks = laundry(w)
        if len(toks) > 1:
            raise ValueError(f"vocabulary word {w!r} cleans to {toks}")
        if toks:
            tid = term_of.get(toks[0])
            if tid is None:
                tid = term_of[toks[0]] = len(terms)
                terms.append(toks[0])
            vocab_term[v] = tid
    term_hash = [md5_hex(t) for t in terms]
    urls = [f"{BASE_URL}/p{i}" for i in range(n_pages)]
    doc_hash = [md5_hex(u) for u in urls]

    body_doc = np.repeat(np.arange(n_pages), body_lens)
    title_doc = np.repeat(np.arange(n_pages), title_lens)
    sections = {
        "body": _section_rows(body_doc, vocab_term[body_words], n_pages),
        "title": _section_rows(title_doc, vocab_term[title_words], n_pages),
    }
    say(f"postings grouped in {time.perf_counter() - t0:.1f}s")

    db = Database(root)
    db.topic_meta.set("General", {"numPages": float(n_pages), "wordCount": 1.0})
    db.topic_meta.set("Science", {"numPages": float(n_pages // 2), "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)

    # link graph: ordered unique targets per page; anchor text of the k-th
    # link is the page's body word k mod len (bench.py)
    link_off = np.zeros(n_pages + 1, np.int64)
    np.cumsum(n_links, out=link_off[1:])
    body_off = np.zeros(n_pages + 1, np.int64)
    np.cumsum(body_lens, out=body_off[1:])
    title_off = np.zeros(n_pages + 1, np.int64)
    np.cumsum(title_lens, out=title_off[1:])
    children: list[list[int]] = []
    parents: list[dict[str, list[str]]] = [{} for _ in range(n_pages)]
    for i in range(n_pages):
        tg = link_targets[link_off[i] : link_off[i + 1]].tolist()
        bw = body_words[body_off[i] : body_off[i + 1]]
        kids = list(dict.fromkeys(tg))
        children.append(kids)
        for k, j in enumerate(tg):
            t = vocab_term[bw[k % len(bw)]]
            if j != i:
                parents[j].setdefault(doc_hash[i], []).extend(
                    [terms[t]] if t >= 0 else []
                )

    b_term, b_doc, b_ntf, b_pos, b_runs, b_len = sections["body"]
    with db.bulk():
        for name in ("title", "body"):
            run_term, run_doc, ntf, plists, _, _ = sections[name]
            inv, raw = db.inverted(name), db.inverted_raw(name)
            rows: dict[int, dict] = {}
            raws: dict[int, dict] = {}
            for t, d, f, pl in zip(run_term, run_doc, ntf, plists):
                h = doc_hash[d]
                row = rows.get(t)
                if row is None:
                    row = rows[t] = {}
                    raws[t] = {}
                row[h] = [f] + pl
                raws[t][h] = f
            for t, row in rows.items():
                inv.set(term_hash[t], row)
                raw.set(term_hash[t], raws[t])
        for t, w in enumerate(terms):
            db.word.set(term_hash[t], w)
        b_len_l = b_len.tolist()
        b_runs_l = b_runs.tolist()
        for i in range(n_pages):
            title_text = " ".join(vocab[w] for w in title_words[title_off[i] : title_off[i + 1]])
            body_text = " ".join(vocab[w] for w in body_words[body_off[i] : body_off[i + 1]])
            kids = [doc_hash[j] for j in children[i]]
            wm = {
                term_hash[b_term[r]]: b_len_l[r]
                for r in range(b_runs_l[i], b_runs_l[i + 1])
            }
            db.doc_info.set(doc_hash[i], DocInfo(
                url=urls[i],
                page_title=title_text.split(),
                mod_date=ts,
                page_size=len(title_text.encode()) + len(body_text.encode()),
                children=kids,
                parents=parents[i],
                words_mapping=wm,
            ))
            db.doc_children.set(doc_hash[i], kids)
            db.doc_summary.set(doc_hash[i], body_text)
    db.note_doc_write()
    say(f"store rows written in {time.perf_counter() - t0:.1f}s")
    pr = update_pagerank(db, device=device)
    say(f"pagerank ({pr['nodes']} nodes, {pr['edges']} edges, {pr['iterations']} "
        f"iterations on {device}) done in {time.perf_counter() - t0:.1f}s")
    update_term_weights(db, "title")
    update_term_weights(db, "body")
    db.flush()
    say(f"term weighting done in {time.perf_counter() - t0:.1f}s")
    return db


def make_queries(snap, db, n_queries: int, seed: int = 1) -> list[str]:
    """The benchmark query mix (bench.py bench_queries): 1-4 keywords drawn
    proportional to body df, and every 4th query led by an
    adjacent 2-gram mined from a random page's visible body text (so
    phrases actually match)."""
    rng = np.random.default_rng(seed)
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    p = df / df.sum()
    words = snap.word_hashes
    out = []
    for i in range(n_queries):
        k = int(rng.integers(1, 5))
        ids = rng.choice(len(words), size=k, p=p)
        terms = [w for w in (db.word.get(words[int(wid)]) for wid in ids) if w]
        q = " ".join(terms) if terms else "w00100"
        if i % 4 == 0:
            for _ in range(3):
                doc = snap.doc_hashes[int(rng.integers(0, snap.n_docs))]
                body = (db.doc_summary.get(doc) or "").split()
                if len(body) >= 2:
                    j = int(rng.integers(0, len(body) - 1))
                    q = f'"{body[j]} {body[j + 1]}" ' + q
                    break
        out.append(q)
    return out
