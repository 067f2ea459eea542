"""The seeded benchmark corpus, with neither lxml nor jax.

`render_pages` renders the pages of the benchmark corpus (bench.py
build_bench_corpus) as bench.py does: the same seeded draws in the same
order —

  - a vocabulary of n_vocab words `w%05d`, Zipf s=1.05 with the top 40
    terms dropped (the stopword-filtered head);
  - bodies of 40-120 tokens and titles of 2-6;
  - 0-7 links per page to uniformly drawn pages, anchor text = a body word;
  - topic categories General and Science.

`write_corpus` builds the corpus as bench.py does: every rendered page
through this package's indexer (index/indexer.py index_page, a copy of the
JAX package's) inside one bulk session, in page order, with a fixed
Last-Modified of 2026-01-01; then this package's update_pagerank (the
reference model, on `device`) and the term weighting pass
(ops/weighting.py). So the store holds what bench.py's does, anchor text
included: a link's text is a body word of the linking page and a title
posting of its target at the -100 sentinel position.
"""

from __future__ import annotations

import time
from datetime import datetime, timezone

import numpy as np

from .index.indexer import index_page
from .ops.pagerank import update_pagerank
from .ops.weighting import update_term_weights
from .store.tables import Database

BASE_URL = "http://bench.local"


def zipf_probs(n_vocab: int, head_drop: int = 40, s: float = 1.05) -> np.ndarray:
    p = 1.0 / np.arange(1, n_vocab + 1) ** s
    p[:head_drop] = 0.0
    return p / p.sum()


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
    """Build the seeded corpus into a fresh Database at `root` (None = in
    memory): index every rendered page, run PageRank on `device`, weight
    the terms. Returns the open Database."""
    say = log or (lambda msg: None)
    t0 = time.perf_counter()
    pages = render_pages(n_pages, n_vocab, seed)
    say(f"{n_pages} pages rendered in {time.perf_counter() - t0:.1f}s")
    db = Database(root)
    db.topic_meta.set("General", {"numPages": float(n_pages), "wordCount": 1.0})
    db.topic_meta.set("Science", {"numPages": float(n_pages // 2), "wordCount": 1.0})
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    t1 = time.perf_counter()
    with db.bulk():
        for i in range(n_pages):
            index_page(db, pages[f"/p{i}"], f"{BASE_URL}/p{i}", last_modified=ts)
            if (i + 1) % 20_000 == 0:
                say(f"indexed {i + 1}/{n_pages} pages")
    t_index = time.perf_counter() - t1
    say(f"{n_pages} pages indexed in {t_index:.1f}s ({n_pages / max(t_index, 1e-9):.1f} pages/s)")
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
