"""Benchmark modes of the PyTorch/CUDA port (the counterpart of the repo's
bench.py, with the same modes, metric names and result keys).

    python -m spaghettisearch_tpu_torch.bench [--mode MODE] [--device cuda]
    python -m spaghettisearch_tpu_torch.bench --results PATH [--profile DIR]

Modes: headline (the default: batched top-10 keyword QPS on the crawl-built
100k corpus, kernel K1), synth (the same on bench.py's synthetic index),
mixed (engine QPS on the keyword + phrase mix), parity / parity1m /
parity2m (the engine against the reference-semantics oracle, oracle.py),
parity_rare (the rare program families against the oracle), sparse2m (the
sparse phrase lane with the position-plane budget forced to 0), serve /
serve1m (the HTTP server in a subprocess under persistent connections),
scale1m (K1 at 1M synthetic docs, B=256), scale2m (the engine at full
residency on the 2M corpus), phrase (the sparse lane's forward matcher),
pagerank (pagerank_power on a 10k-node graph), index (host indexing
pages/s) and sharded (the doc-sharded index at 1M docs over 8 shards).
--pages and --queries override a mode's corpus size and query count,
--seed the corpus's seed, and --families runs a subset of parity_rare.

--device defaults to cuda and the bench refuses to start without CUDA;
--device cpu is an explicit choice (the kernels' plain versions), never a
fallback. Each mode prints one JSON line. Every result names the device
(its torch name and the nvidia-smi name and power limit on a card), and
each mode that runs in this process holds the K1-K4 launch counts of its
run. The benchmark corpora live under build/bench: corpus{N // 1000}k
holds the store, the saved snapshot and a BUILT.json marker, built once
(in a subprocess of this module) and reused while the marker matches.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from .corpus import bench_queries, synth_snapshot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "build", "bench")
#: the marker's version: bump when the corpus build changes
CORPUS_VERSION = 3


# ---------------------------------------------------------------------- #
# the device, the kernels' launch counts
# ---------------------------------------------------------------------- #


def card(device) -> dict:
    """The device a result ran on: its torch name and, on a card, the
    nvidia-smi name and power limit line."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": str(device), "device_name": platform.processor() or "cpu",
                "nvidia_smi": None}
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": str(device), "device_name": torch.cuda.get_device_name(index),
            "nvidia_smi": lines[index] if index < len(lines) else lines[0]}


def reset_launches() -> None:
    from .ops.kernels import fused, membership, mixed

    for mod in (membership, mixed, fused):
        mod.reset_launches()


def launches() -> dict:
    """K1 (membership), K2 (mixed), K3 (one-section membership), K4 (fused)
    launches since the last reset_launches()."""
    from .ops.kernels import fused, membership, mixed

    return {"K1": membership.LAUNCHES, "K2": mixed.LAUNCHES,
            "K3": membership.LAUNCHES_1SEC, "K4": fused.LAUNCHES}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {device}: CUDA is not available "
            "(pass --device cpu to run on the CPU explicitly)"
        )
    return device


# ---------------------------------------------------------------------- #
# the crawl-built benchmark corpus: one persisted index for the QPS,
# parity and serving modes (pages through the real indexer, PageRank, term
# weights, snapshot)
# ---------------------------------------------------------------------- #


def _corpus_complete(root: str, want: dict) -> bool:
    """A corpus root counts as built only when the marker's params match
    AND the snapshot/store directories it vouches for exist (a marker alone
    can outlive a concurrent build's rmtree)."""
    marker = os.path.join(root, "BUILT.json")
    if not os.path.exists(marker):
        return False
    try:
        with open(marker, encoding="utf-8") as f:
            built = json.load(f)
    except (OSError, ValueError):
        return False
    if {k: built.get(k) for k in want} != want:
        return False
    return os.path.isdir(os.path.join(root, "snapshot")) and os.path.isdir(
        os.path.join(root, "store")
    )


def host_resources(path: str) -> dict:
    """The host a build runs on: MemTotal, the cores this process may use
    and the free disk under `path`."""
    mem = None
    with open("/proc/meminfo", encoding="ascii") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                mem = int(line.split()[1]) * 1024
    os.makedirs(path, exist_ok=True)
    return {"mem_total_bytes": mem, "cores": len(os.sched_getaffinity(0)),
            "disk_free_bytes": shutil.disk_usage(path).free}


def build_bench_corpus(
    root: str,
    n_pages: int = 100_000,
    n_vocab: int = 30_000,
    seed: int = 0,
    device="cuda",
    quiet: bool = False,
) -> str:
    """Build (or reuse) the seeded benchmark corpus under `root`:
    <root>/store (the tables and the page cache), <root>/snapshot (the saved
    columnar arrays) and <root>/BUILT.json, written last and atomically.
    PageRank runs on `device`; as many processes as this process may use
    cores index the pages and assemble the snapshot from their key buckets
    (corpus.write_corpus_with_snapshot; one core: build_snapshot of the
    store), saved uncompressed (index/parallel_build.py
    save_snapshot_uncompressed). Each step's seconds and the peak RSS are
    logged and kept in BUILT.json. Returns root."""
    import resource

    from .corpus import write_corpus_with_snapshot
    from .index.parallel_build import save_snapshot_uncompressed

    marker = os.path.join(root, "BUILT.json")
    params = {"n_pages": n_pages, "n_vocab": n_vocab, "seed": seed, "v": CORPUS_VERSION}
    if _corpus_complete(root, params):
        return root

    def say(msg: str) -> None:
        if not quiet:
            print(f"# corpus: {msg}", file=sys.stderr, flush=True)

    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    host = host_resources(root)
    workers = host["cores"]
    say(f"host: MemTotal {host['mem_total_bytes']} B, {workers} cores, "
        f"{host['disk_free_bytes']} B free disk")
    t0 = time.perf_counter()
    db, snap, stats = write_corpus_with_snapshot(
        os.path.join(root, "store"), n_pages=n_pages, n_vocab=n_vocab, seed=seed, log=say,
        device=str(device), workers=workers)
    say(f"snapshot: {snap.n_docs} docs, {snap.n_words} words, "
        f"{snap.body.n_postings + snap.title.n_postings} postings")
    t1 = time.perf_counter()
    save_snapshot_uncompressed(snap, os.path.join(root, "snapshot"))
    db.close()
    t_save = time.perf_counter() - t1
    kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    say(f"save: snapshot saved (uncompressed) and store closed in {t_save:.1f}s; peak RSS "
        f"{rss:.0f} MB (largest child process {kids:.0f} MB)")
    steps = {k: round(v, 1) for k, v in stats["seconds"].items()}
    steps["save"] = round(t_save, 1)
    tmp = marker + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump({**params, "docs": snap.n_docs, "words": snap.n_words,
                   "seconds": round(time.perf_counter() - t0, 1), "workers": workers,
                   "steps": steps, "magnitude_spans": {k: round(v, 1)
                                       for k, v in stats.get("magnitude_spans", {}).items()},
                   "peak_rss_mb": round(rss), "host": host}, f)
    os.replace(tmp, marker)
    say(f"total {time.perf_counter() - t0:.1f}s -> {root}")
    return root


def corpus_root(n_pages: int) -> str:
    return os.path.join(BENCH_DIR, f"corpus{n_pages // 1000}k")


def ensure_bench_corpus(n_pages: int = 100_000, n_vocab: int = 30_000, device="cuda",
                        seed: int = 0) -> str:
    """The benchmark corpus of n_pages drawn from `seed`: reused when built
    with that seed, else built in a subprocess of this module (PageRank on
    `device`)."""
    root = corpus_root(n_pages)
    if _corpus_complete(root, {"n_pages": n_pages, "n_vocab": n_vocab, "seed": seed,
                               "v": CORPUS_VERSION}):
        return root
    print(f"# building benchmark corpus ({n_pages} pages, seed {seed}) ...", file=sys.stderr,
          flush=True)
    subprocess.run(
        [sys.executable, "-m", "spaghettisearch_tpu_torch.bench", "--device", str(device),
         "--seed", str(seed), "--build-corpus", str(n_pages), str(n_vocab), root],
        check=True, cwd=REPO,
    )
    return root


def load_bench_corpus(root: str):
    """-> (Database, IndexSnapshot) for a built corpus."""
    from .index.persist import load_snapshot
    from .store.tables import Database

    return Database(os.path.join(root, "store")), load_snapshot(os.path.join(root, "snapshot"))


# ---------------------------------------------------------------------- #
# kernel-level modes
# ---------------------------------------------------------------------- #


def _keyword_batches(snap, n_batches: int, batch: int, q: int, seed: int, device):
    """Batches of 1-q keywords sampled proportional to body df, rows sorted
    by term count descending (the engine's contract): (term_ids [B, Q] with
    the sentinel n_words as pad, qn int32 [B], qlen f32 [B]) on `device`."""
    rng = np.random.default_rng(seed)
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    p = df / df.sum()
    out = []
    for _ in range(n_batches):
        ks = rng.integers(1, q + 1, batch)
        ks[::-1].sort()  # descending
        tids = np.full((batch, q), snap.n_words, np.int32)
        for i, k in enumerate(ks):
            tids[i, :k] = rng.choice(snap.n_words, size=int(k), p=p)
        out.append((torch.from_numpy(tids).to(device),
                    torch.from_numpy(ks.astype(np.int32)).to(device),
                    torch.from_numpy(ks.astype(np.float32)).to(device)))
    return out


def _forward_scorer(idx, tp, topk: int):
    """score_queries_forward (K1) with the arguments the engine passes for
    the doc-sorted layout and count elision."""
    from .ops.scoring import score_queries_forward

    def run(batch):
        tids, qn, qlen = batch
        return score_queries_forward(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
            tids, qlen, tp, qn, topk=topk, emit_counts=idx.has_zero_weight,
            body_tmax=idx.body.tmax_blocks, doc_map=idx.doc_perm,
        )

    return run


def bench_headline(synth: bool = False, device="cuda", seed: int = 0) -> dict:
    """Batched top-10 keyword QPS: 20 batches of 256 queries of 1-4
    keywords through K1, best of 3 sweeps, on the crawl-built 100k corpus
    (the index --mode parity checks) or, with synth, on the synthetic one."""
    from .retrieval.device_index import DeviceIndex

    device = torch.device(device)
    batch, q, topk, n_batches = 256, 4, 10, 20
    if synth:
        snap = synth_snapshot(n_docs=100_000, n_words=50_000)
    else:
        db, snap = load_bench_corpus(ensure_bench_corpus(device=device, seed=seed))
        db.close()
    idx = DeviceIndex.from_snapshot(snap, device)
    batches = _keyword_batches(snap, n_batches, batch, q, seed=1, device=device)
    run = _forward_scorer(idx, torch.zeros((batch, idx.n_categories), device=device), topk)
    run(batches[0])
    _sync(device)
    best_dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [run(t) for t in batches]
        outs[-1][0].cpu()  # one stream: the last result ends every batch
        best_dt = min(best_dt, time.perf_counter() - t0)
    qps = n_batches * batch / best_dt
    return {
        "metric": "batched_top10_qps_100k_docs" + ("_synth" if synth else ""),
        "value": round(qps, 1),
        "unit": "qps",
        "docs": snap.n_docs,
    }


def bench_scale(n_docs: int = 1_000_000, device="cuda", check=None) -> dict:
    """Batched top-10 over bench.py's 1M-doc synthetic index (200,000
    words, 48 body and 4 title terms per doc, max_df 32,768) at B=256 on
    one device: 5 batches of 1-4 keywords through K1. With `check`, it is
    called after the timed sweep as check(run, batch, out) with the scorer,
    the first batch and the sweep's (scores, ids) of it, and its return
    value is kept under "check"."""
    from .retrieval.device_index import DeviceIndex

    device = torch.device(device)
    batch = 256
    snap = synth_snapshot(
        n_docs=n_docs, n_words=200_000, body_terms_per_doc=48,
        title_terms_per_doc=4, max_df=32_768,
    )
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    idx = DeviceIndex.from_snapshot(snap, device)
    build_s = time.perf_counter() - t0
    batches = _keyword_batches(snap, 5, batch, 4, seed=1, device=device)
    run = _forward_scorer(idx, torch.zeros((batch, 1), device=device), 10)
    run(batches[0])
    _sync(device)
    t0 = time.perf_counter()
    outs = [run(t) for t in batches]
    outs[-1][0].cpu()
    dt = time.perf_counter() - t0
    qps = len(batches) * batch / dt
    out = {
        "metric": "batched_top10_qps_1m_docs",
        "value": round(qps, 1),
        "unit": "qps",
        "docs": snap.n_docs,
        "device_index_build_s": round(build_s, 1),
        "index_device_bytes": idx.device_bytes(),
        "doc_sort": idx.doc_perm is not None,
        "hot_terms": 0 if idx.hot_body_map is None else len(idx.hot_body_map),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    if check is not None:
        out["check"] = check(run, batches[0], outs[0])
    return out


def bench_phrase(n_docs: int = 100_000, reps: int = 30, device="cuda") -> dict:
    """Phrase-query latency on the sparse lane's forward matcher
    (ops/phrase.py match_phrase_fwd). Worst case: all phrase terms common,
    so the generator term's candidate window is at its widest."""
    from .ops.phrase import match_phrase_fwd
    from .retrieval.device_index import DeviceIndex

    device = torch.device(device)
    snap = synth_snapshot(n_docs=n_docs, n_words=50_000)
    idx = DeviceIndex.from_snapshot(snap, device)
    rng = np.random.default_rng(2)
    ids = np.full(4, snap.n_words, np.int32)
    ids[:3] = rng.integers(0, 1000, 3)  # common terms: worst-case candidates
    valid = np.array([True, True, True, False])
    t_df = snap.title.df(ids[:3])
    b_df = snap.body.df(ids[:3])
    gen = int(np.argmin(t_df + b_df))
    cap = 128
    while cap < max(t_df[gen], b_df[gen], 1):
        cap *= 2
    cap = min(cap, idx.posting_cap)
    t, b = idx.title, idx.body
    args = (
        t.fwd.ft, t.fwd.fj, t.weights, t.pos_offsets, t.positions,
        b.fwd.ft, b.fwd.fj, b.weights, b.pos_offsets, b.positions,
        t.offsets, t.doc_ids, b.offsets, b.doc_ids,
        torch.from_numpy(ids).to(device), torch.from_numpy(valid).to(device),
        torch.tensor(gen, dtype=torch.int32, device=device),
    )

    def run():
        return match_phrase_fwd(*args, posting_cap=cap, pos_cap=idx.pos_cap, n_docs=idx.n_docs)

    run()[0].cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = run()
    out[0].cpu()
    dt = (time.perf_counter() - t0) / reps
    return {
        "metric": "phrase_match_p50_ms_100k_docs",
        "value": round(dt * 1e3, 3),
        "unit": "ms",
        "posting_cap": cap,
    }


def bench_pagerank(n_nodes: int = 10_000, seed: int = 0, device="cuda") -> dict:
    """Topic-sensitive PageRank (16 categories) on a 10k-node Zipf link
    graph: the second of two pagerank_power runs, eps 1e-6, at most 100
    iterations."""
    from .ops.pagerank import pagerank_power

    device = torch.device(device)
    rng = np.random.default_rng(seed)
    out_deg = np.clip(rng.zipf(1.6, n_nodes), 0, 50)
    srcs = np.repeat(np.arange(n_nodes, dtype=np.int32), out_deg)
    dsts = rng.integers(0, n_nodes, len(srcs)).astype(np.int32)
    order = np.argsort(dsts, kind="stable")
    srcs, dsts = srcs[order], dsts[order]
    n_pages = np.full(16, float(n_nodes), np.float32)  # 16 topic categories
    args = (
        torch.from_numpy(srcs).to(device), torch.from_numpy(dsts).to(device),
        torch.from_numpy(out_deg.astype(np.float32)).to(device),
        torch.from_numpy(n_pages).to(device),
    )
    stats: dict = {}
    pagerank_power(*args, n_nodes, eps=1e-6, max_iters=100).cpu()
    t0 = time.perf_counter()
    pagerank_power(*args, n_nodes, eps=1e-6, max_iters=100, stats=stats).cpu()
    dt = time.perf_counter() - t0
    return {
        "metric": "pagerank_16topics_10k_nodes_wall_s",
        "value": round(dt, 4),
        "unit": "s",
        "iterations": stats.get("iterations"),
    }


def bench_index(n_pages: int = 1000) -> dict:
    """Host indexing pages/s (bulk write-back, in-memory store), best of 3,
    over the JAX tests' fixture pages (corpus.make_page)."""
    import random
    from datetime import datetime, timezone

    from .corpus import make_page
    from .index.indexer import index_page
    from .store.tables import Database

    rng = random.Random(0)
    pages = [make_page(rng, i, n_pages, "http://bench.local") for i in range(n_pages)]
    ts = datetime(2026, 1, 1, tzinfo=timezone.utc)
    dt = float("inf")
    for _ in range(3):
        db = Database(None)
        t0 = time.perf_counter()
        with db.bulk():
            for url, html in pages:
                index_page(db, html, url, last_modified=ts)
        dt = min(dt, time.perf_counter() - t0)
    return {
        "metric": "bulk_index_pages_per_s",
        "value": round(n_pages / dt, 1),
        "unit": "pages/s",
    }


# ---------------------------------------------------------------------- #
# the engine against the reference-semantics oracle
# ---------------------------------------------------------------------- #


def rank_vs_oracle(eng, db, snap, queries: list[str], topic: bool = False,
                   oracle_procs: int = 1):
    """Rank `queries` in 64-query batches through eng.rank (top-50) and
    through oracle.retrieve (with compute_topic_probs(fixed=True) when
    `topic`). -> (got, want, oracle seconds): per query [(doc hash, score)].
    With oracle_procs > 1 the oracle's queries are spread over that many
    forked processes (they read the open store; the answers are the
    serial run's) and its seconds are the wall time of that spread."""
    from .retrieval.engine import parse_query

    got_all: list[list[tuple[str, float]]] = []
    want_all: list[list[tuple[str, float]]] = []
    oracle_s = 0.0
    for qi in range(0, len(queries), 64):
        chunk = queries[qi : qi + 64]
        parsed = [parse_query(q) for q in chunk]
        scores, ids = eng.rank(parsed, topk=50)
        for row, q in enumerate(chunk):
            got_all.append([
                (snap.doc_hashes[int(d)], float(s))
                for s, d in zip(scores[row], ids[row])
                if s != -np.inf and not np.isnan(s)
            ])
            if oracle_procs <= 1:
                t0 = time.perf_counter()
                want_all.append(_oracle_answer(db, q, parsed[row].keyword_hashes, topic))
                oracle_s += time.perf_counter() - t0
    if oracle_procs > 1:
        import concurrent.futures as cf
        import multiprocessing

        _ORACLE.update(db=db, queries=queries, topic=topic)
        t0 = time.perf_counter()
        try:
            with cf.ProcessPoolExecutor(oracle_procs,
                                        mp_context=multiprocessing.get_context("fork")) as pool:
                want_all = list(pool.map(_oracle_query, range(len(queries)),
                                         chunksize=max(1, len(queries) // (4 * oracle_procs))))
        finally:
            _ORACLE.clear()
        oracle_s = time.perf_counter() - t0
    return got_all, want_all, oracle_s


def _oracle_answer(db, query: str, keyword_hashes: list[str], topic: bool) -> list:
    from .oracle import retrieve as oracle_retrieve
    from .retrieval.topics import compute_topic_probs

    tp = compute_topic_probs(db, keyword_hashes, fixed=True) if topic else None
    return list(oracle_retrieve(db, query, topic_probs=tp))


# the store and queries that rank_vs_oracle's forked oracle processes read
_ORACLE: dict = {}


def _oracle_query(i: int) -> list:
    from .retrieval.engine import parse_query

    q = _ORACLE["queries"][i]
    return _oracle_answer(_ORACLE["db"], q, parse_query(q).keyword_hashes, _ORACLE["topic"])


def exact_order(got_all, want_all) -> float:
    """The share of queries whose top-50 doc order equals the oracle's."""
    return sum(
        1 for a, b in zip(got_all, want_all) if [d for d, _ in a] == [d for d, _ in b]
    ) / max(len(got_all), 1)


def divergences(got_all, want_all) -> tuple[int, int]:
    """-> (top-50 order divergences, how many are tie-explained). A
    divergence is tie-explained when every differing position holds docs
    whose oracle scores are equal (within 1e-6 relative): any order is then
    a valid outcome of the reference's insertion sort."""
    n_div = n_tie = 0
    for a, b in zip(got_all, want_all):
        if [d for d, _ in a] == [d for d, _ in b]:
            continue
        n_div += 1
        bmap = dict(b)
        tie_ok = len(a) == len(b)
        if tie_ok:
            for (da, _), (db_, sb) in zip(a, b):
                if da == db_:
                    continue
                sa = bmap.get(da)
                if sa is None or abs(sa - sb) > 1e-6 * max(abs(sb), 1e-9):
                    tie_ok = False
                    break
        n_tie += tie_ok
    return n_div, n_tie


def bench_parity(n_pages: int = 100_000, n_queries: int = 1000, device="cuda",
                 seed: int = 0, oracle_procs: int = 1) -> dict:
    """recall@10 of the engine against the oracle on the crawl-built index
    the QPS modes run on, over the keyword + phrase mix (a mined phrase in
    every 3rd query); also exact order at 10 and 50, the top-50 divergences
    and how many are tie-explained, and the largest relative score error.
    The oracle's queries run in `oracle_procs` processes (rank_vs_oracle)."""
    from .evaluation import compare_rankings
    from .retrieval.engine import QueryEngine

    db, snap = load_bench_corpus(ensure_bench_corpus(n_pages, device=device, seed=seed))
    eng = QueryEngine(db, snapshot=snap, device=device)
    queries = bench_queries(snap, n_queries, seed=9, phrase_every=3, db=db)
    t0 = time.perf_counter()
    got_all, want_all, oracle_s = rank_vs_oracle(eng, db, snap, queries,
                                                 oracle_procs=oracle_procs)
    wall = time.perf_counter() - t0
    db.close()
    report = compare_rankings(got_all, want_all, k=10)
    n_div, n_tie = divergences(got_all, want_all)
    return {
        "order_divergences_at_50": n_div,
        "divergences_tie_explained": n_tie,
        "metric": f"recall_at_10_vs_reference_oracle_{n_pages // 1000}k",
        "value": round(report.recall_at_k, 6),
        "unit": "recall",
        "exact_order_at_10": round(report.exact_order, 6),
        "exact_order_at_50": round(exact_order(got_all, want_all), 6),
        "score_max_rel_err": float(f"{report.score_max_rel_err:.3g}"),
        "queries": report.queries,
        "docs": snap.n_docs,
        "oracle_s": round(oracle_s, 3),
        "oracle_procs": oracle_procs,
        "engine_s": round(wall - oracle_s, 3),
    }


def _mine_ngram(snap, db, rng, n_terms: int) -> str | None:
    """An adjacent n_terms-gram from a random cached page body (so the
    phrase matches at least its source doc)."""
    for _ in range(20):
        doc = snap.doc_hashes[int(rng.integers(0, snap.n_docs))]
        raw = db.cached_doc(doc)
        if not raw:
            continue
        body = raw.decode().split("<p>", 1)[-1].split("</p>", 1)[0].split()
        if len(body) >= n_terms:
            j = int(rng.integers(0, len(body) - n_terms + 1))
            return '"' + " ".join(body[j : j + n_terms]) + '"'
    return None


#: bench_parity_rare's families, in the order they run
RARE_FAMILIES = ("kw_catchall", "phrase_long", "widefold", "csr_lane", "big_batch",
                 "topic_fixed")


def bench_parity_rare(n_pages: int = 100_000, device="cuda", seed: int = 0,
                      families=RARE_FAMILIES) -> dict:
    """Oracle parity of the rare program families, each against oracle.py:

      kw_catchall   5-32 keywords (the Q_CATCHALL shape)
      phrase_long   8- and 16-term mined phrases (the P_LEVELS tails)
      widefold      single-term phrases of top-df words on an engine
                    without title position planes (the sparse lane's
                    matcher, wide fold levels)
      csr_lane      a dense-truncated engine (the exact CSR route)
      big_batch     256 mixed queries on a big_batch engine
      topic_fixed   use_topic_model + topic_model_fixed=True

    Each family reports recall@10, exact order at 50, its top-50
    divergences and how many are tie-explained, the largest relative score
    error, the kernels' launches in it and the oracle's seconds.
    `families` runs a subset; every family's queries are drawn all the
    same, so a family asks the same queries in any subset."""
    from .evaluation import compare_rankings
    from .retrieval import device_index as _di
    from .retrieval.engine import QueryEngine

    device = torch.device(device)
    db, snap = load_bench_corpus(ensure_bench_corpus(n_pages, device=device, seed=seed))
    rng = np.random.default_rng(23)
    word_of = {wh: db.word.get(wh) for wh in snap.word_hashes}
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    p = df / df.sum()

    def kw_query(k: int) -> str:
        ids = rng.choice(len(snap.word_hashes), size=k, p=p)
        return " ".join(w for w in (word_of[snap.word_hashes[int(i)]] for i in ids) if w)

    def run_family(eng, queries, topic=False) -> dict:
        before = launches()
        got_all, want_all, oracle_s = rank_vs_oracle(eng, db, snap, queries, topic=topic)
        n = {k: v - before[k] for k, v in launches().items()}
        rep = compare_rankings(got_all, want_all, k=10)
        n_div, n_tie = divergences(got_all, want_all)
        return {
            "queries": rep.queries,
            "recall_at_10": round(rep.recall_at_k, 6),
            "exact_order_at_50": round(exact_order(got_all, want_all), 6),
            "order_divergences_at_50": n_div,
            "divergences_tie_explained": n_tie,
            "score_max_rel_err": float(f"{rep.score_max_rel_err:.3g}"),
            "launches": n,
            "oracle_s": round(oracle_s, 3),
        }

    unknown = set(families) - set(RARE_FAMILIES)
    if unknown or not families:
        raise ValueError(f"parity_rare: families {sorted(unknown)} not in {RARE_FAMILIES}")
    eng = QueryEngine(db, snapshot=snap, device=device)
    fams: dict[str, dict] = {}
    catchall = [kw_query(int(k)) for k in rng.integers(5, 33, 32)]
    if "kw_catchall" in families:
        fams["kw_catchall"] = run_family(eng, catchall)

    longs = []
    for n_terms in (8, 16):
        for _ in range(8):
            q = _mine_ngram(snap, db, rng, n_terms)
            if q:
                longs.append(q if rng.random() < 0.5 else f"{q} {kw_query(2)}")
    if "phrase_long" in families:
        fams["phrase_long"] = run_family(eng, longs)

    # single-term phrases of top-df words match far beyond the 64-entry
    # base fold; without title planes the engine takes the sparse lane
    hot = np.argsort(-df)[:16]
    wide = [
        f'"{word_of[snap.word_hashes[int(i)]]}"' for i in hot
        if word_of[snap.word_hashes[int(i)]]
    ] + [
        f'"{word_of[snap.word_hashes[int(i)]]}" {kw_query(2)}'
        for i in hot[:4] if word_of[snap.word_hashes[int(i)]]
    ]
    if "widefold" in families:
        eng_sparse = QueryEngine(db, snapshot=snap, device=device)
        eng_sparse._live[1].title.posT = None
        fams["widefold"] = run_family(eng_sparse, wide)
        del eng_sparse

    # a tiny doc-term cap truncates every dense row; the CSR stays whole
    csr_queries = ([kw_query(int(k)) for k in rng.integers(1, 5, 12)]
                   + [q for q in (_mine_ngram(snap, db, rng, 2) for _ in range(4)) if q])
    if "csr_lane" in families:
        saved_cap = _di.DOC_TERM_CAP
        try:
            _di.DOC_TERM_CAP = 8
            idx_csr = _di.DeviceIndex.from_snapshot(snap, device, doc_sort=False)
        finally:
            _di.DOC_TERM_CAP = saved_cap
        if not idx_csr.dense_truncated:
            raise RuntimeError("DOC_TERM_CAP=8 did not truncate the dense index")
        eng_csr = QueryEngine(db, snapshot=snap, index=idx_csr, device=device)
        fams["csr_lane"] = run_family(eng_csr, csr_queries)
        del eng_csr, idx_csr

    if "big_batch" in families:
        eng_big = QueryEngine(db, snapshot=snap, index=eng.index, device=device, big_batch=True)
        fams["big_batch"] = run_family(
            eng_big, bench_queries(snap, 256, seed=31, phrase_every=4, db=db))

    if "topic_fixed" in families:
        eng_topic = QueryEngine(db, snapshot=snap, index=eng.index, device=device,
                                use_topic_model=True, topic_model_fixed=True)
        fams["topic_fixed"] = run_family(
            eng_topic, bench_queries(snap, 32, seed=37, phrase_every=4, db=db), topic=True,
        )
    db.close()
    worst = min(f["exact_order_at_50"] for f in fams.values())
    return {
        "metric": f"rare_grammar_exact_order_at_50_{n_pages // 1000}k",
        "value": round(worst, 6),
        "unit": "exact_order(worst family)",
        "families": fams,
        "docs": snap.n_docs,
    }


def bench_mixed(n_pages: int = 100_000, n_batches: int = 12, device="cuda",
                seed: int = 0) -> dict:
    """Engine QPS on the keyword + phrase mix (a mined 2-gram in every 4th
    query): 128-query batches through QueryEngine.rank (device ranking and
    the result copy, no hydration), best of 3; and the same batches all
    dispatched before the first result is read (rank_async)."""
    from .retrieval.engine import QueryEngine, parse_query

    db, snap = load_bench_corpus(ensure_bench_corpus(n_pages, device=device, seed=seed))
    eng = QueryEngine(db, snapshot=snap, device=device)
    eng.warmup()
    queries = bench_queries(snap, n_batches * 128, seed=3, phrase_every=4, db=db)
    batches = [
        [parse_query(q) for q in queries[i * 128 : (i + 1) * 128]] for i in range(n_batches)
    ]
    for b in batches[:2]:
        eng.rank(b)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for b in batches:
            eng.rank(b)
        best = min(best, time.perf_counter() - t0)
    best_p = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        handles = [eng.rank_async(b) for b in batches]
        for h in handles:
            h.finish()
        best_p = min(best_p, time.perf_counter() - t0)
    db.close()
    return {
        "metric": "engine_mixed_qps_100k_docs",
        "value": round(n_batches * 128 / best, 1),
        "unit": "qps",
        "batch_ms_p50": round(best / n_batches * 1e3, 1),
        "pipelined_qps": round(n_batches * 128 / best_p, 1),
        "phrase_share": round(
            sum(1 for b in batches for p in b if p.phrase_hashes) / (n_batches * 128), 3,
        ),
    }


def tier_kernels(idx, snap, device) -> dict:
    """K1 and K2 on an index at the engine's arguments: a B=128 Q=4 keyword
    batch (the doc-sorted body bound when the layout has it) and a B=128
    Q=4 P=16 mixed batch (ops/kernels/check.py, the batches chip_smoke.py
    times at 100k). Each: ms per wrapper call (CUDA events on a card) and
    the bound on this data (check.bound_ms: bytes over 3.35 TB/s or
    operations over 67 TOP/s)."""
    from .ops.kernels import check

    df = snap.body.df(range(snap.n_words)).astype("float64")
    counts = idx.has_zero_weight  # the engine's emit_counts
    doc_sort = idx.body.tmax_blocks is not None
    kb = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df), device)
    cases = {"K1": (kb, False, lambda: check.run_k1(idx, kb, counts, doc_sort), "B=128 Q=4")}
    if idx.body.posT is not None and idx.title.posT is not None:
        mb = check.to_device(check.mixed_batch(idx, 128, 4, 16, seed=1, df=df, snap=snap), device)
        cases["K2"] = (mb, True, lambda: check.run_k2(idx, mb, counts), "B=128 Q=4 P=16")
    out = {}
    for name, (batch, phrases, fn, shape) in cases.items():
        sweeps = [(getattr(idx, s).fwd.ftT, check.row_terms(batch, s, phrases))
                  for s in ("title", "body")]
        bound, by = check.bound_ms(sweeps, idx.n_words, 128, idx.n_docs_padded,
                                   4 if counts else 2)
        out[name] = {"ms": round(check.time_on(fn, device), 4), "bound_ms": round(bound, 4),
                     "bound_by": by, "shape": shape, "d_pad": idx.n_docs_padded,
                     "body_T": int(idx.body.fwd.ftT.shape[0])}
    return out


def residency(idx) -> dict:
    """Where the gates put the index (device_index.py): the hot-term cache,
    the position planes against POS_T_BUDGET_BYTES, whether the doc-major
    ft/fw/fj are on the host, and the device bytes."""
    from .retrieval import device_index as di

    planes = {s: getattr(idx, s).posT for s in ("title", "body")}
    return {
        "d_pad": idx.n_docs_padded,
        "hot_cache": idx.hot_body_map is not None,
        "hot_body_w_none": idx.hot_body_w is None,
        "pos_dense": idx.pos_dense,
        "posT_dtype": {s: None if p is None else str(p.dtype) for s, p in planes.items()},
        "posT_bytes": {s: 0 if p is None else p.numel() * p.element_size()
                       for s, p in planes.items()},
        "posT_budget_bytes": di.POS_T_BUDGET_BYTES,
        "fwd_on_host": {s: all(isinstance(getattr(getattr(idx, s).fwd, n), np.ndarray)
                               for n in ("ft", "fw", "fj")) for s in ("title", "body")},
        "hot_max_dpad": di.HOT_MAX_DPAD,
        "fwd_dev_max_dpad": di.FWD_DEV_MAX_DPAD,
        "index_device_bytes": idx.device_bytes(),
    }


def bench_residency(n_pages: int = 2_000_000, device="cuda", seed: int = 0) -> dict:
    """The engine at full single-device residency on the crawl-built corpus
    of n_pages: whether the position-plane budget gate kept the fused mixed
    lane live, the layout the gates chose (residency()), mixed / keyword
    128-query batches timed with two batches in flight, the device memory
    peak, and K1 and K2 per call beside their bounds (tier_kernels())."""
    from .retrieval.engine import QueryEngine, parse_query

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    db, snap = load_bench_corpus(ensure_bench_corpus(n_pages, device=device, seed=seed))
    t0 = time.perf_counter()
    eng = QueryEngine(db, snapshot=snap, device=device)
    build_s = time.perf_counter() - t0
    fused = bool(eng.model.supports_mixed(eng.index))
    queries = bench_queries(snap, 512, phrase_every=8, db=db)
    parsed = [parse_query(q) for q in queries]
    kw = [p for p in parsed if not p.phrase_hashes]
    kw_batch = (kw * 2)[:128]
    batches = [parsed[i : i + 128] for i in range(0, 512, 128)]

    def pipelined(bs, reps=3):
        # two batches in flight: each holds [B, D] f32 temporaries
        def window(seq):
            prev = None
            for b in seq:
                h = eng.rank_async(b)
                if prev is not None:
                    prev.finish()
                prev = h
            prev.finish()

        window(bs)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            window(bs * 3)
            best = min(best, (time.perf_counter() - t0) / (len(bs) * 3))
        return best * 1e3

    mixed_ms = pipelined(batches)
    kw_ms = pipelined([kw_batch])
    idx = eng.index
    placed = residency(idx)
    kernels = tier_kernels(idx, snap, device)
    db.close()
    return {
        **placed,
        "kernels": kernels,
        "max_memory_allocated": torch.cuda.max_memory_allocated(device) if on_card else None,
        "metric": f"mixed_qps_{n_pages // 1000}k_docs_resident",
        "value": round(128e3 / mixed_ms, 1),
        "unit": "qps",
        "fused_lane_live": fused,
        "mixed128_pipelined_ms": round(mixed_ms, 2),
        "kw128_pipelined_ms": round(kw_ms, 2),
        "device_index_build_s": round(build_s, 1),
        "doc_sort": idx.doc_perm is not None,
        "sparse_fallback": "see sparse2m (own process)",
    }


def bench_sparse2m(n_pages: int = 2_000_000, n_queries: int = 16, device="cuda",
                   seed: int = 0) -> dict:
    """The past-the-position-plane-gate path: with the posT budget forced to
    0 the index builds without position planes, so the sparse phrase lane
    serves the mixed batch; its top-50 against the oracle. Run it in a
    process of its own: it sets a module constant of the device index."""
    from .retrieval import device_index as _di
    from .retrieval import engine as eng_mod
    from .retrieval.engine import QueryEngine, parse_query

    _di.POS_T_BUDGET_BYTES = 0
    db, snap = load_bench_corpus(ensure_bench_corpus(n_pages, device=device, seed=seed))
    t0 = time.perf_counter()
    eng = QueryEngine(db, snapshot=snap, device=device)
    build_s = time.perf_counter() - t0
    if eng.index.pos_dense:
        raise RuntimeError("a zero posT budget left position planes on the index")
    queries = bench_queries(snap, n_queries, seed=9, phrase_every=2, db=db)
    calls = [0]
    matcher = eng_mod.match_phrase_fwd_batch

    def counted(*a, **k):
        calls[0] += 1
        return matcher(*a, **k)

    eng_mod.match_phrase_fwd_batch = counted
    try:
        t0 = time.perf_counter()
        eng.rank([parse_query(q) for q in queries], topk=50)
        first_ms = (time.perf_counter() - t0) * 1e3
        got_all, want_all, oracle_s = rank_vs_oracle(eng, db, snap, queries)
    finally:
        eng_mod.match_phrase_fwd_batch = matcher
    db.close()
    n_div, n_tie = divergences(got_all, want_all)
    exact = exact_order(got_all, want_all)
    return {
        "metric": f"sparse_lane_exact_order_at_50_{n_pages // 1000}k",
        "value": round(exact, 6),
        "unit": "fraction",
        "n_queries": len(queries),
        "phrase_queries": sum(1 for q in queries if '"' in q),
        "pos_dense": eng.index.pos_dense,
        "matcher_calls": calls[0],
        "order_divergences_at_50": n_div,
        "divergences_tie_explained": n_tie,
        "first_batch_ms": round(first_ms, 1),
        "device_index_build_s": round(build_s, 1),
        "oracle_s": round(oracle_s, 3),
    }


# ---------------------------------------------------------------------- #
# serving: the port's server in a subprocess under persistent connections
# ---------------------------------------------------------------------- #


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raise_open_files(n_conns: int) -> None:
    """Raise this process's soft RLIMIT_NOFILE to its hard limit; fail with
    a message when even that cannot hold n_conns sockets."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    need = n_conns + 64  # the connections, plus the interpreter's own files
    if hard != resource.RLIM_INFINITY and hard < need:
        raise SystemExit(f"serve: {n_conns} connections need {need} open files; "
                         f"the hard RLIMIT_NOFILE is {hard}")
    if soft != resource.RLIM_INFINITY and soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))


def _wait_up(proc, log_path: str, port: int, deadline: float) -> None:
    """Wait for the server's start line, then for /healthz to answer."""
    import urllib.error
    import urllib.request

    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(f"server died; see {log_path}")
        with open(log_path, "rb") as f:
            if b"Server is running on port" in f.read():
                break
        time.sleep(1)
    else:
        raise RuntimeError("server did not come up; see " + log_path)
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10):
                return
        except (urllib.error.URLError, ConnectionError):
            time.sleep(0.2)
    raise RuntimeError("server did not answer /healthz; see " + log_path)


def _segregation(log_path: str) -> str | None:
    """The word after the server's start-up line on phrase-class
    segregation (cli/server.py SEGREGATION_LINE): "active" or "inactive"."""
    from .cli.server import SEGREGATION_LINE

    with open(log_path, encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith(SEGREGATION_LINE):
                return line[len(SEGREGATION_LINE):].split()[0]
    return None


def bench_serve(
    n_pages: int = 100_000,
    duration_s: float = 20.0,
    n_conns: int = 512,  # above the pipeline depth x max_batch, or Little's
    # law caps throughput below the server's capacity (3-stage batcher)
    warm_s: float = 15.0,
    n_queries: int = 4096,
    big_batch: bool = False,  # --bigBatch server (256-row bucket) and the
    # connection count Little's law then needs
    n_fetchers: int | None = None,
    ph_patience_ms: float | None = None,
    ph_stale: str | None = None,
    route_mix: bool = False,  # 1/16 GET /wordlist/{pre} + 1/16 GET /query/{terms}
    device="cuda",
    seed: int = 0,
) -> dict:
    """HTTP serving throughput at the full result contract: the port's
    server (python -m spaghettisearch_tpu_torch.cli.server) in a subprocess
    on the crawl-built corpus, driven over POST /query by n_conns persistent
    connections from one selector loop; every response carries the top-50
    with DocInfo, parents/children, keywords and summaries. A 15 s warm
    period, then a 20 s window; p50/p99 per request and per route, and the
    micro-batcher's spans from /stats."""
    import urllib.request
    from urllib.parse import quote as _quote

    from .serve.loadclient import LoadClient, post_query

    root = ensure_bench_corpus(n_pages, device=device, seed=seed)
    db, snap = load_bench_corpus(root)
    queries = bench_queries(snap, n_queries, seed=5, phrase_every=8, db=db)
    db.close()
    if big_batch:
        n_conns = max(n_conns, 1024)
    _raise_open_files(n_conns)
    # the port's start-up at 100k pages: the index ~10 s, warmup() and the
    # hydration prewarm 21.8 s on the GPU host; a tenfold margin, linear
    # in the pages
    up_wait_s = 60.0 + n_pages * 3e-3

    port = _free_port()
    os.makedirs(BENCH_DIR, exist_ok=True)
    log_path = os.path.join(BENCH_DIR, "serve_server.log")
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "spaghettisearch_tpu_torch.cli.server",
             "--db", os.path.join(root, "store"),
             "--snapshot", os.path.join(root, "snapshot"),
             "--port", str(port), "--device", str(device)]
            + (["--bigBatch"] if big_batch else [])
            + (["--fetchers", str(n_fetchers)] if n_fetchers else [])
            + (["--phrasePatienceMs", str(ph_patience_ms)] if ph_patience_ms is not None else [])
            + (["--phraseStale", ph_stale] if ph_stale else []),
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO,
        )
    try:
        t_up = time.monotonic()
        _wait_up(proc, log_path, port, t_up + up_wait_s)
        up_s = time.monotonic() - t_up

        payloads, kinds = [], []
        for i, q in enumerate(queries):
            if route_mix and i % 16 == 14:
                # prefixes from the query workload, so they hit the vocabulary
                pre = (queries[(i * 7) % len(queries)].split()[0].strip('"') or "a")[0]
                payloads.append(f"GET /wordlist/{pre} HTTP/1.1\r\nHost: b\r\n\r\n".encode())
                kinds.append("wordlist")
            elif route_mix and i % 16 == 15:
                payloads.append(
                    f"GET /query/{_quote(q, safe='')} HTTP/1.1\r\nHost: b\r\n\r\n".encode()
                )
                kinds.append("get_query")
            else:
                payloads.append(post_query(q))
                kinds.append("post_query")

        # the contract on one request before the load
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/query",
            data=json.dumps({"query": queries[0]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            sample = json.loads(resp.read())
        if not sample or set(sample[0]) != {
            "Url", "Page_title", "Mod_date", "Page_size", "Children",
            "Parents", "Words_mapping", "Summary", "PageRank", "FinalRank",
        }:
            raise RuntimeError("serve bench: response does not carry the full contract")

        client = LoadClient(port, payloads, n_conns, kinds)
        client.pump(warm_s)  # warm the record and summary caches
        client.reset()
        dt = client.pump(duration_s)
        total = client.done
        lats = np.asarray(client.all_latencies())
        route_lat = client.latencies
        client.close()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        segregation = _segregation(log_path)
        mb = stats.get("microbatcher") or {}
        return {
            "metric": f"serve_http_qps_{n_pages // 1000}k_docs_full_contract",
            "value": round(total / dt, 1),
            "unit": "qps",
            "p50_ms": round(1e3 * float(lats[len(lats) // 2]), 2) if len(lats) else None,
            "p99_ms": round(1e3 * float(lats[int(len(lats) * 0.99)]), 2) if len(lats) else None,
            "requests": total,
            "non_200": client.non_200,
            # answers without a Content-Length (unframeable; each closed and
            # replaced its connection)
            "protocol_errors": client.protocol_errors,
            "contract": True,
            "connections": n_conns,
            "big_batch": big_batch,
            "fetchers": n_fetchers or 1,  # the server CLI's default
            "server_up_s": round(up_s, 1),
            "mean_batch": mb.get("mean_batch"),
            # phrase-class segregation (automatic at >= 2^19 docs): the
            # batcher's setting, and the server's start-up line on it
            "segregate": mb.get("segregate"),
            "segregation": segregation,
            "ph_batches": mb.get("ph_batches"),
            "batches": mb.get("batches"),
            # the engine's launch span: the host's call into the scorer (the
            # kernels queue asynchronously) and the result copies' queueing
            "rank_launch_ms": (stats.get("engine.launch") or {}).get("mean_ms"),
            "serve_query_ms": (stats.get("serve.query") or {}).get("mean_ms"),
            # per-stage pipeline spans (ms per batch): the wait for the
            # device lands in fetch
            "spans_ms": {
                k: (stats.get(f"batch.{k}") or {}).get("mean_ms")
                for k in ("wait", "parse", "dispatch", "fetch", "assemble", "resolve")
            },
            "queue_age": mb.get("queue_age"),
            "routes": {
                k: {
                    "n": len(v),
                    "p50_ms": round(1e3 * float(np.percentile(v, 50)), 2),
                    "p99_ms": round(1e3 * float(np.percentile(v, 99)), 2),
                }
                for k, v in route_lat.items() if v
            } if route_mix else None,
        }
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------- #
# the doc-sharded index at 1M docs
# ---------------------------------------------------------------------- #


def _shard_csr_vectorized(csr, n_shards, docs_per_shard, t_pad):
    """The JAX tests' independent splitter (tests/test_sharded_build.py):
    one stable argsort re-orders the postings from word-major to
    (shard, word)-major, and every per-shard offset and slot falls out of
    bincounts over the combined key. Timed against parallel/sharded.py's
    per-shard scans."""
    from .parallel.sharded import DOC_TERM_CAP, _repeat_blocks

    n_words = csr.post_offsets.shape[0] - 1
    n_post = csr.n_postings
    word_of_post = np.repeat(
        np.arange(n_words, dtype=np.int64), np.diff(csr.post_offsets)
    )
    doc = csr.doc_ids[:n_post].astype(np.int64)
    shard_of_post = doc // docs_per_shard

    key = shard_of_post * n_words + word_of_post
    order_sw = np.argsort(key, kind="stable")

    counts = np.bincount(key, minlength=n_shards * n_words).reshape(
        n_shards, n_words
    )
    offsets_sw = np.zeros((n_shards, n_words + 1), np.int64)
    np.cumsum(counts, axis=1, out=offsets_sw[:, 1:])
    per_shard = offsets_sw[:, -1]
    max_local = int(per_shard.max(initial=0))
    post_width = -(-(max_local + 1) // 128) * 128

    sorted_shard = shard_of_post[order_sw]
    local_slot = np.arange(n_post, dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(per_shard)])[:-1], per_shard
    )
    doc_ids = np.full((n_shards, post_width), docs_per_shard, np.int32)
    weights = np.zeros((n_shards, post_width), np.float32)
    doc_ids[sorted_shard, local_slot] = (
        doc[order_sw] - sorted_shard * docs_per_shard
    ).astype(np.int32)
    weights[sorted_shard, local_slot] = csr.weights[order_sw]

    starts = csr.pos_offsets[order_sw]
    lens = (csr.pos_offsets[order_sw + 1] - starts).astype(np.int64)
    pos_lens = np.zeros((n_shards, post_width), np.int64)
    pos_lens[sorted_shard, local_slot] = lens
    pos_offsets = np.zeros((n_shards, post_width + 1), np.int64)
    np.cumsum(pos_lens, axis=1, out=pos_offsets[:, 1:])
    max_pos = int(pos_offsets[:, -1].max(initial=0))
    pos_width = -(-(max_pos + 1) // 128) * 128
    positions = np.full((n_shards, pos_width), np.inf, np.float32)
    flat_dst = _repeat_blocks(
        sorted_shard * pos_width + pos_offsets[sorted_shard, local_slot], lens
    )
    positions.reshape(-1)[flat_dst] = csr.positions[_repeat_blocks(starts, lens)]

    off_width = -(-(n_words + 2) // 128) * 128
    offsets = np.zeros((n_shards, off_width), np.int32)
    offsets[:, : n_words + 1] = offsets_sw
    offsets[:, n_words + 1 :] = offsets_sw[:, -1:]

    cap = DOC_TERM_CAP
    truncated = t_pad > cap
    t_keep = min(t_pad, cap)  # truncation bound (pre-rounding)
    # the production splitter rounds the array width up to the sweep-chunk
    # multiple with sentinel-filled extra slots
    t_pad = -(-t_keep // 8) * 8
    ft = np.full((n_shards, docs_per_shard, t_pad), -1, np.int32)
    fw = np.zeros((n_shards, docs_per_shard, t_pad), np.float32)
    fj = np.full((n_shards, docs_per_shard, t_pad), post_width - 1, np.int32)
    if n_post:
        w_sorted = csr.weights[order_sw]
        keep = np.arange(n_post, dtype=np.int64)
        if truncated:
            rank_order = np.lexsort((-w_sorted, doc[order_sw]))
            docs_r = doc[order_sw][rank_order]
            off = np.concatenate(
                [[0],
                 np.cumsum(np.bincount(docs_r, minlength=n_shards * docs_per_shard))]
            )
            rank_in_doc = np.arange(n_post, dtype=np.int64) - off[docs_r]
            keep = rank_order[rank_in_doc < t_keep]
        dorder = keep[np.argsort(doc[order_sw][keep], kind="stable")]
        docs_g = doc[order_sw][dorder]
        row_off = np.zeros(n_shards * docs_per_shard + 1, np.int64)
        np.add.at(row_off, docs_g + 1, 1)
        row_off = np.cumsum(row_off)
        slot = np.arange(len(dorder), dtype=np.int64) - row_off[docs_g]
        s_idx = docs_g // docs_per_shard
        d_loc = docs_g - s_idx * docs_per_shard
        ft[s_idx, d_loc, slot] = word_of_post[order_sw][dorder].astype(np.int32)
        fw[s_idx, d_loc, slot] = w_sorted[dorder]
        fj[s_idx, d_loc, slot] = local_slot[dorder].astype(np.int32)

    return dict(
        offsets=offsets,
        doc_ids=doc_ids,
        weights=weights,
        pos_offsets=pos_offsets.astype(np.int32),
        positions=positions,
        ft=ft, fw=fw, fj=fj, truncated=truncated,
    )


def bench_sharded(n_docs: int = 1_000_000, n_shards: int = 8, device="cuda") -> dict:
    """The doc-sharded index at 1M synthetic docs over n_shards, in this
    process: on a card shard s goes on cuda:{s % device_count}, on the CPU
    every shard on the CPU. The ShardedIndex build, the host section split
    (the production per-shard scans against the argsort splitter), and one
    keyword step of the sharded scorer (B=8, Q=4)."""
    from .parallel import sharded as sh
    from .parallel.mesh import make_mesh

    device = torch.device(device)
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        devices = [torch.device("cuda", s % n_cards) for s in range(n_shards)]
    else:
        devices = [device] * n_shards
    snap = synth_snapshot(
        n_docs=n_docs, n_words=200_000, body_terms_per_doc=48,
        title_terms_per_doc=4, max_df=32_768,
    )
    mesh = make_mesh(n_shards, devices=devices)
    t0 = time.perf_counter()
    sidx = sh.ShardedIndex.from_snapshot(snap, mesh)
    for d in set(devices):
        _sync(d)
    build_s = time.perf_counter() - t0

    dl = sidx.docs_per_shard
    split_s = {}
    for name, split in (("shard_csr", sh._shard_csr), ("argsort", _shard_csr_vectorized)):
        t0 = time.perf_counter()
        for csr in (snap.title, snap.body):
            per_doc = np.bincount(csr.doc_ids[: csr.n_postings], minlength=max(snap.n_docs, 1))
            split(csr, n_shards, dl, max(int(per_doc.max(initial=0)), 1))
        split_s[name] = time.perf_counter() - t0

    scorer = sh.make_sharded_scorer(sidx, topk=10)
    rng = np.random.default_rng(0)
    b, q = 8, 4
    df = np.diff(snap.body.post_offsets).astype(np.float64)
    args = (sidx, rng.choice(snap.n_words, size=(b, q), p=df / df.sum()).astype(np.int32),
            np.full(b, float(q), np.float32), np.zeros((b, 1), np.float32),
            np.full(4, snap.n_words, np.int32), np.zeros(4, bool), np.int32(0))
    scorer(*args)[0].cpu()
    t0 = time.perf_counter()
    scorer(*args)[0].cpu()
    step_ms = (time.perf_counter() - t0) * 1e3
    return {
        "metric": f"sharded_index_build_s_{n_docs // 1_000_000}m_docs_{n_shards}shards",
        "value": round(build_s, 2),
        "unit": "s",
        "split_s": round(split_s["shard_csr"], 2),
        "split_argsort_alt_s": round(split_s["argsort"], 2),
        "mesh_step_ms": round(step_ms, 1),
        "shards": n_shards,
        "shard_devices": sorted({str(d) for d in devices}),
        "docs": n_docs,
    }


# ---------------------------------------------------------------------- #
# the command line
# ---------------------------------------------------------------------- #


def host_calibration() -> dict:
    """A fixed single-core host workload, best of 3, recorded in every
    results file: host-bound entries (serve, index) compare across hosts
    only after dividing by it. The scale is arbitrary but stable (a 0.22 s
    reference workload)."""
    import hashlib

    buf = b"\x5a" * (1 << 20)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        h = hashlib.md5()
        for _ in range(96):
            h.update(buf)
        a = np.random.default_rng(0).random((512, 512), np.float32)
        for _ in range(6):
            a = a @ a.T
            a /= np.abs(a).max() + 1.0
        best = min(best, time.perf_counter() - t0)
    return {"metric": "host_single_core_score", "value": round(0.22 / best, 3),
            "unit": "x_ref_box", "best_s": round(best, 4)}


def _serve_kw(a) -> dict:
    return dict(n_conns=a.conns, n_fetchers=a.fetchers, route_mix=a.routeMix,
                big_batch=a.bigBatch, ph_patience_ms=a.phrasePatienceMs, ph_stale=a.phraseStale,
                seed=a.seed)


def _opt(v, default):
    return default if v is None else v


def _cores() -> int:
    return len(os.sched_getaffinity(0))


#: mode -> (run(args, device) -> dict, runs in this process)
MODES = {
    "headline": (lambda a, d: bench_headline(False, d, a.seed), True),
    "synth": (lambda a, d: bench_headline(True, d), True),
    "mixed": (lambda a, d: bench_mixed(_opt(a.pages, 100_000), device=d, seed=a.seed), True),
    "parity": (lambda a, d: bench_parity(_opt(a.pages, 100_000), _opt(a.queries, 1000), d,
                                         a.seed), True),
    "parity1m": (lambda a, d: bench_parity(_opt(a.pages, 1_000_000), _opt(a.queries, 256), d,
                                           a.seed, _cores()), True),
    "parity2m": (lambda a, d: bench_parity(_opt(a.pages, 2_000_000), _opt(a.queries, 128), d,
                                           a.seed, _cores()), True),
    "parity_rare": (lambda a, d: bench_parity_rare(
        _opt(a.pages, 100_000), d, a.seed,
        a.families.split(",") if a.families else RARE_FAMILIES), True),
    "sparse2m": (lambda a, d: bench_sparse2m(_opt(a.pages, 2_000_000), _opt(a.queries, 16), d,
                                             a.seed), True),
    "scale1m": (lambda a, d: bench_scale(device=d), True),
    "scale2m": (lambda a, d: bench_residency(_opt(a.pages, 2_000_000), d, a.seed), True),
    "phrase": (lambda a, d: bench_phrase(device=d), True),
    "pagerank": (lambda a, d: bench_pagerank(device=d), True),
    "index": (lambda a, d: bench_index(_opt(a.pages, 1000)), True),
    "sharded": (lambda a, d: bench_sharded(device=d), True),
    "serve": (lambda a, d: bench_serve(_opt(a.pages, 100_000), device=d, **_serve_kw(a)), False),
    "serve1m": (lambda a, d: bench_serve(_opt(a.pages, 1_000_000), device=d, **_serve_kw(a)),
                False),
}


def run_mode(fn, in_process: bool, device) -> dict:
    """Run one mode; its result gains the device and, for a mode that runs
    in this process, the kernels' launches in it."""
    reset_launches()
    out = fn()
    out.update(card(device))
    if in_process:
        out["launches"] = launches()
    return out


def _fresh(mode: str, device):
    """A stage run in a fresh process of this module (its heap holds no
    earlier stage's state)."""
    def run() -> dict:
        proc = subprocess.run(
            [sys.executable, "-m", "spaghettisearch_tpu_torch.bench", "--mode", mode,
             "--device", str(device)],
            capture_output=True, text=True, timeout=3600, cwd=REPO,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{mode} child failed:\n{proc.stderr[-2000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])

    return run


#: serve1m's bar in the original ladder (bench.py:1550), in req/s
SERVE1M_BAR_QPS = 2000.0


def _run_script(cmd: list[str], timeout_s: float) -> dict:
    """Run a script of the repository in a process of its own. -> the JSON
    object of its last stdout line."""
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[1:3])} exited {proc.returncode}:\n"
                           f"{proc.stderr[-1500:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def serve1m_projected(serve1m: dict | None, device, seed: int = 0,
                      n_pages: int = 1_000_000) -> dict:
    """The ladder's serve1m_projected stage: experiments/
    torch_shard_scale_probe.py in a process of its own on the 1M corpus's
    8- and 4-shard doc slices, one card, fed this ladder's serve1m result
    (its batcher spans and mean batch); the value is the 8-shard
    pipeline-projected rate. The cross-card copies are not measured and
    not in it."""
    if not serve1m or "spans_ms" not in serve1m:
        raise RuntimeError(f"no serve1m result to project from: {serve1m}")
    os.makedirs(BENCH_DIR, exist_ok=True)
    path = os.path.join(BENCH_DIR, "serve1m_result.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(serve1m, f)
    data = _run_script(
        [sys.executable, os.path.join(REPO, "experiments", "torch_shard_scale_probe.py"),
         str(n_pages), "--device", str(device), "--seed", str(seed), "--serve1m", path],
        timeout_s=5400,
    )
    val = data["shards8"]["pipeline_projected_qps"]
    return {
        "metric": "serve1m_projected_1card_slices_qps",
        "value": val,
        "unit": "qps",
        "vs_baseline": round(val / SERVE1M_BAR_QPS, 3),
        "method": "the shard-local programs measured on one card at the 1M/8 and 1M/4 doc "
                  "slices of the 1M corpus, the port's merge of the pieces timed on the card, "
                  "the host stages (dispatch, assemble, mean batch) from this ladder's serve1m; "
                  "the cross-card copies not measured and left out",
        **data,
    }


def emit_results(out_path: str, device, seed: int = 0) -> None:
    """Run every mode at its default size in sequence and write one JSON
    file: the device, the host, its calibration score, the git head and
    the time, then one entry per stage (an error is recorded and the run
    goes on); the crawl-built stages on the corpora of `seed`. The 1M and
    2M stages join when their corpora are built; serve1m_projected, last
    of the 1M stages, projects from this run's serve1m."""
    try:
        head = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True, text=True, cwd=REPO,
        ).stdout.strip() or None
    except OSError:
        head = None
    results: dict[str, object] = {
        **card(device),
        "host": platform.node(),
        "host_calib": host_calibration(),
        "git_head": head,
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    defaults = {**vars(_parser().parse_args([])), "seed": seed}

    def stage(mode: str, **flags):
        fn, in_process = MODES[mode]
        args = argparse.Namespace(**{**defaults, **flags})
        return lambda: run_mode(lambda: fn(args, device), in_process, device)

    stages = [
        ("headline", stage("headline")),
        ("mixed", stage("mixed")),
        ("parity", stage("parity")),
        ("parity_rare", stage("parity_rare")),
        ("serve", stage("serve")),
        ("scale1m", stage("scale1m")),
        ("phrase", stage("phrase")),
        ("pagerank", _fresh("pagerank", device)),
        ("index", _fresh("index", device)),
        ("sharded", stage("sharded")),
    ]
    if os.path.exists(os.path.join(corpus_root(1_000_000), "BUILT.json")):
        stages.insert(5, ("serve1m", stage("serve1m")))
        stages.insert(7, ("parity1m", stage("parity1m")))
        stages.append(("serve1m_routes", stage("serve1m", routeMix=True)))
        stages.append(("serve1m_projected",
                       lambda: serve1m_projected(results.get("serve1m"), device, seed)))
    if os.path.exists(os.path.join(corpus_root(2_000_000), "BUILT.json")):
        stages.append(("scale2m", stage("scale2m")))
        stages.append(("parity2m", stage("parity2m")))
    for name, fn in stages:
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception as exc:  # noqa: BLE001 — recorded, and the run goes on
            results[name] = {"error": f"{type(exc).__name__}: {exc}"}
        results[name]["seconds"] = round(time.perf_counter() - t0, 1)
        print(f"# {name}: {json.dumps(results[name])}", file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=1)
    print(json.dumps({"written": out_path}))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="headline", choices=sorted(MODES))
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default), cuda:N, or cpu to run the "
                         "kernels' plain versions")
    ap.add_argument("--results", metavar="PATH", help="run every mode into one JSON file")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR")
    ap.add_argument("--pages", type=int, help="the mode's corpus size (pages)")
    ap.add_argument("--queries", type=int, help="the parity or sparse2m query count")
    ap.add_argument("--seed", type=int, default=0,
                    help="the seed of the crawl-built corpus (built anew when its marker "
                         "names another)")
    ap.add_argument("--families", help="parity_rare: a comma-separated subset of "
                                       + ", ".join(RARE_FAMILIES))
    ap.add_argument("--conns", type=int, default=512, help="serve: persistent connections")
    ap.add_argument("--fetchers", type=int, help="serve: the server's fetch threads")
    ap.add_argument("--routeMix", action="store_true",
                    help="serve: 1/16 GET /wordlist and 1/16 GET /query in the load")
    ap.add_argument("--bigBatch", action="store_true",
                    help="serve: the 256-row bucket (and at least 1,024 connections)")
    ap.add_argument("--phrasePatienceMs", type=float, help="serve: the server's flag")
    ap.add_argument("--phraseStale", choices=("merge", "pure"), help="serve: the server's flag")
    ap.add_argument("--build-corpus", nargs=3, metavar=("PAGES", "VOCAB", "ROOT"),
                    help=argparse.SUPPRESS)
    return ap


def main(argv: list[str] | None = None) -> None:
    args = _parser().parse_args(argv)
    device = _check_device(args.device)
    if args.build_corpus:
        n_pages, n_vocab, root = args.build_corpus
        build_bench_corpus(root, n_pages=int(n_pages), n_vocab=int(n_vocab), seed=args.seed,
                           device=device)
        return
    if args.profile:
        from .utils.timing import device_trace

        with device_trace(args.profile):
            _run(args, device)
        print(f"# trace written to {args.profile}", file=sys.stderr)
        return
    _run(args, device)


def _run(args, device) -> None:
    if args.results:
        emit_results(args.results, device, args.seed)
        return
    fn, in_process = MODES[args.mode]
    print(json.dumps(run_mode(lambda: fn(args, device), in_process, device)))


if __name__ == "__main__":
    main()
