#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spaghettisearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):
  1. the card: name, count, `nvidia-smi` name and power limit;
  2. build: `make -C native` and the six CUDA sources of csrc/
     (membership.cu: K1 + K3, mixed.cu: K2, fused.cu: K4, fused_topk.cu:
     K5, phrase_delta.cu: K6, finalize.cu: the rank's finalize), all at once (nvcc for sm_90a; ptxas
     registers / shared memory / spills printed);
  3. corpus: the seeded benchmark corpus built by the port's bench
     (bench.py build_bench_corpus, in a process of its own: corpus.py's
     pages through the indexer in as many processes as the host has cores,
     index/parallel_build.py, PageRank on the card, term weights, the
     snapshot assembled from the build's key buckets and saved
     uncompressed) into build/bench/corpus100k, its store, saved snapshot
     and BUILT.json,
     where phase 16's bench modes find it; each build step's seconds; the
     device index;
  4. kernels vs their plain versions on the card at the main path's shapes,
     with CUDA-event times of both: K1 at B=128 with Q=4 and Q=32, both
     count variants, the hot split, the doc-sorted bound on and off; K2 at
     B=128 (Q=4, P=16) and at the serving shape B=16 (Q=4, P=4), int16 and
     f32 planes, both count variants; K1, K2, K3 (title and body, both
     count variants) and K4 (C=1 and C=8) on the adversarial batches that
     stress their probe tables (check.ADVERSARIAL, B=128), and K2 on
     log_full at B=16 too (with every_row, docs overflow K2's phrase-hit
     log: the rescan path), these run in phase 16, beside the bench's
     oracle modes; each batch's probe tables, as the K1/K2/K3/K4 entry
     points build them, equal to their plain build;
     K3 (one section) at B=128, Q=4 and Q=32, both count variants,
     qn-sorted rows; K4 (fused) at B=128, Q=4 and Q=32, topics off (C=1)
     and a seeded C=8 blend; each kernel's bound from this run's data
     (bound_ms) and, for K1 and K3, the time of torch.sparse.mm per
     section, the library call computing the same function, held first
     against the plain version; K5 (fused top-k) at B=256, Q=4, k_pad=16
     and K6 (phrase delta) on the first 16 rows of the B=128, P=16 mixed
     batch and on all 128, int16 and f32 planes, with and without the
     flag, each against its plain version and timed with it (the
     probes' shapes; their launches come from phase 17); K2 with the
     doc-sorted body bound at each tmax_stage on the B=128 mixed batch,
     timed beside its static call (held in phase 17); per B=128
     batch, score_queries_fused vs
     the production keyword scorer, and one custom-blend rank (two K3
     calls, phrase fold, finalize, top-k); the finalize kernel at B=128
     over the index's width, four input variants bit for bit against its
     plain route, the engine's own variant timed beside its bound
     (check.finalize_bound_ms);
  5. serving: the port's SearchServer (micro-batching on) after warmup()
     answers POST /query, GET /query/{terms} and GET /wordlist/{prefix}
     from several client threads; every response must be 200 JSON, the
     ranked results must equal the plain-version path on the card (ties at
     equal scores aside), and K1 and K2 must have launched;
  6. fused ranking: score_queries_fused (K4) on a B=128 keyword batch, ids
     mapped through doc_perm, equals BlendedRanker.score_keywords top-50;
  7. a custom-blend engine (title only): the query mix through
     query_batch; keyword batches take K3, phrase batches the sparse lane;
     results equal the plain path;
  8. --ranker bm25 serving: a SearchServer over a BM25 engine answers the
     query mix from several clients, every response 200 and equal to the
     plain path; K1 launched and the sparse-lane matcher ran;
  9. the exact CSR route: an index truncated by a lowered DOC_TERM_CAP
     answers keyword and phrase queries through score_csr, equal to the
     untruncated dense plain path;
 10. the offline build: a local site (ThreadingHTTPServer on 127.0.0.1) of
     bench.py's pages for a 2,000-page corpus (corpus.render_pages, a
     fixed Last-Modified, and a home page linking /p0 and every page /p0
     does not reach) and a 16-category ODP directory beside it; the port's
     crawl CLI in a subprocess on the card (--odpURL, --topicPagerank,
     --saveSnapshot) fetches and indexes every page with no fetch error,
     its body postings equal an in-process build of the same pages, and a
     topic-model QueryEngine on the card answers the query mix on the
     crawled store equal to the plain path; the crawl's pages/s and the
     PageRank step's ms are printed;
 11. PageRank at full size: the 100k-page corpus's link graph through
     pagerank_power (its two categories) and pagerank_personalized (16
     seeded categories), float32 on the card twice (bit-identical) and
     float64 on the CPU once (the card within rtol 1e-5, atol 1e-9);
     iterations on the card beside float32's on the CPU (the stop point),
     ms per build (CUDA events) and the bytes bound of one iteration;
 12. the doc-sharded mesh (parallel/sharded.py, retrieval/sharded_engine.py)
     with its MESH_SHARDS=4 shards on cuda:{s % device_count} (all four on
     one card here: the per-shard kernels and the merge, no cross-GPU
     traffic): the build's D_l, layout and device bytes per shard; K1 and
     K2 at one shard's [T, D_l] against their plain versions (the
     membership_shard and mixed_shard records); B=128 keyword and mixed
     batches of the query mix through the S=4 mesh and a 2-D (q=2, d=2)
     mesh, and in phase 16 (beside the bench's oracle modes) a BM25 mesh
     and a forced doc-sorted mesh (its doc_perm built), each top-50 equal
     to the single-device engine on the card (scores within rtol 1e-5,
     atol 1e-7) with both engines' ms per batch; the HTTP front end over the S=4 mesh
     after warmup() answers the serving phase's requests from 8 clients,
     every response 200 and equal to the single-device plain path, K1 and
     K2 launched a positive multiple of 4 times; sharded_pagerank on the
     100k graph twice (bit-identical, within rtol 1e-5 / atol 1e-9 of
     float64 on the CPU);
 13. the graft entry points (graft_entry.py): entry("cuda") (the fused
     mixed step, K2, on a 2,048-doc synthetic snapshot) equal to its plain
     path, top-10 within rtol 1e-6; dryrun_multichip(4) (a 2 x 2 mesh, shard
     s on cuda:{s % device_count}): the sharded scorer, sharded PageRank and
     one POST /query through ShardedQueryEngine behind SearchServer, K1/K2
     launches a positive multiple of 4, and the scorer's top-10 (rtol
     1e-6), the ranks (rtol 1e-5, atol 1e-9) and the HTTP results equal to
     the same call on the plain path;
 14. refresh under load at the 100k corpus: a copy of the corpus store
     behind the port's SearchServer (batching on) after warmup(), 8 client
     threads (POST and GET /query) and a /wordlist poller in a process of
     their own; one cycle of an append subprocess (10 pages through
     index_page, each titled with a word no other page has) and POST
     /refresh; after it, /healthz counts the new docs, the cycle's word
     finds exactly its pages, the query mix through the server equals the
     refreshed engine's plain path and K1 and K2 launched after the swap;
     every answer of the load 200 JSON; after the last refresh's checks,
     with the load paused and the server still up, and again after the
     server's shutdown, memory_allocated below its level before the first
     refresh plus half the index; each refresh's seconds and lock seconds,
     the peak
     max_memory_allocated and the load's req/s and p50/p99 during each
     refresh and before the first;
 15. the soaks as the JAX package runs them, each a process of its own
     with its server on the card: cli.soak --seconds 60 (no error, at least
     2 refreshes) runs beside phase 3, and so does the set-up of
     cli.soak_sharded --device cuda:0 --seconds 90 (its 524,288-doc store,
     its server with 8 shards on the one card, its warm pass), which then
     waits for its start file; its load and refreshes run after phase 14,
     beside phase 18's crash soak (no error, at least 1 refresh, p50/p99,
     and its server segregating phrase-class batches, as it does from 2^19
     docs). Phase 3 is
     set-up too; the two run beside it so that the smoke keeps its time
     limit.
 16. the port's bench (spaghettisearch_tpu_torch/bench.py), each mode in a
     process of its own on the card, on phase 3's corpus: parity with 256
     queries against the reference-semantics oracle (recall@10 1.0, every
     top-50 divergence tie-explained, score_max_rel_err <= 1e-6, K2
     launched: its 64-query batches each hold a phrase), parity_rare (the
     same bars in each of its six families, in three processes; K1 in
     kw_catchall, K2 in big_batch), serve --routeMix (512 connections, the server in a
     subprocess: every answer 200, the contract on one request, all three
     routes answered), scale1m (1M synthetic docs at B=256: K1 launched,
     the first batch's top-10 equal to the plain path; the index's device
     bytes and the memory_allocated peak) and sparse2m's body at 100k (no
     position planes with the posT budget at 0, the sparse lane's matcher
     ran, every divergence from the oracle tie-explained). These run at
     once, with phase 4's adversarial batches, phase 12's BM25 and
     doc-sorted meshes and phase 17 in this process meanwhile (the oracle
     is host Python, so the card is mostly idle); serve runs alone after
     them.
 17. the probes of experiments/ on the card (inside phase 16's window):
     K5 against its plain version on batches that stress a streaming
     top-k (no hit, fewer hits than k_pad, 20 equal finals across doc
     tiles so the k-th cut falls in a tie, a duplicated term, B=45 and 77
     against 32-row tiles) and on check.ADVERSARIAL; K6, its table
     build and its phrase-row partition (phrase_delta.plain_phrase_rows)
     on check.ADVERSARIAL's phrases; K2 with the doc-sorted body bound
     (body_tmax) at each tmax_stage ("kw", "phrase", "both") on the
     B=128 and B=16 mixed batches and the adversarial batches, with and
     without qnb, counts on and elided, each output torch.equal to K2
     without the bound and within K2's tolerance of its plain version;
     the sixteen corpus, top-k and dispatch probes (PROBES_IN_PROCESS:
     their run() on phase 3's corpus and engine, at --reps 1; those whose
     originals default to the crawl-built 1M corpus at 100k: the
     shard-scale probe's 8- and 4-shard slices without a projection, the
     h2d, fetch-async and kw-gap probes among them), each required to
     pass its own exactness check, their seconds printed; and nine probe
     scripts (torch_fused2_probe, torch_phrase_delta_probe at 100k,
     torch_tbound_probe, torch_membership_tune, torch_sparse_probe at
     250,000 of its original's 1M synthetic docs, torch_roofline with
     its headline program at 100k, torch_bw_probe, torch_scorer_split_probe
     and torch_headline_chain_probe at 100k), started with phase 16's
     modes, each in a process of its own, each required to pass its
     exactness check; the fused2 and phrase-delta probes' K5 and K6
     launches are those kernels' launches on their paths, and the bounded
     K2 launches of torch_mixed_tbound_probe's run are the mixed_tmax
     entry's;
 18. the crash soak (started with phase 15's load, its checks inside
     phase 16's window):
     experiments/torch_crash_recovery.py --phase all in a process of its
     own on a copy of phase 3's corpus: a bulk indexer SIGKILLed 0.35 s
     into its third flush cycle (committed flushes intact, the
     post-recovery append read back), then the port's server SIGKILLed
     20 s after POST /refresh (required: killed_mid_refresh, the stale
     hydration sidecar detected and rebuilt with the recovered store's
     fingerprint, no temporary sidecar loaded) and restarted on the card;
     the first 64 queries of the serving phase's mix go to the restarted
     server, and the soak's own QueryEngine on the card over the same
     recovered store and snapshot ranks them with the kernels (K1 and K2
     launched) and on the plain path (--checkQueries): every answer equal
     to both; this process holds the soak's holds() on its result.
 19. the build hold (in phase 16's window, a process of its own): the
     benchmark corpus at HOLD_PAGES pages of the same seed built in
     several processes and in one on this host, PageRank on the card in
     both: every table's order-free digest equal, but doc_magnitude and
     doc_rank (sums in the store's row order) within 1e-12 and 1e-6
     relative, the docs pack's files byte for byte, the snapshots' arrays;
     the parallel build's own snapshot (assembled from its key buckets)
     equal in every field, exactly, to build_snapshot of its store, and
     its uncompressed save read back through load_snapshot equal to it;
     each build's seconds per step;
 20. the 2M tier's path on phase 3's corpus (in phase 16's window, a
     process of its own; the 2M corpus does not fit the smoke's time
     limit, so the gates are lowered below the 100k corpus instead):
     HOT_MAX_DPAD and FWD_DEV_MAX_DPAD below its D_pad, SEGREGATE_MIN_DOCS
     at its doc count; no hot-term cache and ft/fw/fj on the host after
     the build and after serving; a SearchServer (batching on,
     segregate="auto") segregating phrase-class batches answers the
     serving phase's mix, every answer 200 JSON and equal to the
     default-gate engine's plain path, K1 and K2 launched; phrases under a
     custom blend take the sparse lane, whose first call uploads ft/fw/fj
     once and whose top-50 equals the plain path.
The wall seconds of each phase are printed before the kernels' line.
Every phase that ranks resets the launch counts before it and reads them
after. The line before the last is the kernels' JSON record; the last line
is {"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import datetime
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PAGES = 100_000  # the benchmark corpus's size (bench.py build_bench_corpus)
QUERIES = 320  # POST /query requests of each serving phase
CLIENTS = 8  # concurrent HTTP client threads
#: the CSR route sums a doc's postings in scatter order, the dense path in
#: slot order: the JAX package's own bar between the two formulations
#: (tests/test_scoring_paths.py) is rel 1e-5, abs 1e-7 on scores
CSR_RTOL = 1e-5


def say(msg: str) -> None:
    print(msg, flush=True)


def probe_util():
    """experiments/torch_probe_util.py, the helpers the probes share."""
    path = os.path.join(HERE, "experiments")
    if path not in sys.path:
        sys.path.insert(0, path)
    import torch_probe_util

    return torch_probe_util


def plain_kernels():
    """Route the scorers through the kernels' plain versions (the on-card
    reference of the ranking phases): a context manager."""
    return probe_util().plain_kernels()


@contextlib.contextmanager
def count_matcher_calls():
    """Count the sparse phrase lane's matcher calls (the engine's forward
    and CSR matchers) inside the block: yields a one-element list."""
    from spaghettisearch_tpu_torch.retrieval import engine as eng_mod

    calls = [0]
    saved = eng_mod.match_phrase_fwd_batch, eng_mod.match_phrase_batch

    def counted(fn):
        def wrapper(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapper

    eng_mod.match_phrase_fwd_batch, eng_mod.match_phrase_batch = map(counted, saved)
    try:
        yield calls
    finally:
        eng_mod.match_phrase_fwd_batch, eng_mod.match_phrase_batch = saved


def reset_launches() -> None:
    from spaghettisearch_tpu_torch.ops.kernels import (
        finalize, fused, fused_topk, membership, mixed, phrase_delta,
    )

    for mod in (membership, mixed, fused, fused_topk, phrase_delta, finalize):
        mod.reset_launches()


def launches() -> dict:
    from spaghettisearch_tpu_torch.ops.kernels import (
        finalize, fused, fused_topk, membership, mixed, phrase_delta,
    )

    return {"membership": membership.LAUNCHES, "mixed": mixed.LAUNCHES,
            "membership_1sec": membership.LAUNCHES_1SEC, "fused": fused.LAUNCHES,
            "fused_topk": fused_topk.LAUNCHES, "phrase_delta": phrase_delta.LAUNCHES,
            "finalize": finalize.LAUNCHES}


def same_results(got: list[dict], want: list[dict], rtol: float = 1e-6) -> bool:
    """Equal ranked lists up to ties (torch_probe_util.same_results)."""
    return probe_util().same_results(got, want, rtol)


def same_topk(got_s, got_i, want_s, want_i, rtol: float, atol: float) -> bool:
    """Equal [B, K] top-k rows up to ties: scores position by position
    within rtol/atol (-inf where the reference has -inf), and where the ids
    differ the got id's reference score ties the reference's score there
    (the k-th score for an id the reference did not rank)."""
    import numpy as np

    got_s, got_i, want_s, want_i = (np.asarray(x.cpu()) for x in (got_s, got_i, want_s, want_i))
    if got_s.shape != want_s.shape:
        return False
    for gs, gi, ws, wi in zip(got_s, got_i, want_s, want_i):
        fin = np.isfinite(ws)
        if not np.array_equal(np.isfinite(gs), fin):
            return False
        if not np.allclose(gs[fin], ws[fin], rtol=rtol, atol=atol):
            return False
        ref = dict(zip(wi[fin].tolist(), ws[fin].tolist()))
        last = ws[fin][-1] if fin.any() else 0.0
        for g, w, s in zip(gi[fin], wi[fin], ws[fin]):
            if g != w and abs(ref.get(int(g), last) - s) > atol + rtol * abs(s):
                return False
    return True


def check_ranked(queries: list[str], got: list[list[dict]], want: list[list[dict]],
                 what: str, rtol: float = 1e-6) -> int:
    """Every ranked list well-formed and equal to the reference's. -> the
    number of results."""
    n_hits = 0
    for q, g, w in zip(queries, got, want):
        n_hits += len(g)
        ranks = [r["FinalRank"] for r in g]
        if ranks != sorted(ranks, reverse=True) or not all(
            isinstance(x, float) and x == x and abs(x) != float("inf") for x in ranks
        ):
            raise RuntimeError(f"{what}: bad FinalRank order/values for {q!r}")
        if not same_results(g, w, rtol):
            raise RuntimeError(f"{what}: results differ from the plain path for {q!r}")
    return n_hits


def fetch(base: str, kind: str, arg: str, timeout: float = 300) -> tuple[int, object]:
    """One request to the server at `base`: kind post (POST /query), get
    (GET /query/{arg}), wordlist (GET /wordlist/{arg}), healthz or refresh
    (POST /refresh). Raises on an HTTP error or a body that is not JSON.
    -> (status, parsed body)."""
    if kind in ("post", "refresh"):
        path, payload = ("/query", {"query": arg}) if kind == "post" else ("/refresh", {})
        req = urllib.request.Request(
            base + path, data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
    elif kind == "healthz":
        req = base + "/healthz"
    else:
        req = base + ("/query/" if kind == "get" else "/wordlist/") + urllib.parse.quote(arg)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def send_jobs(base: str, jobs: list[tuple[str, str]], clients: int) -> tuple[dict, float]:
    """Send `jobs` ((kind, arg): post / get / wordlist) to the server at
    `base` from `clients` threads. Raises the first client error, and
    unless every response is 200. -> ({(kind, arg): (status, body,
    seconds)}, wall seconds)."""
    results: dict[tuple[str, str], tuple[int, object, float]] = {}
    lock = threading.Lock()
    errors: list[BaseException] = []

    def fetch_one(kind: str, arg: str) -> None:
        t = time.perf_counter()
        status, body = fetch(base, kind, arg)
        with lock:
            results[(kind, arg)] = (status, body, time.perf_counter() - t)

    def client(part: list[tuple[str, str]]) -> None:
        try:
            for job in part:
                fetch_one(*job)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(jobs[i::clients],)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if not all(v[0] == 200 for v in results.values()):
        raise RuntimeError("a request did not answer 200")
    return results, wall


def http_burst(engine, jobs: list[tuple[str, str]], clients: int) -> tuple[dict, float]:
    """Serve `engine` through the port's SearchServer (micro-batching on)
    and send_jobs(jobs, clients) to it."""
    from spaghettisearch_tpu_torch.serve.server import SearchServer

    server = SearchServer(engine, batching=True)
    host, port = server.start_background(port=0)
    try:
        return send_jobs(f"http://{host}:{port}", jobs, clients)
    finally:
        server.shutdown()


def latency_stats(results: dict, n: int, wall: float) -> dict:
    """n requests answered in `wall` seconds: req/s, and the POST
    latencies' p50 and p99 (host clock)."""
    lat = sorted(v[2] for k, v in results.items() if k[0] == "post")
    return {"requests": n, "req_per_s": n / wall, "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(len(lat) * 0.99)]}


def latency_line(results: dict, n: int, wall: float) -> str:
    st = latency_stats(results, n, wall)
    return (f"{n} POST /query from {CLIENTS} clients in {wall:.3f}s = {st['req_per_s']:.1f} "
            f"req/s; latency p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms")


def row_terms(batch: dict, section: str, phrases: bool = False) -> list[set]:
    """check.row_terms: per row, the distinct query terms a section's sweep
    matches (bound_ms's rows)."""
    from spaghettisearch_tpu_torch.ops.kernels import check

    return check.row_terms(batch, section, phrases)


def phrase_rows(batch: dict, rows: int, n_words: int) -> dict:
    """The first `rows` rows of a mixed batch with their keyword columns
    emptied: what K6 reads (row_terms of it, with phrases, are the rows'
    phrase terms alone)."""
    import torch

    dev = batch["ph_ids"].device
    return {"term_ids": torch.full((rows, 1), n_words, dtype=torch.int32, device=dev),
            "qn": torch.zeros(rows, dtype=torch.int32, device=dev), "split": False,
            "ph_ids": batch["ph_ids"][:rows], "ph_valid": batch["ph_valid"][:rows]}


def bound_ms(index, sweeps: list, b: int, n_out: int, extra_bytes: int = 0) -> tuple[float, str]:
    """check.bound_ms for a call at batch b on this index's [T, D] tiles."""
    from spaghettisearch_tpu_torch.ops.kernels import check

    return check.bound_ms(sweeps, index.n_words, b, index.n_docs_padded, n_out, extra_bytes)


def library_calls(idx, n_words: int, batch: dict, want: list,
                  sections=("title", "body")) -> list:
    """The operands of torch.sparse.mm(W, M) per section, the one PyTorch
    call that computes the membership scores (and counts, with a W of
    ones): W the CSR [D, V+1] doc-term weight matrix from the forward
    tiles (each doc's columns sorted), M the dense [V+1, B]
    query-multiplicity matrix of the columns the section's sweep reads
    (row_terms' rule); sparse.mm(W, M)[d, b] is score[b, d]. Built outside
    the timed region. `want` holds the plain version's (score, count or
    None) per section: each call's result is held against it (scores
    within check.RTOL, counts exact) before it is timed, and a
    disagreement raises."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check

    b, q = batch["term_ids"].shape
    big = torch.iinfo(torch.int32).max
    calls = []
    for sec, (w_score, w_count) in zip(sections, want):
        fwd = getattr(idx, sec).fwd
        ft, order = torch.where(fwd.ftT >= 0, fwd.ftT, big).t().sort(dim=1)
        fw = fwd.fwT.t().gather(1, order)
        real = ft != big
        crow = torch.zeros(ft.shape[0] + 1, dtype=torch.int64, device=ft.device)
        crow[1:] = real.sum(1).cumsum(0)
        cold = batch["split"] and sec == "body"
        active = batch["qnb"] if cold else batch["qn"]
        col = torch.arange(q, device=ft.device)[None, :]
        tq = torch.where(col < active[:, None], batch["term_ids"].long(), n_words)
        m = torch.zeros((n_words + 1, b), dtype=torch.float32, device=ft.device)
        m.index_put_((tq.clamp(min=0, max=n_words).flatten(),
                      torch.arange(b, device=ft.device).repeat_interleave(q)),
                     torch.ones(b * q, device=ft.device), accumulate=True)
        m[n_words] = 0.0  # unknown words and inactive columns
        for w, ref, what in ((fw[real], w_score, "scores"),
                             (torch.ones_like(fw[real]), w_count, "counts")):
            if ref is None:
                continue
            mat = torch.sparse_csr_tensor(crow, ft[real].long(), w, size=(ft.shape[0], n_words + 1))
            got = torch.sparse.mm(mat, m).t()
            same = (torch.equal(got, ref) if what == "counts"
                    else bool(torch.isclose(got, ref, rtol=check.RTOL, atol=0.0).all()))
            if not same:
                err = float((got - ref).abs().max())
                raise RuntimeError(f"torch.sparse.mm {sec} {what} differ from the plain "
                                   f"version (max abs err {err})")
            calls.append((mat, m))
    return calls


#: phase 10: the crawl's size (4 times the CLI's default of 500 pages; cut
#: from 10,000 to 5,000 and then to 2,000 to hold the smoke's time limit),
#: its ODP categories, and the time limit of the crawl subprocess
CRAWL_PAGES = 2_000
ODP_CATEGORIES = 16
CRAWL_TIMEOUT_S = 600
HTTP_DATE = "Thu, 01 Jan 2026 00:00:00 GMT"
#: phase 11: the card's float32 ranks against float64 on the CPU
PAGERANK_RTOL, PAGERANK_ATOL = 1e-5, 1e-9


def crawl_site(n_pages: int, seed: int) -> dict[str, bytes]:
    """bench.py's pages for an n_pages corpus by path, plus a home page `/`
    linking /p0 and every page that /p0 does not reach, so that a crawl
    from `/` reaches all of them."""
    from collections import deque

    from spaghettisearch_tpu_torch.corpus import render_pages

    pages = render_pages(n_pages=n_pages, seed=seed)
    kids = [[int(j) for j in re.findall(rb'href="/p(\d+)"', pages[f"/p{i}"])] for i in range(n_pages)]
    seen, todo = {0}, deque([0])
    while todo:
        for j in kids[todo.popleft()]:
            if j not in seen:
                seen.add(j)
                todo.append(j)
    roots = [0] + [i for i in range(n_pages) if i not in seen]
    links = "".join(f'<a href="/p{i}">p{i}</a>\n' for i in roots)
    pages["/"] = (f"<html><head><title>site index</title></head><body><p>all pages</p>\n"
                  f"{links}</body></html>").encode()
    return pages


def odp_directory(resource_base: str, n_pages: int, n_cat: int = ODP_CATEGORIES) -> dict[str, bytes]:
    """A directory site shaped like tests/test_crawl.py's ODP fixture: a
    seed page whose #triple list links n_cat categories; each category
    page lists one subcategory and resource links (`li.listings h4 a`) to
    pages of the crawled site at resource_base, whose titles make the
    category's term profile."""
    cats = [f"Topic{c:02d}" for c in range(n_cat)]
    items = "".join(f'<li><a href="/{c}">{c}</a></li>' for c in cats)
    site = {"/": f'<html><body><div class="container"><ul id="triple">{items}</ul></div>'
                 f"</body></html>".encode()}
    for k, c in enumerate(cats):
        res = "".join(f'<li class="listings"><h4><a href="{resource_base}/p{j}">p{j}</a></h4></li>'
                      for j in range(k, n_pages, n_pages // 8 + 1))
        site[f"/{c}"] = (f'<html><body><div class="container"><ul id="triple"><li>'
                         f'<a href="/{c}/More">More</a></li></ul><ul>{res}</ul></div></body>'
                         f"</html>").encode()
        site[f"/{c}/More"] = (f'<html><body><div class="container"><ul><li class="listings">'
                              f'<h4><a href="{resource_base}/p{(7 * k + 3) % n_pages}">r</a></h4>'
                              f"</li></ul></div></body></html>").encode()
    return site


def pagerank_bound_ms(n: int, e: int, c: int, n_vectors: int) -> float:
    """The least time of one PageRank iteration on the card: its bytes over
    the memory rate: the edge arrays (int32 sources and the int32 row
    pointer), the [C, E] gather of float32 contributions, and n_vectors
    float32 [C, N] vectors (read or written), each once; the per-node
    out-degree weights (4 B each) too."""
    from spaghettisearch_tpu_torch.ops.kernels.check import HBM_BYTES_PER_S

    nbytes = 4 * e + 4 * (n + 1) + 4 * c * e + 4 * n_vectors * c * n + 4 * n
    return 1e3 * nbytes / HBM_BYTES_PER_S


def build_all() -> list:
    """`make -C native` and one nvcc per CUDA source, all started together."""
    from spaghettisearch_tpu_torch.ops.kernels import (
        finalize, fused, fused_topk, membership, mixed, phrase_delta,
    )

    t0 = time.perf_counter()
    with ThreadPoolExecutor(7) as ex:
        native = ex.submit(subprocess.run, ["make", "-C", os.path.join(HERE, "native"), "-s"],
                           check=True)
        libs = [ex.submit(mod.library)
                for mod in (membership, mixed, fused, fused_topk, phrase_delta, finalize)]
        native.result()
        built = [f.result() for f in libs]
    say(f"# native libraries and kernels built in {time.perf_counter() - t0:.1f}s")
    for lib in built:
        say(f"# kernel {os.path.relpath(lib.path, HERE)} built in {lib.seconds:.1f}s (sm_90a):")
        for line in lib.log.splitlines():
            if re.search(r"Compiling entry|registers|spill|smem|Function properties", line):
                say("#   " + line.strip())
    return built


def crawl_phase(seed: int, smi: str, phase_launches: dict) -> dict:
    """Phase 10 (see the module docstring). -> the crawl's report."""
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.crawl.localsite import LocalSite
    from spaghettisearch_tpu_torch.evaluation import compare_rankings
    from spaghettisearch_tpu_torch.index.indexer import index_page
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.ops.pagerank import update_pagerank
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
    from spaghettisearch_tpu_torch.store.tables import Database

    t0 = time.perf_counter()
    site_pages = crawl_site(CRAWL_PAGES, seed)
    crawl_root = os.path.join(HERE, "build", "smoke_crawl")
    shutil.rmtree(crawl_root, ignore_errors=True)
    with LocalSite(site_pages, last_modified=HTTP_DATE) as site, \
            LocalSite(odp_directory(site.base, CRAWL_PAGES)) as odp:
        cmd = [sys.executable, "-m", "spaghettisearch_tpu_torch.cli.crawl",
               "--startURL", site.base + "/", "--numPages", str(len(site_pages)),
               "--db", os.path.join(crawl_root, "store"), "--odpURL", odp.base + "/",
               "--topicPagerank", "--saveSnapshot", os.path.join(crawl_root, "snapshot"),
               "--device", "cuda"]
        out = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                             timeout=CRAWL_TIMEOUT_S)
        site_base, site_requests, odp_requests = site.base, site.requests, odp.requests
    t_crawl = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"the crawl CLI failed ({out.returncode}): {out.stderr[-3000:]}")
    lines = out.stdout.splitlines()
    for line in lines:
        if re.match(r"(Crawl|PageRank|ODP|Total|Snapshot|Updating|\{'crawl)", line):
            say(f"# crawl CLI: {line.strip()} ({smi})")
    visited = re.search(r"Total visited length: (\d+) \(indexed (\d+), errors (\d+)\)",
                        out.stdout)
    rate = re.search(r"Crawl: (\d+) pages indexed in ([\d.]+)s = ([\d.]+) pages/s", out.stdout)
    pr_line = re.search(r"PageRank on \S+: (\d+) nodes, (\d+) edges, (\d+) categories, "
                        r"(\d+) iterations in ([\d.]+) ms", out.stdout)
    if not (visited and rate and pr_line):
        raise RuntimeError(f"the crawl CLI's report is incomplete: {out.stdout[-3000:]}")
    n_vis, n_idx, n_err = map(int, visited.groups())
    if n_err or n_vis != len(site_pages) or n_idx != len(site_pages):
        raise RuntimeError(f"crawl: visited {n_vis}, indexed {n_idx}, errors {n_err} of "
                           f"{len(site_pages)} pages")
    if int(pr_line.group(3)) != ODP_CATEGORIES:
        raise RuntimeError(f"crawl: PageRank ran {pr_line.group(3)} ODP categories, "
                           f"not {ODP_CATEGORIES}")
    crawled = Database(os.path.join(crawl_root, "store"))
    t1 = time.perf_counter()
    ref_db = Database(None)
    ts = datetime.datetime(2026, 1, 1, tzinfo=datetime.timezone.utc)
    with ref_db.bulk():
        for path, html in site_pages.items():
            index_page(ref_db, html, site_base + path, last_modified=ts)
    t_inproc = time.perf_counter() - t1
    raw_got = dict(crawled.inverted_raw("body").items())
    raw_want = dict(ref_db.inverted_raw("body").items())
    pos_got = {w: {d: p[1:] for d, p in row.items()} for w, row in crawled.inv_body.items()}
    pos_want = {w: {d: p[1:] for d, p in row.items()} for w, row in ref_db.inv_body.items()}
    if raw_got != raw_want or pos_got != pos_want:
        raise RuntimeError("the crawled body postings differ from an in-process build")
    n_post = sum(len(r) for r in raw_want.values())
    say(f"# crawl: {len(site_pages)} pages fetched and indexed, no errors ({site_requests} "
        f"site and {odp_requests} directory requests); body postings ({len(raw_want)} terms, "
        f"{n_post} postings) equal an in-process build ({t_inproc:.1f}s, "
        f"{len(site_pages) / t_inproc:.1f} pages/s on the host); {t_crawl:.1f}s with the CLI's start")
    # PageRank again in this process, warm: bit-identical to the CLI's ranks
    cli_ranks = dict(crawled.doc_rank.items())
    warm = [update_pagerank(crawled, personalized=True, device="cuda") for _ in range(2)]
    if dict(crawled.doc_rank.items()) != cli_ranks:
        raise RuntimeError("PageRank of the crawled store differs from the crawl CLI's")
    say(f"# crawled store: PageRank again in this process, warm: {warm[0]['iterations']} "
        f"iterations in {warm[0]['ms']:.3f} / {warm[1]['ms']:.3f} ms, ranks bit-identical to "
        f"the CLI's ({smi})")
    crawl_snap = load_snapshot(os.path.join(crawl_root, "snapshot"))
    topic = QueryEngine(crawled, snapshot=crawl_snap, device="cuda", use_topic_model=True)
    topic.warmup()
    crawl_q = bench_queries(crawl_snap, 96, seed=seed + 2, phrase_every=4, db=crawled)
    reset_launches()
    got = topic.query_batch(crawl_q)
    phase_launches["crawl_serving"] = launches()
    with plain_kernels():
        ref = topic.query_batch(crawl_q)
    n_hits = check_ranked(crawl_q, got, ref, "crawled store")
    parity = compare_rankings([[(r["Url"], r["FinalRank"]) for r in g] for g in got],
                              [[(r["Url"], r["FinalRank"]) for r in w] for w in ref], k=10)
    launched = phase_launches["crawl_serving"]["membership"] + phase_launches["crawl_serving"]["mixed"]
    if launched == 0:
        raise RuntimeError("the crawled store's queries launched no kernel")
    say(f"# crawled store: topic-model engine on the card, {len(crawl_q)} queries equal the plain "
        f"path ({n_hits} results; parity {parity.to_json()}); launches "
        f"{phase_launches['crawl_serving']}; "
        f"{time.perf_counter() - t0:.1f}s")
    crawl_report = {
        "pages": len(site_pages), "pages_per_s": float(rate.group(3)),
        "crawl_s": float(rate.group(2)), "pagerank_ms": float(pr_line.group(5)),
        "pagerank_nodes": int(pr_line.group(1)), "pagerank_edges": int(pr_line.group(2)),
        "pagerank_iterations": int(pr_line.group(4)),
        "pagerank_warm_ms": [w["ms"] for w in warm],
        "pagerank_bound_ms_per_iter": pagerank_bound_ms(
            int(pr_line.group(1)), int(pr_line.group(2)), ODP_CATEGORIES, 3),
    }
    say(f"# crawl report: {json.dumps(crawl_report)} ({smi})")
    crawled.close()
    return crawl_report


def pagerank_phase(db, seed: int, smi: str) -> dict:
    """Phase 11 (see the module docstring). -> the PageRank report."""
    import numpy as np
    import torch

    from spaghettisearch_tpu_torch.ops import pagerank as pr

    t0 = time.perf_counter()

    node_list, e_src, e_dst, outdeg = pr._load_graph(db)
    n_nodes, n_edges = len(node_list), len(e_src)
    cats = sorted(db.topic_meta.keys())
    n_pages = np.array([float(db.topic_meta.get(c)["numPages"]) for c in cats])
    rng = np.random.default_rng(seed + 11)
    pers = rng.random((16, n_nodes)) * (rng.random((16, n_nodes)) < 0.01)
    pers[0] = 1.0
    pers /= pers.sum(axis=1, keepdims=True)

    def pagerank_run(model: str, device: str, dtype):
        fn = pr.pagerank_power if model == "power" else pr.pagerank_personalized
        extra = n_pages if model == "power" else pers
        args_ = [torch.as_tensor(e_src, device=device), torch.as_tensor(e_dst, device=device),
                 torch.as_tensor(outdeg, dtype=dtype, device=device),
                 torch.as_tensor(extra, dtype=dtype, device=device), n_nodes]
        stats: dict = {}
        if device == "cuda":
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ranks = fn(*args_, stats=stats)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
        else:
            t = time.perf_counter()
            ranks = fn(*args_, stats=stats)
            ms = 1e3 * (time.perf_counter() - t)
        return ranks.cpu().numpy(), stats["iterations"], ms

    pagerank_report = {}
    for model, c, n_vec in (("power", len(cats), 2), ("personalized", 16, 3)):
        pagerank_run(model, "cuda", torch.float32)  # warm the allocator and the kernels
        r1, it1, ms1 = pagerank_run(model, "cuda", torch.float32)
        r2, it2, ms2 = pagerank_run(model, "cuda", torch.float32)
        r64, it64, ms64 = pagerank_run(model, "cpu", torch.float64)
        # the port's float32 stop on the CPU, beside the card's: the float32
        # stop depends on the order of the sums (tests/test_torch_pagerank.py)
        _, it32, ms32 = pagerank_run(model, "cpu", torch.float32)
        if not (np.array_equal(r1.view(np.uint32), r2.view(np.uint32)) and it1 == it2):
            raise RuntimeError(f"pagerank_{model}: two runs on the card differ")
        if not np.allclose(r1, r64, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL):
            err = float(np.max(np.abs(r1 - r64) / np.maximum(np.abs(r64), 1e-30)))
            raise RuntimeError(f"pagerank_{model}: float32 on the card differs from float64 "
                               f"on the CPU (max rel err {err})")
        bound = pagerank_bound_ms(n_nodes, n_edges, c, n_vec)
        rel = float(np.max(np.abs(r1 - r64) / np.maximum(np.abs(r64), 1e-30)))
        pagerank_report[model] = {
            "nodes": n_nodes, "edges": n_edges, "categories": c, "iterations": it1,
            "iterations_f64": it64, "iterations_cpu_f32": it32, "cpu_f32_ms": ms32,
            "ms": [ms1, ms2], "ms_per_iter": [ms1 / it1, ms2 / it2],
            "bound_ms_per_iter": bound, "cpu_f64_ms": ms64, "max_rel_err_vs_f64": rel,
        }
        say(f"# pagerank_{model}: {n_nodes} nodes, {n_edges} edges, C={c}: {it1} iterations "
            f"on the card (float32 on the CPU: {it32}; f64: {it64}), {ms1:.3f} / {ms2:.3f} ms "
            f"per build on the card "
            f"({ms1 / it1:.4f} ms per iteration, bound {bound:.4f} ms by bytes), two runs "
            f"bit-identical, within rtol {PAGERANK_RTOL} / atol {PAGERANK_ATOL} of float64 on the CPU "
            f"({ms64:.1f} ms; max rel err {rel:.3g}) ({smi})")
    say(f"# pagerank report: {json.dumps(pagerank_report)}; {time.perf_counter() - t0:.1f}s")
    return pagerank_report


#: phase 12: the mesh's doc shards (shard s on cuda:{s % device_count}) and
#: the bar between the mesh and the single-device engine (the JAX package's
#: own between sharded and single-chip, tests/test_sharded.py)
MESH_SHARDS = 4
MESH_RTOL, MESH_ATOL = 1e-5, 1e-7


def mesh_phase(db, snap, engine, queries: list[str], kw_only: list[str], serving_ref: list,
               df, smi: str, phase_launches: dict) -> dict:
    """Phase 12 (see the module docstring). `engine` is the single-device
    engine on the card and `serving_ref` its plain-path answers to
    queries + kw_only. -> per kernel ("membership_shard", "mixed_shard"):
    its checks, (ms, plain ms), bound and library ms at one shard's shape;
    and "variants": a function that holds the BM25 and the doc-sorted
    meshes to their single-device engines (phase 16 runs it)."""
    import numpy as np
    import torch

    from spaghettisearch_tpu_torch.config import PAGERANK_CONVERGENCE, PAGERANK_DAMPING
    from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
    from spaghettisearch_tpu_torch.ops import pagerank as pr
    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.parallel import sharded
    from spaghettisearch_tpu_torch.parallel.mesh import make_mesh
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.retrieval.sharded_engine import ShardedQueryEngine

    t_phase = time.perf_counter()
    shard_csr = sharded._shard_csr
    n_cards = torch.cuda.device_count()
    devices = [torch.device("cuda", s % n_cards) for s in range(MESH_SHARDS)]

    def build(what: str, **kw) -> ShardedQueryEngine:
        csr_s = [0.0]  # the host's CSR split (_shard_csr, both sections)

        def timed_csr(*a, **k):
            t = time.perf_counter()
            try:
                return shard_csr(*a, **k)
            finally:
                csr_s[0] += time.perf_counter() - t

        torch.cuda.synchronize()
        t = time.perf_counter()
        sharded._shard_csr = timed_csr
        try:
            eng = ShardedQueryEngine(db, snapshot=snap, devices=devices, **kw)
        finally:
            sharded._shard_csr = shard_csr
        torch.cuda.synchronize()
        sidx = eng.index.sidx
        sh = sidx.shards[0]
        say(f"# mesh {what}: {eng._mesh}; built in {time.perf_counter() - t:.1f}s (host numpy, "
            f"of which {csr_s[0]:.1f}s in _shard_csr, and the copies to the card); D_l "
            f"{sidx.docs_per_shard}, doc_sort "
            f"{sidx.doc_perm is not None}, hot terms "
            f"{0 if sidx.hot_body_map is None else len(sidx.hot_body_map)}, planes "
            f"{None if sh.body.posT is None else sh.body.posT.dtype}, body T "
            f"{sh.body.fwd.ftT.shape[0]}, title T {sh.title.fwd.ftT.shape[0]}, device bytes "
            f"per shard {sidx.device_bytes()}")
        return eng

    mesh = build(f"S={MESH_SHARDS}", n_shards=MESH_SHARDS)
    sidx = mesh.index.sidx
    if any(sh.device.type != "cuda" for row in sidx.rows for sh in row):
        raise RuntimeError("a shard of the mesh is not on the card")

    # K1 and K2 at one shard's [T, D_l], against their plain versions
    sh = sidx.shards[0]
    counts = sidx.has_zero_weight  # the scorers' emit_counts
    tmax = sh.body.tmax_blocks is not None
    kb = check.to_device(check.keyword_batch(sh, 128, 4, seed=12, df=df), sh.device)
    mb = check.to_device(check.mixed_batch(sh, 128, 4, 16, seed=13, df=df, snap=snap), sh.device)
    out: dict = {"membership_shard": {"checks": []}, "mixed_shard": {"checks": []}}
    for emit in (True, False):
        for kname, run in (("membership_shard", lambda e, p: check.run_k1(sh, kb, e, tmax, plain=p)),
                           ("mixed_shard", lambda e, p: check.run_k2(sh, mb, e, plain=p))):
            rep = check.compare(run(emit, False), run(emit, True))
            say(f"# {kname} B=128 at [T, D_l={sh.n_docs_padded}] counts={emit}: {rep}")
            if not rep["ok"]:
                raise RuntimeError(f"{kname} kernel disagrees with its plain version: {rep}")
            out[kname]["checks"].append(rep)
    out["membership_shard"]["times"] = (
        check.time_ms(lambda: check.run_k1(sh, kb, counts, tmax)),
        check.time_ms(lambda: check.run_k1(sh, kb, counts, tmax, plain=True), iters=5),
    )
    out["mixed_shard"]["times"] = (
        check.time_ms(lambda: check.run_k2(sh, mb, counts)),
        check.time_ms(lambda: check.run_k2(sh, mb, counts, plain=True), iters=3, warmup=1),
    )
    n_k = 4 if counts else 2
    out["membership_shard"]["bound"] = bound_ms(
        sh, [(getattr(sh, s).fwd.ftT, row_terms(kb, s)) for s in ("title", "body")], 128, n_k)
    out["mixed_shard"]["bound"] = bound_ms(
        sh, [(getattr(sh, s).fwd.ftT, row_terms(mb, s, True)) for s in ("title", "body")], 128, n_k)
    k1_want = check.run_k1(sh, kb, counts, tmax, plain=True)
    lib = library_calls(sh, snap.n_words, kb, [k1_want[:2], k1_want[2:]])
    out["membership_shard"]["library"] = check.time_ms(lambda: [torch.sparse.mm(w, m) for w, m in lib])
    out["mixed_shard"]["library"] = None
    for kname, rec in out.items():
        say(f"# {kname}: kernel {rec['times'][0]:.4f} ms, plain {rec['times'][1]:.4f} ms, bound "
            f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]}), library {rec['library']} ms per B=128 "
            f"call at one shard's shape ({smi})")

    # ranks: B=128 keyword and mixed batches of the query mix, each mesh
    # against the single-device engine on the card
    kw_parsed = [parse_query(q) for q in queries if '"' not in q][:128]
    mixed_parsed = [parse_query(q) for q in queries[:128]]
    if len(kw_parsed) != 128 or not any(p.phrase_hashes for p in mixed_parsed):
        raise RuntimeError("the query mix has no B=128 keyword or mixed batch")

    def hold_ranks(what: str, eng, single) -> None:
        for kind, parsed in (("keyword", kw_parsed), ("mixed", mixed_parsed)):
            got, want = eng.rank(parsed), single.rank(parsed)
            if not same_topk(*map(torch.from_numpy, got + want), rtol=MESH_RTOL, atol=MESH_ATOL):
                raise RuntimeError(f"mesh {what}: the {kind} batch's top-50 differs from the "
                                   "single-device engine")
            ms = check.time_ms(lambda: eng.rank(parsed), iters=5, warmup=1)
            ms1 = check.time_ms(lambda: single.rank(parsed), iters=5, warmup=1)
            say(f"# mesh {what}: B=128 {kind} top-50 equals the single-device engine "
                f"({int(np.isfinite(got[0]).sum())} ranked); {ms:.4f} ms per batch against "
                f"{ms1:.4f} ms single-device ({smi})")

    hold_ranks(f"S={MESH_SHARDS}", mesh, engine)
    other = build("2-D q=2 x d=2", n_shards=2, n_query_rows=2)
    hold_ranks("2-D q=2 x d=2", other, engine)
    del other
    torch.cuda.empty_cache()

    def variants() -> None:
        bm25_single = QueryEngine(db, snapshot=snap, index=engine.index, device="cuda",
                                  model=BM25Ranker())
        for what, kw, single in (("bm25", {"model": BM25Ranker()}, bm25_single),
                                 ("doc-sorted", {"doc_sort": True}, engine)):
            what += " (beside phase 16's oracle modes)"
            other = build(what, n_shards=MESH_SHARDS, **kw)
            if "doc_sort" in kw and other.index.sidx.doc_perm is None:
                raise RuntimeError("doc_sort=True built no doc-sorted layout")
            hold_ranks(what, other, single)
            del other
            torch.cuda.empty_cache()

    out["variants"] = variants

    # serving: the HTTP front end over the S=4 mesh
    t0 = time.perf_counter()
    mesh.warmup()
    mesh.prewarm_hydration()
    mesh.prewarm_wordlist()
    say(f"# mesh serving: warmup + hydration prewarm in {time.perf_counter() - t0:.1f}s")
    reset_launches()
    results, wall = http_burst(mesh, [("post", q) for q in queries] + [("get", q) for q in kw_only],
                               CLIENTS)
    phase_launches["mesh_serving"] = launches()
    n = phase_launches["mesh_serving"]
    if min(n["membership"], n["mixed"]) == 0 or n["membership"] % MESH_SHARDS or n["mixed"] % MESH_SHARDS:
        raise RuntimeError(f"mesh serving: K1/K2 launches {n} are not a positive multiple of "
                           f"{MESH_SHARDS}")
    got = [results[("post", q)][1] for q in queries] + [results[("get", q)][1] for q in kw_only]
    n_hits = check_ranked(queries + kw_only, got, serving_ref, "mesh serving", rtol=MESH_RTOL)
    out["serving"] = latency_stats(results, len(results), wall)
    say(f"# mesh serving: {len(results)} requests ({len(queries)} POST, {len(kw_only)} GET) from "
        f"{CLIENTS} clients in {wall:.3f}s = {out['serving']['req_per_s']:.1f} req/s; POST "
        f"latency p50 {out['serving']['p50_ms']:.2f} ms, p99 {out['serving']['p99_ms']:.2f} ms; "
        f"every response 200 and equal to the single-device plain path ({n_hits} results); "
        f"launches {n} ({smi})")
    del mesh, sidx, sh
    torch.cuda.empty_cache()

    # PageRank with the edges sharded by destination range
    node_list, e_src, e_dst, outdeg = pr._load_graph(db)
    n_nodes, n_edges = len(node_list), len(e_src)
    cats = sorted(db.topic_meta.keys())
    n_pages = np.array([float(db.topic_meta.get(c)["numPages"]) for c in cats])
    want = pr.pagerank_power(torch.as_tensor(e_src), torch.as_tensor(e_dst),
                             torch.as_tensor(outdeg, dtype=torch.float64),
                             torch.as_tensor(n_pages, dtype=torch.float64), n_nodes).numpy()
    pr_mesh = make_mesh(MESH_SHARDS, devices=devices)
    runs = []
    for _ in range(3):  # the first warms the allocator
        stats: dict = {}
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ranks = sharded.sharded_pagerank(pr_mesh, e_src, e_dst, outdeg.astype(np.float32),
                                 n_pages.astype(np.float32), n_nodes, damping=PAGERANK_DAMPING,
                                 eps=PAGERANK_CONVERGENCE, stats=stats)
        end.record()
        end.synchronize()
        runs.append((ranks.cpu().numpy(), stats["iterations"], start.elapsed_time(end)))
    (r1, it1, ms1), (r2, it2, ms2) = runs[1:]
    if not (np.array_equal(r1.view(np.uint32), r2.view(np.uint32)) and it1 == it2):
        raise RuntimeError("sharded_pagerank: two runs on the card differ")
    if not np.allclose(r1, want, rtol=PAGERANK_RTOL, atol=PAGERANK_ATOL):
        raise RuntimeError("sharded_pagerank: float32 on the card differs from float64 on the CPU")
    rel = float(np.max(np.abs(r1 - want) / np.maximum(np.abs(want), 1e-30)))
    bound = pagerank_bound_ms(n_nodes, n_edges, len(cats), 2)
    out["pagerank"] = {"nodes": n_nodes, "edges": n_edges, "categories": len(cats),
                       "iterations": it1, "ms": [ms1, ms2], "bound_ms_per_iter": bound,
                       "max_rel_err_vs_f64": rel}
    say(f"# sharded_pagerank S={MESH_SHARDS}: {n_nodes} nodes, {n_edges} edges, C={len(cats)}: "
        f"{it1} iterations, {ms1:.3f} / {ms2:.3f} ms per build with the host's edge split "
        f"({ms1 / it1:.4f} ms per iteration, bound {bound:.4f} ms by bytes), two runs "
        f"bit-identical, within rtol {PAGERANK_RTOL} / atol {PAGERANK_ATOL} of float64 on the "
        f"CPU (max rel err {rel:.3g}) ({smi})")
    say(f"# mesh phase: {time.perf_counter() - t_phase:.1f}s")
    return out


def entry_phase(smi: str, phase_launches: dict) -> dict:
    """Phase 13 (see the module docstring). -> its report."""
    import torch

    from spaghettisearch_tpu_torch.graft_entry import dryrun_multichip, entry

    t0 = time.perf_counter()
    fn, example = entry("cuda")
    reset_launches()
    got = fn(*example)
    torch.cuda.synchronize()
    phase_launches["entry"] = launches()
    with plain_kernels():
        want = fn(*example)
    if phase_launches["entry"]["mixed"] == 0:
        raise RuntimeError(f"entry() did not launch K2: {phase_launches['entry']}")
    if not same_topk(*got, *want, rtol=1e-6, atol=0.0):
        raise RuntimeError("entry(): the top-10 differs from the plain path")
    n_ranked = int(torch.isfinite(got[0]).sum())
    t1 = time.perf_counter()
    reset_launches()
    out = dryrun_multichip(MESH_SHARDS)
    torch.cuda.synchronize()
    phase_launches["dryrun"] = n = launches()
    if n["membership"] + n["mixed"] == 0 or n["membership"] % MESH_SHARDS or n["mixed"] % MESH_SHARDS:
        raise RuntimeError(f"dryrun_multichip: K1/K2 launches {n} are not a positive multiple "
                           f"of {MESH_SHARDS}")
    results = out["results"]
    if not (results and all(r["Url"].startswith("http") for r in results)):
        raise RuntimeError("dryrun_multichip: the sharded server answered no http results")
    reset_launches()
    with plain_kernels():
        want = dryrun_multichip(MESH_SHARDS)
    if any(launches().values()):
        raise RuntimeError(f"dryrun_multichip's plain path launched kernels: {launches()}")
    if not same_topk(out["scores"], out["ids"], want["scores"], want["ids"], rtol=1e-6, atol=0.0):
        raise RuntimeError("dryrun_multichip: the sharded scorer's top-10 differs from the plain path")
    if not torch.allclose(out["ranks"].cpu(), want["ranks"].cpu(), rtol=1e-5, atol=1e-9):
        raise RuntimeError("dryrun_multichip: the sharded PageRank differs from the plain path")
    check_ranked(['ranking "quantum physics" search'], [results], [want["results"]],
                 "dryrun_multichip")
    say(f"# entry(): B=8 top-10 on the card equals the plain path ({n_ranked} ranked); launches "
        f"{phase_launches['entry']}; {t1 - t0:.1f}s")
    say(f"# dryrun_multichip({MESH_SHARDS}): a 2 x 2 mesh, shard s on cuda:{{s % "
        f"{torch.cuda.device_count()}}}, scorer {tuple(out['scores'].shape)}"
        f", sharded PageRank {tuple(out['ranks'].shape)}, {len(results)} HTTP results (first "
        f"{results[0]['Url']}), each equal to the plain path; launches {n}; "
        f"{time.perf_counter() - t1:.1f}s ({smi})")
    return {"entry_ranked": n_ranked, "dryrun_results": len(results)}


#: phase 14: refresh cycles, each appending REFRESH_PAGES pages (no links,
#: so no stub docs) titled with a word no other page has
REFRESH_CYCLES = 1
REFRESH_PAGES = 10
REFRESH_MARKERS = ("zzrefreshalpha",)
REFRESH_SNIPPET = """
import random, sys
sys.path.insert(0, {here!r})
from datetime import datetime, timezone
from spaghettisearch_tpu_torch.corpus import make_page
from spaghettisearch_tpu_torch.index.indexer import index_page
from spaghettisearch_tpu_torch.store.tables import Database
db = Database({root!r})
rng = random.Random({seed})
for i in range({n}):
    url, html = make_page(rng, i, 1, {base!r})
    html = html.replace(b"<title>", b"<title>{marker} ", 1)
    index_page(db, html, url, last_modified=datetime(2026, 2, 1, tzinfo=timezone.utc))
db.flush(); db.close()
"""


def _load_clients(base: str, jobs: list, clients: int, go, stop, busy, n_errors, out) -> None:
    """The body of Load's process: `clients` threads cycling through their
    share of `jobs`, and a /wordlist poller every half second, until `stop`;
    a request starts only while `go` is set (`busy` counts those in flight).
    Sends (records, errors) to `out` at the end."""
    records: list[tuple[float, str, float]] = []
    errors: list[str] = []

    def client(part: list, every: float = 0.0) -> None:
        i = 0
        while not stop.is_set():
            if not go.wait(0.05):
                continue
            with busy.get_lock():
                if not go.is_set():
                    continue
                busy.value += 1
            kind, arg = part[i % len(part)]
            i += 1
            t = time.monotonic()
            try:
                status, body = fetch(base, kind, arg)
                if status != 200 or not isinstance(body, list):
                    raise ValueError(f"status {status}, {type(body).__name__} body")
                records.append((time.monotonic(), kind, time.monotonic() - t))
            except Exception as e:  # noqa: BLE001 — counted, raised by the phase
                errors.append(f"{kind} {arg!r}: {type(e).__name__}: {e}")
                with n_errors.get_lock():
                    n_errors.value += 1
            finally:
                with busy.get_lock():
                    busy.value -= 1
            if every:
                stop.wait(every)

    threads = [threading.Thread(target=client, args=(jobs[i::clients],)) for i in range(clients)]
    threads.append(threading.Thread(target=client, args=(
        [("wordlist", p) for p in ("w0", "w00", "w001", "w12")], 0.5)))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.send((records, errors))


class Load:
    """HTTP load on the server at `base` from a process of its own (the
    clients do not share the server's interpreter lock): `clients` threads
    cycling through their share of `jobs` ((kind, arg)) and a /wordlist
    poller. pause() holds new requests and waits for those in flight;
    resume() lets them go on; stop() ends the process. Every answer is
    recorded as (time.monotonic() when done, kind, seconds); any answer
    that is not 200 JSON is an error."""

    def __init__(self, base: str, jobs: list[tuple[str, str]], clients: int) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self._go, self._stop = ctx.Event(), ctx.Event()
        self._busy, self._n_errors = ctx.Value("i", 0), ctx.Value("i", 0)
        self._out, child = ctx.Pipe(duplex=False)
        self._go.set()
        self._proc = ctx.Process(target=_load_clients, args=(
            base, jobs, clients, self._go, self._stop, self._busy, self._n_errors, child))
        self._proc.start()
        self.records: list[tuple[float, str, float]] = []
        self.errors: list[str] = []

    @property
    def n_errors(self) -> int:
        return self._n_errors.value

    def pause(self) -> None:
        self._go.clear()
        while True:
            with self._busy.get_lock():
                if self._busy.value == 0:
                    return
            time.sleep(0.005)

    def resume(self) -> None:
        self._go.set()

    def stop(self) -> None:
        """End the load; collects its records and errors."""
        if self._proc.is_alive():
            self._stop.set()
            self._go.set()
            if self._out.poll(600):
                self.records, self.errors = self._out.recv()
            self._proc.join(60)
        if self._proc.is_alive():
            self._proc.kill()
            self._proc.join()

    def stats(self, t0: float, t1: float) -> dict:
        """Query answers done in [t0, t1] (time.monotonic()): count, req/s,
        p50/p99 ms."""
        lat = sorted(s for t, k, s in self.records if t0 <= t <= t1 and k != "wordlist")
        if not lat:
            return {"requests": 0, "req_per_s": 0.0, "p50_ms": None, "p99_ms": None}
        return {"requests": len(lat), "req_per_s": len(lat) / (t1 - t0),
                "p50_ms": 1e3 * lat[len(lat) // 2], "p99_ms": 1e3 * lat[int(len(lat) * 0.99)]}


def refresh_phase(snap, queries: list[str], kw_only: list[str], smi: str,
                  phase_launches: dict) -> dict:
    """Phase 14 (see the module docstring). -> its report."""
    import gc

    import torch

    from spaghettisearch_tpu_torch.bench import corpus_root
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
    from spaghettisearch_tpu_torch.serve.server import SearchServer
    from spaghettisearch_tpu_torch.store.tables import Database

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "smoke_refresh")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(corpus_root(PAGES), "store"), root)
    eng = QueryEngine(Database(root), snapshot=snap, device="cuda")
    index_bytes = eng.index.device_bytes()
    eng.warmup()
    eng.prewarm_hydration()
    eng.prewarm_wordlist()
    server = SearchServer(eng, batching=True)
    host, port = server.start_background(port=0)
    base = f"http://{host}:{port}"
    say(f"# refresh: store copied, engine up and warm in {time.perf_counter() - t_phase:.1f}s; "
        f"index {index_bytes} device bytes")
    load = Load(base, [("post", q) for q in queries] + [("get", q) for q in kw_only], CLIENTS)
    report: dict = {"index_bytes": index_bytes, "cycles": []}
    windows = {}  # time.monotonic() spans of the load's report
    try:
        time.sleep(2.0)  # the load's process starts
        t_s = time.monotonic()
        time.sleep(5.0)  # the load alone: its steady state before any refresh
        load.pause()
        windows["steady"] = (t_s, time.monotonic())
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        load.resume()
        ref_q = queries + kw_only
        for k in range(REFRESH_CYCLES):
            marker = REFRESH_MARKERS[k]
            site = f"http://refresh{k}.local"
            t_a = time.perf_counter()
            code = REFRESH_SNIPPET.format(here=HERE, root=root, seed=k, n=REFRESH_PAGES,
                                          base=site, marker=marker)
            out = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True,
                                 text=True, timeout=600)
            if out.returncode != 0:
                raise RuntimeError(f"refresh: the append failed: {out.stderr[-2000:]}")
            append_s = time.perf_counter() - t_a
            t0 = time.monotonic()
            _, r = fetch(base, "refresh", "", timeout=900)
            windows[k] = (t0, time.monotonic())
            if not r.get("ok"):
                raise RuntimeError(f"refresh: /refresh answered {r}")
            reset_launches()
            time.sleep(2.0)  # the load on the new live state
            load.pause()
            want_docs = PAGES + REFRESH_PAGES * (k + 1)
            _, health = fetch(base, "healthz", "")
            if health.get("docs") != want_docs or r["docs"] != want_docs:
                raise RuntimeError(f"refresh {k + 1}: /healthz {health}, /refresh {r}; want "
                                   f"{want_docs} docs")
            _, hits = fetch(base, "post", marker)
            want_urls = {f"{site}/page{i}" for i in range(REFRESH_PAGES)}
            if {h["Url"] for h in hits} != want_urls or len(hits) != REFRESH_PAGES:
                raise RuntimeError(f"refresh {k + 1}: {marker!r} found {[h['Url'] for h in hits]}")
            results, _ = send_jobs(base, [("post", q) for q in queries], CLIENTS)
            results.update(send_jobs(base, [("get", q) for q in kw_only], 1)[0])
            after = launches()
            if min(after["membership"], after["mixed"]) == 0:
                raise RuntimeError(f"refresh {k + 1}: K1/K2 launches after the swap {after}")
            got = [results[("post", q)][1] for q in queries] + [results[("get", q)][1] for q in kw_only]
            with plain_kernels():
                ref = eng.query_batch(ref_q)
            n_hits = check_ranked(ref_q, got, ref, f"refresh {k + 1}")
            if load.n_errors:
                raise RuntimeError(f"refresh {k + 1}: the load saw {load.n_errors} errors")
            report["cycles"].append({"append_s": append_s, "seconds": r["seconds"],
                                     "lock_seconds": r["lock_seconds"], "docs": r["docs"]})
            phase_launches[f"refresh{k + 1}"] = after
            say(f"# refresh {k + 1}: {REFRESH_PAGES} pages appended in {append_s:.1f}s; /refresh "
                f"{r['seconds']} s (lock {r['lock_seconds']} s), docs {r['docs']}; {marker!r} "
                f"finds its {REFRESH_PAGES} pages; {len(ref_q)} queries equal the plain path "
                f"({n_hits} results); launches after the swap {after} ({smi})")
            if k == REFRESH_CYCLES - 1:
                # the server still up, the load paused, its batches since the
                # swap drained: what the serving stack itself keeps alive
                gc.collect()
                torch.cuda.synchronize()
                mem_live = torch.cuda.memory_allocated()
            load.resume()
        time.sleep(2.0)
    finally:
        load.stop()
        server.shutdown()
    if load.errors or load.n_errors:
        raise RuntimeError(f"refresh: the load saw {load.n_errors} errors: {load.errors[:5]}")
    report["steady"] = load.stats(*windows["steady"])
    for k, cyc in enumerate(report["cycles"]):
        cyc["load_during"] = load.stats(*windows[k])
        say(f"# refresh {k + 1}: the load during it {json.dumps(cyc['load_during'])}")
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    report.update(mem_before=mem_before, mem_live=mem_live, mem_after=mem_after,
                  peak=torch.cuda.max_memory_allocated(), requests=len(load.records))
    say(f"# refresh: device memory allocated {mem_before} before the first refresh, {mem_live} "
        f"after the last with the server up and the load paused, {mem_after} after the "
        f"server's shutdown (bound {mem_before + index_bytes // 2}: half the index), peak "
        f"{report['peak']}; the load's steady state before {json.dumps(report['steady'])}; "
        f"{len(load.records)} answers, no error; {time.perf_counter() - t_phase:.1f}s ({smi})")
    for what, mem in (("with the server up", mem_live), ("after the shutdown", mem_after)):
        if mem >= mem_before + index_bytes / 2:
            raise RuntimeError(f"refresh: {mem - mem_before} more device bytes after "
                               f"{REFRESH_CYCLES} refreshes, {what}: an old index is still alive")
    eng.db.close()
    return report


#: phase 15: the soaks' durations, the sharded soak's store size and the
#: time limit of each soak's wait
SOAK_SECONDS = 60
SOAK_SHARDED_SECONDS = 90
SOAK_SHARDED_DOCS = 524_288  # the JAX soak's size: 2^19, where segregation switches on
SOAK_TIMEOUT_S = 900


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Soak:
    """One soak (`cli.{name}`) in a process of its own, on a free port, its
    store under build/ and its output in build/{name}.log; a process group
    of its own, so that kill() ends its server and append processes too.
    finish() waits for it, prints its refresh lines and its last line, and
    holds it to its bounds."""

    def __init__(self, name: str, args: list[str]) -> None:
        self.name = name
        self.log = os.path.join(HERE, "build", f"{name}.log")
        cmd = [sys.executable, "-m", f"spaghettisearch_tpu_torch.cli.{name}", *args,
               "--root", os.path.join(HERE, "build", f"{name}_db"), "--port", str(free_port())]
        with open(self.log, "wb") as out:
            self.proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=subprocess.STDOUT,
                                         start_new_session=True)

    def kill(self) -> None:
        import signal

        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def finish(self, want_refreshes: int, smi: str, note: str = "") -> dict:
        try:
            self.proc.wait(timeout=SOAK_TIMEOUT_S)
        finally:
            self.kill()
        with open(self.log, errors="replace") as f:
            lines = f.read().splitlines()
        for line in lines:
            if line.startswith(("wrote ", "load starts", "refresh #")):
                say(f"# {self.name}: {line}")
        rep = next((json.loads(line) for line in reversed(lines)
                    if line.startswith('{"counts"')), None)
        if self.proc.returncode != 0 or rep is None:
            raise RuntimeError(f"{self.name} failed ({self.proc.returncode}): "
                               f"{chr(10).join(lines[-40:])}")
        c = rep["counts"]
        if rep["n_errors"] or c["refreshes"] < want_refreshes or c["queries"] == 0:
            raise RuntimeError(f"{self.name}: {rep}")
        if "p50_s" in rep and (rep["p50_s"] is None or rep["p99_s"] is None):
            raise RuntimeError(f"{self.name}: no latency: {rep}")
        say(f"# {self.name}: {json.dumps(rep)}{note} ({smi})")
        return rep


#: phase 16: the port's bench modes (spaghettisearch_tpu_torch/bench.py),
#: each in a process of its own on the card, on the corpus phase 3 built;
#: the oracle parity's sizes and the bound on each mode's seconds
BENCH_PARITY_QUERIES = 256  # bench.py parity1m's query count
BENCH_SPARSE_QUERIES = 16
#: parity_rare's families in three processes at once (the oracle's host
#: time is the phase's longest)
BENCH_RARE_SPLIT = (("kw_catchall", "phrase_long"), ("widefold", "csr_lane", "topic_fixed"),
                    ("big_batch",))
BENCH_TIMEOUT_S = 900
SCALE_SNIPPET = """
import json, chip_smoke
print(json.dumps(chip_smoke.scale_child()))
"""
#: phase 19: pages of the build hold (both builds of one seed), and phase
#: 20's gates, set below the 100k corpus's D_pad (100,352) and doc count
HOLD_PAGES = 20_000
GATES_DPAD = 100_000
GATES_SEGREGATE_DOCS = 100_000
#: the children started in phase 16's window: mode -> the code `python -c` runs
#: (its argument: the seed)
CHILD_SNIPPETS = {
    "scale1m": SCALE_SNIPPET,
    "build_hold": """
import json, sys, chip_smoke
print(json.dumps(chip_smoke.build_hold_child(int(sys.argv[1]))))
""",
    "gates": """
import json, sys, chip_smoke
print(json.dumps(chip_smoke.gates_child(int(sys.argv[1]))))
""",
}


def scale_child() -> dict:
    """Phase 16's scale1m in a process of its own: bench_scale on the card,
    and the first batch's top-10 against the same batch on the plain path
    (the timed sweep's result, so the check launches no kernel)."""
    import torch

    from spaghettisearch_tpu_torch import bench

    def check(run, batch, out):
        with plain_kernels():
            want = run(batch)
        return {"top10_equal_plain": same_topk(*out, *want, rtol=1e-6, atol=0.0),
                "ranked": int(torch.isfinite(out[0]).sum())}

    return bench.run_mode(lambda: bench.bench_scale(device="cuda", check=check), True, "cuda")


def _store_digests(db) -> dict:
    """Per table, an order-free digest of its stored rows (sha256 over the
    rows sorted by key: each key and its stored value, byte for byte)."""
    import hashlib

    out = {}
    for name, table in db.tables.items():
        h = hashlib.sha256()
        for k, v in sorted(table._kv.items()):
            h.update(k.encode() + b"\0" + v.encode() + b"\n")
        out[name] = h.hexdigest()
    return out


def _snapshot_differs(a, b) -> list[str]:
    """The fields in which two snapshots differ (np.array_equal, dtypes
    included; no tolerance)."""
    import numpy as np

    out = [f for f in ("doc_hashes", "word_hashes", "doc_id", "word_id", "categories")
           if getattr(a, f) != getattr(b, f)]
    for sec in ("title", "body"):
        x, y = a.section(sec), b.section(sec)
        out += [f"{sec}.{f}" for f in ("post_offsets", "doc_ids", "weights", "pos_offsets",
                                       "positions")
                if getattr(x, f).dtype != getattr(y, f).dtype
                or not np.array_equal(getattr(x, f), getattr(y, f))]
        out += [f"{sec}.{f}" for f in ("n_postings", "max_df", "max_positions")
                if getattr(x, f) != getattr(y, f)]
    for f in ("mag_title", "mag_body", "pagerank"):
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None) or x is not None and (
                x.dtype != y.dtype or not np.array_equal(x, y)):
            out.append(f)
    return out


def build_hold_child(seed: int, device: str = "cuda") -> dict:
    """Phase 19 in a process of its own: the benchmark corpus of HOLD_PAGES
    pages built in several processes (the cores this process may use) and
    in one, PageRank on the card in both (the parallel build first: its
    workers fork before this process touches CUDA). Every table's digest
    equal, but doc_magnitude and doc_rank, whose sums follow the store's
    row order (PERF.md: two one-process builds differ there too), within
    1e-12 and 1e-6 relative; the docs pack's files equal byte for byte;
    the snapshots' arrays equal (magnitudes and ranks at the same bars).
    The parallel build's own snapshot, assembled from its key buckets,
    equal in every field (np.array_equal) to build_snapshot of its store,
    and its uncompressed save read back through load_snapshot equal to it.
    Each build's seconds per step are printed."""
    import numpy as np

    from spaghettisearch_tpu_torch.corpus import write_corpus, write_corpus_with_snapshot
    from spaghettisearch_tpu_torch.index.parallel_build import save_snapshot_uncompressed
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
    from spaghettisearch_tpu_torch.store.tables import TABLE_SPECS

    root = os.path.join(HERE, "build", "build_hold")
    shutil.rmtree(root, ignore_errors=True)
    out: dict = {"pages": HOLD_PAGES, "workers": len(os.sched_getaffinity(0))}
    dbs = {}
    for what, workers in (("parallel", None), ("one_process", 1)):
        t0 = time.perf_counter()
        kw = dict(n_pages=HOLD_PAGES, seed=seed, device=device, workers=workers,
                  log=lambda m, w=what: print(f"# build hold {w}: {m}", flush=True))
        if what == "parallel":
            dbs[what], bucket_snap, _ = write_corpus_with_snapshot(
                os.path.join(root, what, "store"), **kw)
        else:
            dbs[what] = write_corpus(os.path.join(root, what, "store"), **kw)
        out[f"{what}_s"] = round(time.perf_counter() - t0, 1)
    got, want = dbs["parallel"], dbs["one_process"]
    dg, dw = _store_digests(got), _store_digests(want)
    bars = {"doc_magnitude": 1e-12, "doc_rank": 1e-6}
    worst = {}
    for spec in TABLE_SPECS:
        if spec.name not in bars:
            if dg[spec.name] != dw[spec.name]:
                raise RuntimeError(f"build hold: table {spec.name} differs")
            continue
        a, b = dict(got.tables[spec.name].items()), dict(want.tables[spec.name].items())
        if a.keys() != b.keys():
            raise RuntimeError(f"build hold: {spec.name} keys differ")
        err = 0.0
        for k, row in b.items():
            if list(a[k]) != list(row):
                raise RuntimeError(f"build hold: {spec.name}[{k}] fields differ")
            for c, v in row.items():
                err = max(err, abs(a[k][c] - v) / abs(v) if v else abs(a[k][c]))
        if err > bars[spec.name]:
            raise RuntimeError(f"build hold: {spec.name} off by {err} > {bars[spec.name]}")
        worst[spec.name] = err
    for fn in ("docs.pack", "docs.pki"):
        with open(os.path.join(got.root, fn), "rb") as fa, open(os.path.join(want.root, fn),
                                                                "rb") as fb:
            if fa.read() != fb.read():
                raise RuntimeError(f"build hold: {fn} differs")
    sg, sw = build_snapshot(got), build_snapshot(want)
    if sg.doc_hashes != sw.doc_hashes or sg.word_hashes != sw.word_hashes:
        raise RuntimeError("build hold: the snapshots' census differs")
    for sec in ("title", "body"):
        for f in ("post_offsets", "doc_ids", "weights", "pos_offsets", "positions"):
            if not np.array_equal(getattr(sg.section(sec), f), getattr(sw.section(sec), f)):
                raise RuntimeError(f"build hold: snapshot {sec}.{f} differs")
    for f, rtol in (("mag_title", 1e-12), ("mag_body", 1e-12), ("pagerank", 1e-6)):
        if not np.allclose(getattr(sg, f), getattr(sw, f), rtol=rtol, atol=0):
            raise RuntimeError(f"build hold: snapshot {f} off by more than {rtol}")
    differ = _snapshot_differs(bucket_snap, sg)
    if differ:
        raise RuntimeError(f"build hold: the buckets' snapshot differs from build_snapshot in "
                           f"{differ}")
    t0 = time.perf_counter()
    save_snapshot_uncompressed(bucket_snap, os.path.join(root, "snapshot"))
    out["save_s"] = round(time.perf_counter() - t0, 3)
    differ = _snapshot_differs(load_snapshot(os.path.join(root, "snapshot")), bucket_snap)
    if differ:
        raise RuntimeError(f"build hold: the uncompressed save reads back different {differ}")
    out.update(bucket_snapshot_equal=True, uncompressed_save_equal=True)
    got.close()
    want.close()
    shutil.rmtree(root, ignore_errors=True)
    out.update(tables_equal=len(TABLE_SPECS) - len(bars), worst_rel=worst,
               docs=sg.n_docs, postings=sg.body.n_postings + sg.title.n_postings)
    return out


def gates_child(seed: int, device: str = "cuda") -> dict:
    """Phase 20 in a process of its own: the 2M tier's path on phase 3's
    100k corpus. The 2M corpus does not fit the smoke's time limit, so the
    gates come down to the corpus instead (a cut of scale): HOT_MAX_DPAD
    and FWD_DEV_MAX_DPAD to GATES_DPAD (below its D_pad), SEGREGATE_MIN_DOCS
    to GATES_SEGREGATE_DOCS (at most its doc count). The index then has no
    hot-term cache and keeps ft/fw/fj on the host; a SearchServer
    (batching on, segregate="auto") segregates phrase-class batches, and
    its answers to the serving phase's mix are 200 JSON equal to the
    default-gate engine's plain path (ties aside), K1 and K2 launched;
    phrases under a custom blend take the sparse lane, whose first call
    uploads ft/fw/fj once (a second call uploads nothing), its top-50
    equal to the plain path."""
    import numpy as np
    import torch

    from spaghettisearch_tpu_torch.bench import corpus_root, load_bench_corpus
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.models.blended import BlendedRanker
    from spaghettisearch_tpu_torch.retrieval import device_index
    from spaghettisearch_tpu_torch.retrieval import engine as eng_mod
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.serve.server import SearchServer

    db, snap = load_bench_corpus(corpus_root(PAGES))
    saved = device_index.HOT_MAX_DPAD, device_index.FWD_DEV_MAX_DPAD, eng_mod.SEGREGATE_MIN_DOCS
    device_index.HOT_MAX_DPAD = device_index.FWD_DEV_MAX_DPAD = GATES_DPAD
    eng_mod.SEGREGATE_MIN_DOCS = GATES_SEGREGATE_DOCS
    eng = QueryEngine(db, snapshot=snap, device=device)
    idx = eng.index

    def on_host(sec) -> bool:
        return all(isinstance(getattr(sec.fwd, n), np.ndarray) for n in ("ft", "fw", "fj"))

    if not (idx.n_docs_padded > GATES_DPAD and idx.n_docs >= GATES_SEGREGATE_DOCS):
        raise RuntimeError(f"gates: the corpus does not cross the gates ({idx.n_docs_padded})")
    if idx.hot_body_w is not None or not (on_host(idx.title) and on_host(idx.body)):
        raise RuntimeError("gates: a hot-term cache, or ft/fw/fj on the device")
    if not eng.model.supports_mixed(idx) or not eng.class_batching_pays():
        raise RuntimeError("gates: no fused lane, or the engine declines segregation")
    t0 = time.perf_counter()
    eng.warmup()
    eng.prewarm_hydration()
    eng.prewarm_wordlist()
    warm_s = time.perf_counter() - t0
    queries = bench_queries(snap, QUERIES, seed=seed + 1, phrase_every=4, db=db)
    kw_only = [q for q in queries if '"' not in q][:32]
    classes = []
    rank_async = eng.rank_async

    def recording(parsed, *a, **k):
        classes.append(sorted({bool(p.phrase_hashes) for p in parsed}))
        return rank_async(parsed, *a, **k)

    eng.rank_async = recording
    reset_launches()
    server = SearchServer(eng, batching=True, segregate="auto")
    host, port = server.start_background(port=0)
    try:
        active = server.batcher._segregate_now()
        results, wall = send_jobs(f"http://{host}:{port}", [("post", q) for q in queries]
                                  + [("get", q) for q in kw_only], CLIENTS)
        st = server.batcher.stats
        batches, ph_batches = st.batches, st.ph_batches
    finally:
        server.shutdown()
        eng.rank_async = rank_async
    served = launches()
    if not active or min(served["membership"], served["mixed"]) == 0:
        raise RuntimeError(f"gates: segregation {active}, launches {served}")
    if not (on_host(idx.title) and on_host(idx.body)):
        raise RuntimeError("gates: the fused and keyword lanes uploaded ft/fw/fj")
    device_index.HOT_MAX_DPAD, device_index.FWD_DEV_MAX_DPAD, eng_mod.SEGREGATE_MIN_DOCS = saved
    ref_eng = QueryEngine(db, snapshot=snap, device=device)
    if ref_eng.index.hot_body_w is None:
        raise RuntimeError("gates: the default-gate engine has no hot-term cache")
    ref_q = queries + kw_only
    with plain_kernels():
        ref = ref_eng.query_batch(ref_q)
    got = [results[("post", q)][1] for q in queries] + [results[("get", q)][1] for q in kw_only]
    n_hits = check_ranked(ref_q, got, ref, "past the gates")
    del ref_eng
    # the sparse lane: phrases under a custom blend read ft/fj on the device
    phrases = [parse_query(q) for q in queries if '"' in q][:16]
    live = (snap, idx, BlendedRanker(w_title=0.5))
    puts = []
    put = device_index._put
    device_index._put = lambda a, dev: puts.append(tuple(a.shape)) or put(a, dev)
    try:
        with count_matcher_calls() as matcher:
            s1, i1 = eng.rank(phrases, live=live)
            n_first = len(puts)
            s2, i2 = eng.rank(phrases, live=live)
    finally:
        device_index._put = put
    if n_first != 6 or len(puts) != 6 or matcher[0] < 2 or on_host(idx.body):
        raise RuntimeError(f"gates: uploads {puts}, matcher calls {matcher[0]}")
    with plain_kernels():
        ws, wi = eng.rank(phrases, live=live)
    to = lambda x: torch.as_tensor(np.asarray(x))  # noqa: E731
    if not (same_topk(to(s1), to(i1), to(ws), to(wi), rtol=1e-6, atol=1e-6)
            and same_topk(to(s2), to(i2), to(ws), to(wi), rtol=1e-6, atol=1e-6)):
        raise RuntimeError("gates: the sparse lane's top-50 differs from the plain path")
    db.close()
    return {"d_pad": idx.n_docs_padded, "segregation": "active" if active else "inactive",
            "batches": batches, "ph_batches": ph_batches,
            "mixed_class_batches": sum(1 for c in classes if len(c) > 1),
            "answers": len(results), "results": n_hits, "warm_s": round(warm_s, 1),
            "req_per_s": round(len(results) / wall, 1), "launches": served,
            "fwd_uploads": n_first, "sparse_matcher_calls": matcher[0],
            "index_device_bytes": idx.device_bytes()}


def bench_phase(smi: str, phase_launches: dict, seed: int, beside) -> dict:
    """Phase 16 (see the module docstring); each of `beside` is called in
    this process while the answer-gated modes run. -> each job's result."""
    def start(name: str, mode: str, *flags: str):
        """Start a mode; its output goes to build/bench_{name}.out and .err
        (files, so that no pipe fills while another mode is awaited)."""
        cmd = ([sys.executable, "-c", CHILD_SNIPPETS[mode], str(seed)] if mode in CHILD_SNIPPETS
               else [sys.executable, "-m", "spaghettisearch_tpu_torch.bench", "--mode", mode,
                     "--seed", str(seed), *flags])
        log = os.path.join(HERE, "build", f"bench_{name}")
        with open(log + ".out", "wb") as out, open(log + ".err", "wb") as err:
            proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=err,
                                    start_new_session=True)
        return name, flags, time.perf_counter(), proc, log

    def kill(job) -> None:
        """End a mode's process group (serve's server with it)."""
        import signal

        with contextlib.suppress(ProcessLookupError):
            os.killpg(job[3].pid, signal.SIGKILL)
        job[3].wait()

    def finish(job) -> dict:
        name, flags, t0, proc, log = job
        try:
            proc.wait(timeout=BENCH_TIMEOUT_S)
        finally:
            kill(job)
        with open(log + ".out", errors="replace") as f:
            out = f.read()
        if proc.returncode != 0:
            with open(log + ".err", errors="replace") as f:
                err = f.read()
            raise RuntimeError(f"bench {name} {' '.join(flags)} exited {proc.returncode}:\n"
                               f"{err[-4000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        say(f"# bench {name} {' '.join(flags)}: {json.dumps(res)} "
            f"(ended by {time.perf_counter() - t0:.1f}s)")
        if "launches" in res:
            phase_launches[f"bench_{name}"] = res["launches"]
        return res

    def tie_explained(what: str, r: dict) -> None:
        if r["order_divergences_at_50"] != r["divergences_tie_explained"]:
            raise RuntimeError(f"{what}: a top-50 divergence from the oracle is not a tie: {r}")

    # the oracle modes and scale1m at once: their gates are answers, and the
    # oracle is host Python on cores of its own, so the card is mostly idle
    # and this process's own checks run meanwhile; serve, the one timed
    # gate, runs alone after them
    pages = ("--pages", str(PAGES))
    jobs = [start("parity", "parity", *pages, "--queries", str(BENCH_PARITY_QUERIES)),
            *(start(f"parity_rare_{k}", "parity_rare", *pages, "--families", ",".join(fams))
              for k, fams in enumerate(BENCH_RARE_SPLIT)),
            start("sparse2m", "sparse2m", *pages, "--queries", str(BENCH_SPARSE_QUERIES)),
            start("scale1m", "scale1m"), start("build_hold", "build_hold"),
            start("gates", "gates")]
    try:
        t0 = time.perf_counter()
        for fn in beside:
            fn()
        say(f"# phase 16: this process's checks took {time.perf_counter() - t0:.1f}s beside "
            "the bench modes")
        reps = {job[0]: finish(job) for job in jobs}
    finally:
        for job in jobs:
            kill(job)
    # the parity mode's 64-query batches each hold a phrase, so it ranks on
    # the fused lane (K2) only
    r = reps["parity"]
    tie_explained("parity", r)
    if r["value"] != 1.0 or r["score_max_rel_err"] > 1e-6 or r["launches"]["K2"] == 0:
        raise RuntimeError(f"parity: {r}")
    fams = {name: fam for k in range(len(BENCH_RARE_SPLIT))
            for name, fam in reps[f"parity_rare_{k}"]["families"].items()}
    if sorted(fams) != sorted(f for split in BENCH_RARE_SPLIT for f in split):
        raise RuntimeError(f"parity_rare: families {sorted(fams)} ran")
    for name, fam in fams.items():
        tie_explained(f"parity_rare {name}", fam)
        if fam["recall_at_10"] != 1.0 or fam["score_max_rel_err"] > 1e-6:
            raise RuntimeError(f"parity_rare {name}: {fam}")
    if fams["kw_catchall"]["launches"]["K1"] == 0 or fams["big_batch"]["launches"]["K2"] == 0:
        raise RuntimeError(f"parity_rare: K1 (kw_catchall) or K2 (big_batch) never launched: "
                           f"{fams}")
    r = reps["sparse2m"]
    tie_explained("sparse2m", r)
    if r["pos_dense"] or r["matcher_calls"] == 0:
        raise RuntimeError(f"sparse2m: {r}")
    r = reps["scale1m"]
    if not r["check"]["top10_equal_plain"] or r["launches"]["K1"] == 0:
        raise RuntimeError(f"scale1m: {r}")
    say(f"# scale1m: index {r['index_device_bytes']} device bytes, max_memory_allocated "
        f"{r['max_memory_allocated']} B, top-10 of a B=256 batch equal to the plain path ({smi})")
    r = reps["build_hold"]
    say(f"# phase 19, build hold: {HOLD_PAGES} pages, {r['workers']} workers "
        f"{r['parallel_s']} s, one process {r['one_process_s']} s; {r['tables_equal']} tables' "
        f"digests, the docs pack and the snapshot equal; worst relative {r['worst_rel']}; the "
        f"buckets' snapshot equal to build_snapshot {r['bucket_snapshot_equal']}, its "
        f"uncompressed save ({r['save_s']} s) read back equal {r['uncompressed_save_equal']} "
        f"({smi})")
    r = reps["gates"]
    say(f"# phase 20, past the gates at 100k: {json.dumps(r)} ({smi})")
    r = reps["serve"] = finish(start("serve", "serve", *pages, "--routeMix"))
    if (r["non_200"] or r["protocol_errors"] or not r["contract"] or not r["routes"]
            or set(r["routes"]) != {"wordlist", "get_query", "post_query"}):
        raise RuntimeError(f"serve --routeMix: {r}")
    say(f"# serve --routeMix: {r['value']} req/s, p50 {r['p50_ms']} ms, p99 {r['p99_ms']} ms, "
        f"routes {json.dumps(r['routes'])}, mean_batch {r['mean_batch']}, spans_ms "
        f"{json.dumps(r['spans_ms'])} ({smi})")
    return reps


#: the sparse probe's synthetic docs in phase 17, cut from its original's
#: 1M so that its host build stays small beside phase 16's modes (the 1M
#: run is the probe alone)
SPARSE_DOCS = 250_000
#: phase 17: the probes of experiments/ ported to the card, each in a
#: process of its own beside phase 16's oracle modes, at their originals'
#: sizes, except phrase_delta (its original's crawl-built 1M corpus takes
#: ~14.5 minutes to build, so it runs on phase 3's 100k corpus) and sparse
#: (SPARSE_DOCS)
PROBES = (("fused2", "torch_fused2_probe.py", ()),
          ("phrase_delta", "torch_phrase_delta_probe.py", (str(PAGES),)),
          ("tbound", "torch_tbound_probe.py", ()),
          ("membership_tune", "torch_membership_tune.py", ()),
          ("sparse", "torch_sparse_probe.py", ("--docs", str(SPARSE_DOCS))),
          ("roofline", "torch_roofline.py", ("--skip-1m", "--pages", str(PAGES), "--reps", "1")),
          ("bw", "torch_bw_probe.py", ("--reps", "1")),
          ("scorer_split", "torch_scorer_split_probe.py",
           ("--pages", str(PAGES), "--reps", "1")),
          ("headline_chain", "torch_headline_chain_probe.py",
           ("--pages", str(PAGES), "--reps", "1")))
#: the probes whose command names phase 3's corpus take its seed too
PROBES_ON_CORPUS = ("phrase_delta", "roofline", "scorer_split", "headline_chain")
PROBE_TIMEOUT_S = 600
#: phase 17: the corpus probes run in this process on phase 3's corpus and
#: engine (each module's run(); the engine is warm by then), and topk on a
#: seeded matrix; the six whose originals default to the crawl-built 1M
#: corpus run at 100k, as torch_phrase_delta_probe does
PROBES_IN_PROCESS = (("topk_probe", {}), ("probe1m_decomp", {}), ("headline_tbound_probe", {}),
                     ("mixed_tbound_probe", {}), ("phrase_tmax_probe", {}), ("post16_probe", {}),
                     ("mixed_stage_probe", {"warm": False}), ("phrase_stage_probe", {}),
                     ("mixed256_probe", {}), ("split_probe", {}),
                     ("probe1m", {"warm": False}), ("segregate_probe", {"warm": False}),
                     ("shard_scale_probe", {}), ("h2d_probe", {}), ("fetch_async_probe", {}),
                     ("kw_gap_probe", {}))
#: K2's bounded stage whose time the kernels line's mixed_tmax entry holds
#: (each stage's is printed): "both" bounds every body loop
TMAX_LINE_STAGE = "both"
#: K6's phrase-row budget in the split program (phrase_delta_probe.py bp)
BP_DELTA = 16


class Probes:
    """Phase 17's probe scripts: started together, each its own process
    (its main() prints its lines and, last, its JSON; it exits 1 when its
    exactness check fails), output in build/probe_{name}.out and .err."""

    def __init__(self, seed: int) -> None:
        self.jobs = []
        for name, script, argv in PROBES:
            log = os.path.join(HERE, "build", f"probe_{name}")
            cmd = [sys.executable, os.path.join(HERE, "experiments", script), *argv]
            if name in PROBES_ON_CORPUS:
                cmd += ["--seed", str(seed)]
            with open(log + ".out", "wb") as out, open(log + ".err", "wb") as err:
                proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=err,
                                        start_new_session=True)
            self.jobs.append((name, proc, log, time.perf_counter()))

    def kill(self) -> None:
        import signal

        for _, proc, _, _ in self.jobs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()

    def finish(self, smi: str) -> dict:
        """Wait for every probe; raise unless each exited 0 with its check
        held. -> {name: its JSON}."""
        out = {}
        try:
            for name, proc, log, t0 in self.jobs:
                proc.wait(timeout=PROBE_TIMEOUT_S)
                with open(log + ".out", errors="replace") as f:
                    lines = f.read().strip().splitlines()
                if proc.returncode != 0 or not lines:
                    with open(log + ".err", errors="replace") as f:
                        err = f.read()
                    raise RuntimeError(f"probe {name} exited {proc.returncode}:\n"
                                       f"{chr(10).join(lines[-20:])}\n{err[-4000:]}")
                res = json.loads(lines[-1])
                for line in lines[:-1]:
                    say(f"# probe {name}: {line}")
                say(f"# probe {name} (ended by {time.perf_counter() - t0:.1f}s, {smi}): "
                    f"{json.dumps(res)}")
                if not res["ok"]:
                    raise RuntimeError(f"probe {name}: its exactness check failed: {res}")
                out[name] = res
        finally:
            self.kill()
        return out


#: phase 18: the crash soak's queries to its restarted server, and the time
#: limit of each of its waits
CRASH_QUERIES = 64
CRASH_TIMEOUT_S = 900


class Crash:
    """Phase 18's crash soak (experiments/torch_crash_recovery.py --phase
    all --checkQueries CRASH_QUERIES) in a process of its own, its output
    in build/crash.out and .err."""

    def __init__(self, seed: int) -> None:
        self.log = os.path.join(HERE, "build", "crash")
        self.work = os.path.join(HERE, "build", "crash", f"corpus{PAGES // 1000}k")
        cmd = [sys.executable, os.path.join(HERE, "experiments", "torch_crash_recovery.py"),
               "--phase", "all", "--pages", str(PAGES), "--seed", str(seed), "--device", "cuda",
               "--work", self.work, "--checkQueries", str(CRASH_QUERIES)]
        with open(self.log + ".out", "wb") as out, open(self.log + ".err", "wb") as err:
            self.proc = subprocess.Popen(cmd, cwd=HERE, stdout=out, stderr=err,
                                         start_new_session=True)
        self.t0 = time.perf_counter()

    def kill(self) -> None:
        import signal

        with contextlib.suppress(ProcessLookupError):
            os.killpg(self.proc.pid, signal.SIGKILL)
        self.proc.wait()

    def _lines(self) -> list[str]:
        with open(self.log + ".out", errors="replace") as f:
            return f.read().splitlines()

    def _failed(self) -> RuntimeError:
        with open(self.log + ".err", errors="replace") as f:
            err = f.read()
        return RuntimeError(f"the crash soak exited {self.proc.returncode}:\n"
                            f"{chr(10).join(self._lines()[-20:])}\n{err[-4000:]}")

    def finish(self, smi: str) -> list[dict]:
        """Wait for the soak. -> its phases."""
        try:
            self.proc.wait(timeout=CRASH_TIMEOUT_S)
        finally:
            self.kill()
        if self.proc.returncode != 0:
            raise self._failed()
        lines = self._lines()
        for line in lines[:-1]:
            say(f"# crash: {line}")
        say(f"# crash soak ended by {time.perf_counter() - self.t0:.1f}s ({smi})")
        return json.loads(lines[-1])["crash_recovery"]


def crash_phase(crash: Crash, smi: str, phase_launches: dict) -> None:
    """Phase 18 (see the module docstring): the soak's own holds
    (torch_crash_recovery.holds), its restart check among them."""
    probe_util()  # puts experiments/ on the path
    import torch_crash_recovery

    t0 = time.perf_counter()
    a, b = crash.finish(smi)
    failed = [what for ok, what in torch_crash_recovery.holds([a, b]) if not ok]
    if failed:
        raise RuntimeError(f"crash soak: {failed}: phase A {a}; phase B {b}")
    c = b["restart_check"]
    phase_launches["crash_restart"] = {"membership": c["launches"]["K1"],
                                       "mixed": c["launches"]["K2"]}
    say(f"# crash: {c['queries']} answers of the restarted server ({c['results']} results) "
        f"equal the kernel path and the plain path on the recovered store ({c['keyword']} "
        f"keyword, {c['phrase']} phrase queries; launches {c['launches']}); phase A "
        f"{json.dumps(a)}; phase B {json.dumps(b)}; {time.perf_counter() - t0:.1f}s waited "
        f"in this process ({smi})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="corpus and query seed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    t_start = time.perf_counter()
    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"# device: {name} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)

    t_lap = [t_start]
    phase_s: dict[str, float] = {}

    def lap(what: str) -> None:
        """Record the wall seconds of the phases that just ended."""
        now = time.perf_counter()
        phase_s[what] = round(now - t_lap[0], 1)
        t_lap[0] = now

    # 2. build
    build_all()
    lap("1-2 card, build")
    # phase 15's set-up beside phase 3 (see the module docstring): cli.soak,
    # and cli.soak_sharded as far as its load
    go = os.path.join(HERE, "build", "soak_sharded.go")
    with contextlib.suppress(FileNotFoundError):
        os.remove(go)
    soak = Soak("soak", ["--seconds", str(SOAK_SECONDS)])
    sharded = Soak("soak_sharded", ["--seconds", str(SOAK_SHARDED_SECONDS), "--device", "cuda:0",
                                    "--docs", str(SOAK_SHARDED_DOCS), "--startFile", go])
    atexit.register(soak.kill)
    atexit.register(sharded.kill)

    from spaghettisearch_tpu_torch.bench import corpus_root, load_bench_corpus
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.models.blended import BlendedRanker
    from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
    from spaghettisearch_tpu_torch.ops import scoring
    from spaghettisearch_tpu_torch.ops.kernels import check, mixed, phrase_delta, probe
    from spaghettisearch_tpu_torch.retrieval import device_index
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    # 3. corpus + index
    t0 = time.perf_counter()
    root = corpus_root(PAGES)  # where the bench modes of phase 16 look for it
    shutil.rmtree(root, ignore_errors=True)
    # in a process of its own (the bench's build, as ensure_bench_corpus
    # runs it): its workers fork from a process that has not touched CUDA
    build = subprocess.run(
        [sys.executable, "-m", "spaghettisearch_tpu_torch.bench", "--device", "cuda",
         "--seed", str(args.seed), "--build-corpus", str(PAGES), "30000", root],
        cwd=HERE, capture_output=True, text=True,
    )
    for line in build.stderr.splitlines():
        if line.startswith("# corpus:"):
            say(line)
    if build.returncode != 0:
        raise RuntimeError(f"the corpus build failed ({build.returncode}):\n"
                           f"{build.stderr[-4000:]}")
    db, snap = load_bench_corpus(root)
    t_corpus = time.perf_counter() - t0
    engine = QueryEngine(db, snapshot=snap, device="cuda")
    idx = engine.index
    torch.cuda.synchronize()
    nt = (idx.body.fwd.ftT >= 0).sum(dim=0)[: idx.n_docs].float()
    say(
        f"# corpus: {snap.n_docs} docs, {snap.n_words} words, "
        f"{snap.body.n_postings} body + {snap.title.n_postings} title postings "
        f"in {t_corpus:.1f}s; index built in {time.perf_counter() - t0 - t_corpus:.1f}s"
    )
    say(
        f"# index: D_pad {idx.n_docs_padded}, body T {idx.body.fwd.ftT.shape[0]} "
        f"(distinct terms/doc mean {float(nt.mean()):.1f}, p50 {float(nt.median()):.0f}, "
        f"max {int(nt.max())}), title T {idx.title.fwd.ftT.shape[0]}, "
        f"doc_sort {idx.doc_perm is not None}, hot terms "
        f"{0 if idx.hot_body_map is None else len(idx.hot_body_map)}, posT C "
        f"{idx.title.pos_c}/{idx.body.pos_c} {str(idx.body.posT.dtype)}, "
        f"posting_cap {idx.posting_cap}, pos_cap {idx.pos_cap}, pos_mat "
        f"{idx.title.pos_mat is not None}/{idx.body.pos_mat is not None}, "
        f"zero weights {idx.has_zero_weight}, device bytes {idx.device_bytes()}"
    )

    lap("3 corpus, index")
    # cli.soak, beside phase 3
    soak.finish(2, smi, " (beside phase 3)")
    if sharded.proc.poll() is not None:
        sharded.finish(1, smi)  # raises: it ended before its load
    lap("3 the wait for cli.soak")
    # 4. kernels vs plain versions on the card
    t0 = time.perf_counter()
    df = snap.body.df(range(snap.n_words)).astype("float64")
    records = {"membership": [], "mixed": [], "membership_1sec": [], "fused": [],
               "fused_topk": [], "phrase_delta": [], "mixed_tmax": [], "finalize": []}
    main_counts = idx.has_zero_weight  # the engine's emit_counts
    doc_sort = idx.body.tmax_blocks is not None
    idx32 = dataclasses.replace(idx, **{  # the f32 planes a pathological corpus keeps
        sec: dataclasses.replace(getattr(idx, sec),
                                 posT=mixed.deq_posT(getattr(idx, sec).posT).contiguous())
        for sec in ("title", "body")
    })

    def held(kname: str, rep: dict, what: str) -> None:
        say(f"# {what}: {rep}")
        if not rep["ok"]:
            raise RuntimeError(f"{kname} kernel disagrees with its plain version: {rep}")
        records[kname].append(rep)

    def hold_tables(batch, what: str, one: str | None = None) -> None:
        for phrases in (False, True) if "ph_ids" in batch and one is None else (False,):
            if not check.tables_agree(batch, phrases, one=one):
                raise RuntimeError(f"the probe tables of {what} (phrases={phrases}, {one or 'K1/K2'}) "
                                   "differ from their plain version")
        say(f"# probe tables {what} ({one or 'K1/K2'}): equal to the plain build")

    def hold_k1(batch, what: str) -> None:
        hold_tables(batch, what)
        for emit in (True, False):
            for tmax in sorted({doc_sort, False}):
                got = check.run_k1(idx, batch, emit, body_tmax=tmax)
                want = check.run_k1(idx, batch, emit, body_tmax=tmax, plain=True)
                held("membership", check.compare(got, want),
                     f"K1 {what} counts={emit} split={batch['split']} tmax={tmax}")

    def hold_k2(index, batch, what: str, emits=(True, False)) -> None:
        hold_tables(batch, what)
        for emit in emits:
            got = check.run_k2(index, batch, emit)
            want = check.run_k2(index, batch, emit, plain=True)
            held("mixed", check.compare(got, want),
                 f"K2 {what} counts={emit} planes={index.body.posT.dtype}")

    for q in (4, 32):
        hold_k1(check.to_device(check.keyword_batch(idx, 128, q, seed=q, df=df), "cuda"),
                f"B=128 Q={q}")
    mbatch = check.to_device(
        check.mixed_batch(idx, 128, 4, 16, seed=1, df=df, snap=snap), "cuda"
    )
    mbatch16 = check.to_device(  # the serving shape: B=16, P=P_BASE
        check.mixed_batch(idx, 16, 4, 4, seed=2, df=df, snap=snap), "cuda"
    )

    def hold_k3(batch, what: str) -> None:
        hold_tables(batch, what, one="K3")
        for section in ("title", "body"):
            for emit in (True, False):
                got = check.run_k3(idx, batch, emit, section)
                want = check.run_k3(idx, batch, emit, section, plain=True)
                held("membership_1sec", check.compare_section(got, want),
                     f"K3 {section} {what} counts={emit}")

    def hold_k4(batch, what: str) -> None:
        hold_tables(batch, what, one="K4")
        for c in (1, 8):
            inputs = check.fused_inputs(idx, batch, c, seed=c)
            got = check.run_k4(idx, batch, inputs)
            want = check.run_k4(idx, batch, inputs, plain=True)
            held("fused", check.compare_final(got, want), f"K4 {what} C={c}")

    for index in (idx, idx32):
        hold_k2(index, mbatch, "B=128 Q=4 P=16")
        hold_k2(index, mbatch16, "B=16 Q=4 P=4")

    def adversarial() -> None:
        """K1-K4 on the batches that stress their probe tables (phase 16
        runs it)."""
        for kind in check.ADVERSARIAL:
            batch = check.to_device(
                check.adversarial_batch(idx, kind, seed=7, df=df, snap=snap, b=128), "cuda"
            )
            b, q = batch["term_ids"].shape
            hold_k1(batch, f"adversarial {kind} B={b} Q={q}")
            hold_k2(idx, batch, f"adversarial {kind} B={b} Q={q} P=4")
            hold_k3(batch, f"adversarial {kind} B={b} Q={q}")
            hold_k4(batch, f"adversarial {kind} B={b} Q={q}")
        # every_row and log_full at B=128 (above) and log_full at the
        # serving shape give docs more phrase hits in a section than K2's
        # log keeps: the rescan path
        full16 = check.to_device(
            check.adversarial_batch(idx, "log_full", seed=8, df=df, snap=snap, b=16), "cuda"
        )
        hold_k2(idx, full16, "adversarial log_full B=16 Q=4 P=4")

    for q in (4, 32):
        batch = check.to_device(check.keyword_batch(idx, 128, q, seed=q + 1, df=df, split=False),
                                "cuda")
        if not bool((batch["qn"][:-1] >= batch["qn"][1:]).all()):
            raise RuntimeError("K3 batch rows are not qn-sorted")
        hold_k3(batch, f"B=128 Q={q} qn-sorted")
        hold_k4(batch, f"B=128 Q={q}")
    kbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df), "cuda")
    cbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df, split=False), "cuda")
    k4_in = check.fused_inputs(idx, cbatch, 1, seed=1)
    times = {
        "membership": (
            check.time_ms(lambda: check.run_k1(idx, kbatch, main_counts, doc_sort)),
            check.time_ms(lambda: check.run_k1(idx, kbatch, main_counts, doc_sort, plain=True), iters=5),
        ),
        "mixed": (
            check.time_ms(lambda: check.run_k2(idx, mbatch, main_counts)),
            check.time_ms(lambda: check.run_k2(idx, mbatch, main_counts, plain=True), iters=3, warmup=1),
        ),
    }
    k2_b16 = (
        check.time_ms(lambda: check.run_k2(idx, mbatch16, main_counts)),
        check.time_ms(lambda: check.run_k2(idx, mbatch16, main_counts, plain=True), iters=3,
                      warmup=1),
    )
    # K2 with the doc-sorted body bound, timed here beside its static call
    # (phase 17 holds its outputs beside phase 16's modes, where a time
    # would not be K2's own); the plain version ignores the bound, so its
    # time is the static call's plain time
    if not doc_sort:
        raise RuntimeError("the 100k index is not doc-sorted: K2's bound has nothing to read")
    k2_tmax_ms = {stage: check.time_ms(
        lambda s=stage: check.run_k2(idx, mbatch, main_counts, tmax_stage=s))
        for stage in mixed.TMAX_STAGES}
    say(f"# K2 at B=128 Q=4 P=16 with body_tmax, ms per call: {json.dumps(k2_tmax_ms)}; "
        f"static {times['mixed'][0]:.4f}, plain {times['mixed'][1]:.4f} ({smi})")
    # K5 at the fused2 probe's shape (B=256, Q=4, k_pad=16, every column
    # read, query_len = the row's term count) and K6 at the phrase-delta
    # probe's (the first 16 rows of the B=128, P=16 mixed batch, phrase
    # rows first; and all 128, tiles without a phrase row included)
    k5_batch = check.to_device(
        check.keyword_batch(idx, 256, 4, seed=256, df=df, split=False), "cuda"
    )
    k5_args = check.k5_inputs(idx, k5_batch)
    held("fused_topk", check.compare_topk(check.run_k5(k5_args), check.run_k5(k5_args, plain=True)),
         "K5 B=256 Q=4 k_pad=16")
    for index in (idx, idx32):
        for rows in (BP_DELTA, None):
            for flag in (False, True):
                held("phrase_delta",
                     check.compare_delta(check.run_k6(index, mbatch, flag, rows),
                                         check.run_k6(index, mbatch, flag, rows, plain=True)),
                     f"K6 bp={rows or 128} flag={flag} planes={index.body.posT.dtype}")
    times["fused_topk"] = (
        check.time_ms(lambda: check.run_k5(k5_args)),
        check.time_ms(lambda: check.run_k5(k5_args, plain=True), iters=3, warmup=1),
    )
    times["phrase_delta"] = (
        check.time_ms(lambda: check.run_k6(idx, mbatch, False, BP_DELTA)),
        check.time_ms(lambda: check.run_k6(idx, mbatch, False, BP_DELTA, plain=True), iters=3,
                      warmup=1),
    )
    k6_full = check.time_ms(lambda: check.run_k6(idx, mbatch, False))
    say(f"# K6 at bp=128 (the rows without a phrase take the store-only path): "
        f"{k6_full:.4f} ms per call ({smi})")
    variants = {}  # K3 and K4 per variant at B=128, Q=4, qn-sorted rows
    for section in ("title", "body"):
        for emit in (True, False):
            variants[f"K3 {section} counts={emit}"] = (
                check.time_ms(lambda: check.run_k3(idx, cbatch, emit, section)),
                check.time_ms(lambda: check.run_k3(idx, cbatch, emit, section, plain=True),
                              iters=5),
            )
    for c in (1, 8):
        inputs = k4_in if c == 1 else check.fused_inputs(idx, cbatch, c, seed=c)
        variants[f"K4 C={c}"] = (
            check.time_ms(lambda: check.run_k4(idx, cbatch, inputs)),
            check.time_ms(lambda: check.run_k4(idx, cbatch, inputs, plain=True), iters=5),
        )
    for what, (ms, plain_ms) in variants.items():
        say(f"# {what} B=128 Q=4: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
    # the kernels line: the custom-blend route's K3 variant, K4 topics off
    times["membership_1sec"] = variants["K3 body counts=True"]
    times["fused"] = variants["K4 C=1"]
    # the finalize kernel at the index's width: every variant held bit for
    # bit, the engine's own (hot split, counts as the index needs) timed
    d_fin = idx.n_docs_padded
    for hot, counts, phrase in ((True, False, False), (True, True, False), (False, True, True),
                                (False, False, True)):
        case = check.finalize_case(128, d_fin, seed=3, hot=hot, counts=counts, phrase=phrase,
                                   device="cuda")
        held("finalize", check.compare_finalize(check.run_finalize(case),
                                                check.run_finalize(case, plain=True)),
             f"finalize B=128 D={d_fin} hot={hot} counts={counts} phrase={phrase}")
    fin_case = check.finalize_case(128, d_fin, seed=4, hot=True, counts=main_counts,
                                   device="cuda")
    times["finalize"] = (
        check.time_ms(lambda: check.run_finalize(fin_case)),
        check.time_ms(lambda: check.run_finalize(fin_case, plain=True), iters=5),
    )
    for kname, (ms, plain_ms) in times.items():
        say(f"# {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per B=128 call ({smi})")
    say(f"# mixed B=16 Q=4 P=4 (the serving shape): kernel {k2_b16[0]:.4f} ms, plain "
        f"{k2_b16[1]:.4f} ms per call ({smi})")
    k1_want = check.run_k1(idx, kbatch, main_counts, doc_sort, plain=True)
    lib_k1 = library_calls(idx, snap.n_words, kbatch, [k1_want[:2], k1_want[2:]])
    lib_k3 = library_calls(idx, snap.n_words, cbatch,
                           [check.run_k3(idx, cbatch, True, "body", plain=True)],
                           sections=("body",))
    say("# library calls equal the plain versions (K1: title + body; K3: body, with counts)")
    library = {  # one PyTorch call per section for the same function (yardstick only)
        "membership": check.time_ms(lambda: [torch.sparse.mm(w, m) for w, m in lib_k1]),
        "membership_1sec": check.time_ms(lambda: [torch.sparse.mm(w, m) for w, m in lib_k3]),
        "mixed": None,  # no single call: phrase chains over position planes
        "fused": None,  # no single call: membership, cosine normalisation and blend in one
        "fused_topk": None,  # no single call: membership, normalisation and a top-k in one
        "phrase_delta": None,  # no single call: phrase chains over position planes
        "finalize": None,  # no single call: the hot add, candidacy, cosine, blend and chunk max
    }
    secs = ("title", "body")
    n_k = 4 if main_counts else 2

    def sweeps(batch, sections=secs, phrases=False):
        return [(getattr(idx, s).fwd.ftT, row_terms(batch, s, phrases)) for s in sections]

    bounds = {
        "membership": bound_ms(idx, sweeps(kbatch), 128, n_k),
        "mixed": bound_ms(idx, sweeps(mbatch, phrases=True), 128, n_k),
        "membership_1sec": bound_ms(idx, sweeps(cbatch, ("body",)), 128, 2),
        "fused": bound_ms(idx, sweeps(cbatch), 128, 1, extra_bytes=4 * idx.n_docs_padded * 3),
        # K5: no [B, D] output; the two magnitudes and [B, 16] values and ids
        "fused_topk": bound_ms(idx, sweeps(k5_batch), 256, 0,
                               extra_bytes=2 * 4 * idx.n_docs_padded + 256 * 16 * 8),
        # K6: the phrase rows' terms only; add_t and add_b written once
        "phrase_delta": bound_ms(idx, sweeps(phrase_rows(mbatch, BP_DELTA, snap.n_words),
                                             phrases=True), BP_DELTA, 2),
    }
    # the finalize kernel: its [B, D] streams read once, final and cmax written once
    bounds["finalize"] = (check.finalize_bound_ms(128, d_fin, hot=True, counts=main_counts),
                          "bytes")
    k2_b16_bound = bound_ms(idx, sweeps(mbatch16, phrases=True), 16, n_k)
    say(f"# bounds (ms, what sets them; 4 B per real slot, 4 B per slot a row asks for, "
        f"each output once, over 3.35 TB/s): {bounds}; mixed B=16 {k2_b16_bound}")
    say(f"# library (torch.sparse.mm per section): {library}")
    qlen = kbatch["qn"].clamp(min=1).to(torch.float32)
    tp0 = torch.zeros((128, idx.n_categories), device="cuda")
    model = engine.model

    def rank_fused():
        return scoring.score_queries_fused(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerankT,
            kbatch["term_ids"], qlen, tp0, topk=50,
        )

    def rank_forward():
        return model.score_keywords(
            idx, kbatch["term_ids"], qlen, tp0, topk=50, qn=kbatch["qn"],
            qnb=kbatch["qnb"], hot_sids=kbatch["hot_sids"],
        )

    title_only = BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0)
    qlen_c = cbatch["qn"].clamp(min=1).to(torch.float32)

    def rank_custom():  # the custom-blend route's keyword rank
        return title_only._custom_forward(idx, cbatch["term_ids"], qlen_c, tp0, 50, qn=cbatch["qn"])

    fused_ms, forward_ms = check.time_ms(rank_fused), check.time_ms(rank_forward)
    custom_ms = check.time_ms(rank_custom)
    say(f"# score_queries_fused {fused_ms:.4f} ms vs score_queries_forward (production "
        f"keyword scorer: K1, hot split, finalize, top-k) {forward_ms:.4f} ms per B=128 "
        f"batch ({smi})")
    say(f"# custom-blend rank (two K3 calls with counts, phrase fold, finalize, top-k) "
        f"{custom_ms:.4f} ms per B=128 batch ({smi}); kernel phase "
        f"{time.perf_counter() - t0:.1f}s")
    phase_launches = {}
    lap("4 kernels")

    # 5. serving through the port's HTTP front end (the reference blend)
    t0 = time.perf_counter()
    engine.warmup()
    n_hyd = engine.prewarm_hydration()
    engine.prewarm_wordlist()
    say(f"# warmup + hydration prewarm ({n_hyd} records) in {time.perf_counter() - t0:.1f}s")
    queries = bench_queries(snap, QUERIES, seed=args.seed + 1, phrase_every=4, db=db)
    kw_only = [q for q in queries if '"' not in q][:32]
    prefixes = ["w0", "w00", "w001", "w12", "w2", "zz"]
    reset_launches()
    results, t_post = http_burst(engine, [("post", q) for q in queries], CLIENTS)
    # one client, one request at a time: single-row keyword batches (K1)
    results.update(http_burst(
        engine, [("get", q) for q in kw_only] + [("wordlist", p) for p in prefixes], 1
    )[0])
    phase_launches["serving"] = launches()
    say(f"# serving: {len(results)} responses; kernel launches {phase_launches['serving']}")
    say(f"# serving: {latency_line(results, len(queries), t_post)}")
    if min(phase_launches["serving"][k] for k in ("membership", "mixed")) == 0:
        raise RuntimeError(f"a kernel of the main path never launched: {phase_launches}")
    for pre in prefixes:
        words = results[("wordlist", pre)][1]
        if not isinstance(words, list) or not all(w.startswith(pre) for w in words):
            raise RuntimeError(f"/wordlist/{pre} answered {words!r:.200}")
    ref_q = queries + kw_only
    with plain_kernels():
        ref = engine.query_batch(ref_q)
    got = [results[("post", q)][1] for q in queries] + [results[("get", q)][1] for q in kw_only]
    n_hits = check_ranked(ref_q, got, ref, "serving")
    serving_ref = ref
    say(f"# serving: all {len(ref_q)} ranked responses equal the plain path ({n_hits} results)")

    # 6. fused ranking (K4) vs the production keyword scorer
    reset_launches()
    fs, fi = rank_fused()
    phase_launches["fused_rank"] = launches()
    ws, wi = rank_forward()
    if idx.doc_perm is not None:  # the fused path returns permuted-space ids
        fi = idx.doc_perm[fi.long()]
    if not same_topk(fs, fi, ws, wi, rtol=1e-5, atol=1e-6):
        raise RuntimeError("score_queries_fused disagrees with score_keywords top-50")
    say(f"# fused ranking: B=128 top-50 equals score_keywords (ids through doc_perm, "
        f"{int(torch.isfinite(ws).sum())} ranked); launches {phase_launches['fused_rank']}")

    # 7. a custom-blend engine (kernel K3; phrases on the sparse lane)
    t0 = time.perf_counter()
    custom = QueryEngine(db, snapshot=snap, index=idx, device="cuda",
                         model=BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0))
    custom.warmup()
    reset_launches()
    with count_matcher_calls() as matcher:
        got_kw = custom.query_batch(kw_only)
        kw_launches = launches()
        got = custom.query_batch(queries)
    phase_launches["custom_blend"] = launches()
    if kw_launches["membership_1sec"] == 0 or kw_launches["membership"] or matcher[0] == 0:
        raise RuntimeError(f"custom blend routes: keyword {kw_launches}, "
                           f"all {phase_launches['custom_blend']}, matcher calls {matcher[0]}")
    with plain_kernels():
        ref = custom.query_batch(kw_only + queries)
    n_hits = check_ranked(kw_only + queries, got_kw + got, ref, "custom blend")
    say(f"# custom blend: {len(kw_only) + len(queries)} queries equal the plain path "
        f"({n_hits} results); launches {phase_launches['custom_blend']}, sparse-lane "
        f"matcher calls {matcher[0]}; {time.perf_counter() - t0:.1f}s")

    # 8. --ranker bm25 serving (K1 over BM25 tiles; every phrase on the sparse lane)
    t0 = time.perf_counter()
    bm25 = QueryEngine(db, snapshot=snap, index=idx, device="cuda", model=BM25Ranker())
    bm25.warmup()
    bm25.prewarm_hydration()
    say(f"# bm25: engine + warmup in {time.perf_counter() - t0:.1f}s")
    reset_launches()
    with count_matcher_calls() as matcher:
        results, wall = http_burst(bm25, [("post", q) for q in queries], CLIENTS)
    phase_launches["bm25_serving"] = launches()
    say(f"# bm25 serving: {latency_line(results, len(queries), wall)}; launches "
        f"{phase_launches['bm25_serving']}, sparse-lane matcher calls {matcher[0]}")
    if phase_launches["bm25_serving"]["membership"] == 0 or matcher[0] == 0:
        raise RuntimeError("bm25 serving did not run K1 and the sparse lane")
    with plain_kernels():
        ref = bm25.query_batch(queries)
    n_hits = check_ranked(queries, [results[("post", q)][1] for q in queries], ref, "bm25")
    say(f"# bm25 serving: all {len(queries)} responses equal the plain path ({n_hits} results)")

    # 9. the exact CSR route on a truncated index
    t0 = time.perf_counter()
    nt_np = nt.cpu().numpy()
    cap = int(sorted(nt_np)[-3]) - 1  # at least three docs past the cap
    saved_cap = device_index.DOC_TERM_CAP
    device_index.DOC_TERM_CAP = cap
    try:
        trunc = QueryEngine(db, snapshot=snap, device="cuda")
    finally:
        device_index.DOC_TERM_CAP = saved_cap
    if not trunc.index.dense_truncated:
        raise RuntimeError(f"DOC_TERM_CAP={cap} did not truncate the index")
    csr_calls = [0]
    score_csr = BlendedRanker.score_csr

    def counted_csr(*a, **k):
        csr_calls[0] += 1
        return score_csr(*a, **k)

    csr_q = kw_only + queries[:128]
    reset_launches()
    BlendedRanker.score_csr = counted_csr
    try:
        with count_matcher_calls() as matcher:
            got = trunc.query_batch(kw_only) + trunc.query_batch(queries[:128])
    finally:
        BlendedRanker.score_csr = score_csr
    phase_launches["csr"] = launches()
    # no membership kernel on this route; its finalize takes the kernel once a call
    membership = {k: n for k, n in phase_launches["csr"].items() if k != "finalize"}
    if (csr_calls[0] < 2 or matcher[0] == 0 or any(membership.values())
            or phase_launches["csr"]["finalize"] != csr_calls[0]):
        raise RuntimeError(f"CSR route: score_csr calls {csr_calls[0]}, matcher calls "
                           f"{matcher[0]}, launches {phase_launches['csr']}")
    with plain_kernels():
        ref = engine.query_batch(csr_q)
    n_hits = check_ranked(csr_q, got, ref, "CSR route", rtol=CSR_RTOL)
    say(f"# CSR route: DOC_TERM_CAP {cap} truncates {int((nt_np > cap).sum())} docs; "
        f"{len(csr_q)} queries through score_csr ({csr_calls[0]} calls, {matcher[0]} CSR "
        f"matcher calls) equal the dense plain path ({n_hits} results); "
        f"{time.perf_counter() - t0:.1f}s")
    lap("5-9 serving, fused, custom, bm25, csr")
    # 10. the offline build: crawl CLI on the card over a local site
    crawl_phase(args.seed, smi, phase_launches)
    lap("10 crawl")
    # 11. PageRank at full size on the card: the 100k corpus's link graph
    pagerank_phase(db, args.seed, smi)
    lap("11 pagerank")
    # 12. the doc-sharded mesh on the card
    mesh = mesh_phase(db, snap, engine, queries, kw_only, serving_ref, df, smi, phase_launches)
    lap("12 mesh")
    for kname in ("membership_shard", "mixed_shard"):
        records[kname] = mesh[kname]["checks"]
        times[kname] = mesh[kname]["times"]
        bounds[kname] = mesh[kname]["bound"]
        library[kname] = mesh[kname]["library"]
    # 13. the graft entry points on the card
    entry_phase(smi, phase_launches)
    lap("13 entry")
    # 14. refresh under load on one card at the 100k corpus
    refresh_phase(snap, queries, kw_only, smi, phase_launches)
    lap("14 refresh")
    # 15. the sharded soak's load and refreshes, with the crash soak (18)
    # started beside them: its kills, restart and restart check run here
    # and in phase 16
    t0 = time.perf_counter()
    crash = Crash(args.seed)
    atexit.register(crash.kill)
    with open(go, "w"):
        pass
    rep = sharded.finish(1, smi, " (its load and refreshes after phase 14, beside the crash soak)")
    if rep.get("segregation") != "active":
        raise RuntimeError(f"soak_sharded: phrase-class segregation was not on at "
                           f"{SOAK_SHARDED_DOCS} docs: {rep}")
    say(f"# soak_sharded: {time.perf_counter() - t0:.1f}s from its start file to its end")
    lap("15 the sharded soak's load")
    # 16. the port's bench modes, each in a process of its own, with the
    # probes (17) and the crash soak's checks (18) beside them
    probes = Probes(args.seed)
    atexit.register(probes.kill)
    crash_s = [0.0]

    def crash_18() -> None:
        t0 = time.perf_counter()
        crash_phase(crash, smi, phase_launches)
        crash_s[0] = time.perf_counter() - crash.t0
        say(f"# phase 18: {time.perf_counter() - t0:.1f}s in this process after phase 17")
    probe_s = [0.0]
    probe_runs: dict[str, float] = {}

    def k2_bounded() -> None:
        """K2 with the doc-sorted body bound (body_tmax) at each tmax_stage
        on the serving mix at B=128 and B=16 and on the adversarial
        batches, with and without the hot split's qnb, counts on and
        elided: every output torch.equal to K2 without the bound, and
        within K2's tolerance of its plain version (its times are phase
        4's)."""
        cases = [("B=128 Q=4 P=16", mbatch), ("B=16 Q=4 P=4", mbatch16)]
        for kind in check.ADVERSARIAL:
            cases.append((f"adversarial {kind}", check.to_device(
                check.adversarial_batch(idx, kind, seed=7, df=df, snap=snap, b=128), "cuda")))
        cases.append(("adversarial log_full B=16", check.to_device(
            check.adversarial_batch(idx, "log_full", seed=8, df=df, snap=snap, b=16), "cuda")))
        n = 0
        for what, batch in cases:
            for split in (True, False):
                b = dict(batch, split=split and batch["split"])
                want = check.run_k2(idx, b, True, plain=True)
                for emit in (True, False):
                    static = check.run_k2(idx, b, emit)
                    plain = want if emit else (want[0], None, want[2], None)
                    for stage in mixed.TMAX_STAGES:
                        got = check.run_k2(idx, b, emit, tmax_stage=stage)
                        if not all((g is None and t is None) or torch.equal(g, t)
                                   for g, t in zip(got, static)):
                            raise RuntimeError(f"K2 with body_tmax ({stage}) differs from K2 "
                                               f"without it: {what} qnb={b['split']} "
                                               f"counts={emit}")
                        rep = check.compare(got, plain)
                        if not rep["ok"]:
                            raise RuntimeError(f"K2 with body_tmax ({stage}) disagrees with its "
                                               f"plain version: {what}: {rep}")
                        records["mixed_tmax"].append(rep)
                        n += 1
        say(f"# K2 with body_tmax: {n} calls ({len(cases)} batches x qnb on/off x counts "
            f"on/elided x stages {list(mixed.TMAX_STAGES)}) equal K2 without the bound "
            f"bit for bit and hold to its plain version (max abs err "
            f"{max(r['max_abs_err'] for r in records['mixed_tmax'])})")

    def probes_in_process() -> None:
        """The corpus probes' run() on this process's 100k corpus and
        engine, each with its own exactness check, at --reps 1."""
        sys.path.insert(0, os.path.join(HERE, "experiments"))
        import importlib

        for name, kw in PROBES_IN_PROCESS:
            mod = importlib.import_module(f"torch_{name}")
            t0 = time.perf_counter()
            log = (lambda name: lambda m: say(f"# probe {name}: {m}"))(name)
            if name in ("topk_probe", "fetch_async_probe"):
                res = mod.run(torch.device("cuda"), reps=1, say=log)
            elif name == "shard_scale_probe":  # no serve1m result yet: device figures only
                res = mod.run(snap, db, torch.device("cuda"), reps=1, say=log)
            elif name == "post16_probe":  # the f32 planes phase 4 already made
                res = mod.run(snap, db, engine, reps=1, say=log,
                              f32_planes=(idx32.title.posT, idx32.body.posT))
            else:
                res = mod.run(snap, db, engine, reps=1, say=log, **kw)
            probe_runs[name] = round(time.perf_counter() - t0, 1)
            say(f"# probe {name} ({probe_runs[name]}s in this process, {smi}): "
                f"{json.dumps(res)}")
            if not res["ok"]:
                raise RuntimeError(f"probe {name}: its exactness check failed: {res}")
            if name == "mixed_tbound_probe":
                phase_launches["probe_mixed_tbound"] = {"mixed_tmax": res["launches"]["K2_tmax"]}

    def probes_phase() -> None:
        """Phase 17 (inside phase 16's window, after this process's other
        checks): K5 and K6 against their plain versions on the batches
        that stress them, K2 with the body bound, the corpus probes in
        this process, then the probe processes' own checks."""
        t0 = time.perf_counter()
        for b in (45, 77):  # ragged row tiles of 32
            k5_case = check.topk_case(idx, b, seed=b, df=df)
            rep = check.compare_topk(check.run_k5(k5_case), check.run_k5(k5_case, plain=True))
            held("fused_topk", rep, f"K5 adversarial B={b} (no hit, fewer than 16 hits, "
                 "20 equal finals across doc tiles, a duplicated term)")
        for kind in check.ADVERSARIAL:
            batch = check.to_device(
                check.adversarial_batch(idx, kind, seed=7, df=df, snap=snap, b=128), "cuda"
            )
            k5_in = check.k5_inputs(idx, batch)
            held("fused_topk", check.compare_topk(check.run_k5(k5_in), check.run_k5(k5_in, plain=True)),
                 f"K5 adversarial {kind}")
            pad = phrase_delta.pad_column(batch["ph_ids"].shape[0], "cuda")
            tabs = [fn(pad, None, None, batch["ph_ids"], batch["ph_valid"], sections=1)
                    for fn in (probe.cuda_tables, probe.plain_tables)]
            if not (tabs[0][2] == tabs[1][2] and all(
                    torch.equal(tabs[0][i], tabs[1][i]) for i in (0, 1, 3))):
                raise RuntimeError(f"K6's tables of adversarial {kind} differ from their plain build")
            parts = [fn(batch["ph_ids"], batch["ph_valid"])
                     for fn in (phrase_delta.cuda_phrase_rows, phrase_delta.plain_phrase_rows)]
            if not (parts[0][3] == parts[1][3] and all(
                    torch.equal(parts[0][i], parts[1][i]) for i in (0, 1, 2))):
                raise RuntimeError(f"K6's phrase-row partition of adversarial {kind} differs "
                                   "from plain_phrase_rows")
            held("phrase_delta", check.compare_delta(check.run_k6(idx, batch, True),
                                                     check.run_k6(idx, batch, True, plain=True)),
                 f"K6 adversarial {kind} flag=True (tables and partition equal to the plain)")
        t_k2 = time.perf_counter()
        k2_bounded()
        t_in = time.perf_counter()
        probes_in_process()
        t1 = time.perf_counter()
        res = probes.finish(smi)
        phase_launches["probe_fused2"] = {"fused_topk": res["fused2"]["launches"]["K5"]}
        phase_launches["probe_phrase_delta"] = {
            "phrase_delta": res["phrase_delta"]["launches"]["K6"]}
        probe_s[0] = time.perf_counter() - t0
        say(f"# phase 17: K5/K6 holds {t_k2 - t0:.1f}s, K2 with body_tmax {t_in - t_k2:.1f}s, "
            f"the probes in this process {t1 - t_in:.1f}s ({json.dumps(probe_runs)}), then "
            f"{time.perf_counter() - t1:.1f}s waiting for the probe processes")

    bench_phase(smi, phase_launches, args.seed,
                beside=(adversarial, mesh["variants"], probes_phase, crash_18))
    lap("16 bench")
    phase_s["17 probes (inside 16)"] = round(probe_s[0], 1)
    times["mixed_tmax"] = (k2_tmax_ms[TMAX_LINE_STAGE], times["mixed"][1])
    bounds["mixed_tmax"] = bounds["mixed"]  # the same work: the bound skips only pads
    library["mixed_tmax"] = None
    phase_s["18 crash soak (from 15)"] = round(crash_s[0], 1)
    say(f"# launches per path: {json.dumps(phase_launches)}")
    say(f"# phase seconds: {json.dumps(phase_s)}")
    say(f"# smoke took {time.perf_counter() - t_start:.1f}s")

    kernels = []
    for kname, src, rep_line, path in (
        ("membership", "membership.cu", "spaghettisearch_tpu/ops/kernels/membership.py:274",
         "serving"),
        ("mixed", "mixed.cu", "spaghettisearch_tpu/ops/kernels/mixed.py:514", "serving"),
        ("membership_1sec", "membership.cu",
         "spaghettisearch_tpu/ops/kernels/membership.py:322", "custom_blend"),
        ("fused", "fused.cu", "spaghettisearch_tpu/ops/kernels/fused.py:111", "fused_rank"),
        ("membership_shard", "membership.cu", "spaghettisearch_tpu/ops/kernels/membership.py:274",
         "mesh_serving"),
        ("mixed_shard", "mixed.cu", "spaghettisearch_tpu/ops/kernels/mixed.py:514", "mesh_serving"),
        ("fused_topk", "fused_topk.cu", "experiments/fused2_probe.py:126", "probe_fused2"),
        ("phrase_delta", "phrase_delta.cu", "experiments/phrase_delta_probe.py:114",
         "probe_phrase_delta"),
        ("mixed_tmax", "mixed.cu", "spaghettisearch_tpu/ops/kernels/mixed.py:514",
         "probe_mixed_tbound"),
        ("finalize", "finalize.cu", "none: XLA fuses spaghettisearch_tpu/ops/scoring.py:122",
         "serving"),
    ):
        n = phase_launches[path][kname.removesuffix("_shard")]
        if n == 0:
            raise RuntimeError(f"{kname} never launched on its ranked path ({path})")
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"spaghettisearch_tpu_torch/csrc/{src}",
            "replaces": rep_line,
            "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in records[kname]),
            "ms": times[kname][0],
            "plain_ms": times[kname][1],
            "bound_ms": bounds[kname][0],
            "bound_by": bounds[kname][1],
            "library_ms": library[kname],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
