"""Graft entry points on the port: a single-device step and a multi-device
dry run (the counterparts of the repo's `__graft_entry__.py` `entry` and
`dryrun_multichip`).

    from spaghettisearch_tpu_torch.graft_entry import dryrun_multichip, entry
    fn, args = entry("cuda"); scores, ids = fn(*args)
    out = dryrun_multichip(4)          # or devices=["cpu"] * 4 without a card

`entry(device)` returns the production fused mixed program (kernel K2 on a
CUDA device, its plain version on the CPU) with example arguments on
`device`. `dryrun_multichip(n)` runs the doc-sharded scorer, sharded
PageRank and one HTTP /query through a ShardedQueryEngine behind
SearchServer. Its shards go on `devices` when given, else shard s on
cuda:{s % device_count} (several shards share a card when there are fewer
cards than shards). Without CUDA and without `devices` it raises: it never
falls back to the CPU.
"""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import torch


def _small_engine(device):
    from .corpus import build_corpus_db
    from .retrieval.engine import QueryEngine

    # 512 pages: per-shard padded doc blocks and a real posting spread,
    # while the build stays a few seconds on a host CPU
    db = build_corpus_db(n_pages=512, seed=3, device=device)
    return QueryEngine(db, device=device)


def entry(device: str | torch.device = "cuda"):
    """The production fused mixed step (the engine's fused lane): keyword
    forward-membership scoring + dense in-kernel phrase matching (K2) ->
    fold -> cosine/PageRank blend -> exact top-k, on a 2,048-doc synthetic
    snapshot. -> (fn, example_args): fn(*example_args) -> (scores [8, 10],
    ids [8, 10])."""
    from .corpus import synth_snapshot
    from .ops.scoring import score_queries_mixed
    from .retrieval.device_index import DeviceIndex

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"entry(device={str(device)!r}): CUDA is not available")
    snap = synth_snapshot(
        n_docs=2048, n_words=1024, body_terms_per_doc=16, title_terms_per_doc=4,
        max_df=256,
    )
    idx = DeviceIndex.from_snapshot(snap, device)
    assert idx.pos_dense
    n_words = snap.n_words
    b, q, p = 8, 4, 16

    def fn(term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn):
        return score_queries_mixed(
            idx.title.fwd, idx.body.fwd, idx.title.posT, idx.body.posT,
            idx.mag_title, idx.mag_body, idx.pagerank,
            term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
            topk=10, emit_counts=idx.has_zero_weight,
        )

    rng = np.random.default_rng(0)
    pn = np.array([2, 1, 0, 0, 3, 0, 0, 0], np.int32)  # phrase rows first
    ph_ids = np.full((b, p), n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    for i, k in enumerate(pn):
        ph_ids[i, :k] = rng.integers(0, n_words, int(k))
        ph_valid[i, :k] = 1.0

    def put(x: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    example_args = (
        put(rng.integers(0, n_words + 1, (b, q)), torch.int32),
        torch.full((b,), 3.0, dtype=torch.float32, device=device),
        torch.zeros((b, idx.n_categories), dtype=torch.float32, device=device),
        put(ph_ids, torch.int32),
        put(ph_valid, torch.float32),
        put(np.full(b, q, np.int32), torch.int32),
        put(pn, torch.int32),
    )
    return fn, example_args


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the multi-device step over an n-device mesh on small shapes:
    doc-sharded postings scoring (local top-k + merge on the first device),
    PageRank with the edges sharded by destination, and one mixed query
    over HTTP through ShardedQueryEngine behind SearchServer. -> {"scores",
    "ids"} (the scorer's [2, 10] outputs), "ranks" ([1, N] PageRank) and
    "results" (the HTTP body)."""
    from .ops.pagerank import _load_graph
    from .parallel.mesh import make_mesh, make_mesh2d
    from .parallel.sharded import ShardedIndex, make_sharded_scorer, sharded_pagerank
    from .retrieval.engine import parse_query
    from .retrieval.sharded_engine import ShardedQueryEngine
    from .serve.server import SearchServer

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dryrun_multichip: no CUDA device is visible; pass devices= "
                "(e.g. ['cpu'] * n) to place the shards explicitly"
            )
        n_cards = torch.cuda.device_count()
        devices = [torch.device("cuda", s % n_cards) for s in range(n_devices)]
    devices = [torch.device(d) for d in devices][:n_devices]
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")

    eng = _small_engine(devices[0])
    # 2-D mesh when possible: query batch data-parallel over q, docs
    # sharded over d
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = make_mesh2d(2, n_devices // 2, devices=devices)
    else:
        mesh = make_mesh(n_devices, devices=devices)
    sidx = ShardedIndex.from_snapshot(eng.snapshot, mesh)
    scorer = make_sharded_scorer(sidx, topk=10)

    parsed = parse_query('ranking "quantum physics" retrieval')
    q = 4
    term_ids = np.full((2, q), eng.snapshot.n_words, np.int32)
    kw = eng.snapshot.term_ids(parsed.keyword_hashes)[:q]
    term_ids[0, : len(kw)] = kw
    term_ids[1, : len(kw)] = kw
    qlen = np.full((2,), float(parsed.query_len), np.float32)
    tp = np.zeros((2, sidx.shards[0].pagerank.shape[-1]), np.float32)
    ph_ids = np.full(4, eng.snapshot.n_words, np.int32)
    ph_valid = np.zeros(4, bool)
    pids = eng.snapshot.term_ids(parsed.phrase_hashes)
    ph_ids[: len(pids)] = pids
    ph_valid[: len(pids)] = True

    scores, ids = scorer(sidx, term_ids, qlen, tp, ph_ids, ph_valid, 0)
    assert scores.shape[0] == 2

    node_list, es, ed, od = _load_graph(eng.db)
    ranks = sharded_pagerank(
        mesh, es, ed, od.astype(np.float32),
        np.array([float(len(node_list))], np.float32),
        len(node_list), eps=1e-8, max_iters=50,
    )
    assert tuple(ranks.shape) == (1, len(node_list))

    # HTTP-level pass through the sharded serving stack: one mixed query
    # over the wire (the multi-device path must serve, not just score)
    seng = ShardedQueryEngine(eng.db, snapshot=eng.snapshot, n_shards=n_devices,
                              devices=devices)
    server = SearchServer(seng, batching=True)
    host, port = server.start_background(port=0)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/query",
            data=json.dumps({"query": 'ranking "quantum physics" search'}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=600) as resp:
            results = json.loads(resp.read())
        assert isinstance(results, list) and results, "sharded serve returned nothing"
        assert results[0]["Url"].startswith("http"), results[0]
    finally:
        server.shutdown()
    return {"scores": scores, "ids": ids, "ranks": ranks, "results": results}

