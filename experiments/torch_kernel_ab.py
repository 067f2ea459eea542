#!/usr/bin/env python3
"""Time the kernels of one checkout of the PyTorch port on one GPU.

    python3 experiments/torch_kernel_ab.py --tree DIR --db build/ab_corpus [--write]

Imports spaghettisearch_tpu_torch from DIR (a checkout of any commit of
the port), opens the seeded 100k-page benchmark corpus at --db through that
checkout's store (with --write it first writes it there), builds the
device index as the engine does, and measures on the card:
  - K1 at B=128 (Q=4, hot split, doc-sorted bound, counts as the engine
    emits them), K2 at B=128 (Q=4, P=16) and at B=16 (Q=4, P=4, the
    serving shape), K3 at B=128 (body section, counts on, Q=4: the
    custom-blend route's call), K4 at B=128 (Q=4, topics off), and one
    custom-blend rank at B=128 (BlendedRanker._custom_forward: two K3
    calls, phrase fold, finalize, top-k): the call, by CUDA events over 50
    calls back to back (check.time_ms), and the kernel alone, by
    torch.profiler (device time of the events named membership2_kernel /
    mixed_kernel / membership1_kernel / fused_kernel, and of
    build_tables_kernel, the probe-table build, where there is one);
  - each result against its plain version (check.compare, compare_section,
    compare_final; the custom rank's top-50 scores against the rank with
    K3's plain version);
  - with --serve, --bursts bursts (default 1) of 320 POST /query from 8
    clients through the checkout's HTTP front end (req/s, latency p50/p99,
    launches, batches per burst).
Prints one JSON line. To compare two commits, run it in one chip call for
both, in turns (parent, change, change, parent), on the same --db; with
--outputs FILE the first run saves every case's outputs and the later ones
report whether theirs are bit-identical (a kernel refactor that must not
change a result).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True, help="checkout whose port is measured")
    ap.add_argument("--db", required=True, help="corpus directory")
    ap.add_argument("--write", action="store_true", help="write the corpus first")
    ap.add_argument("--label", default="")
    ap.add_argument("--serve", action="store_true", help="also time a serving burst")
    ap.add_argument("--bursts", type=int, default=1, help="measured serving bursts")
    ap.add_argument("--outputs", default="", help="save each case's outputs here, or, when "
                    "the file exists, compare them with the saved ones bit for bit")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    from spaghettisearch_tpu_torch import corpus
    from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
    from spaghettisearch_tpu_torch.models.blended import BlendedRanker
    from spaghettisearch_tpu_torch.ops.kernels import check, membership
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    if args.write:
        import shutil

        shutil.rmtree(args.db, ignore_errors=True)
        db = corpus.write_corpus(args.db, n_pages=100_000, seed=0)
    else:
        db = corpus.Database(args.db)
    snap = build_snapshot(db)
    idx = QueryEngine(db, snapshot=snap, device="cuda").index
    setup_s = time.perf_counter() - t0
    df = snap.body.df(range(snap.n_words)).astype("float64")
    emit = idx.has_zero_weight
    tmax = idx.body.tmax_blocks is not None
    kbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df), "cuda")
    cbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df, split=False), "cuda")
    m128 = check.to_device(check.mixed_batch(idx, 128, 4, 16, seed=1, df=df, snap=snap), "cuda")
    m16 = check.to_device(check.mixed_batch(idx, 16, 4, 4, seed=2, df=df, snap=snap), "cuda")
    k4_in = check.fused_inputs(idx, cbatch, 1, seed=1)
    qlen = cbatch["qn"].clamp(min=1).to(torch.float32)
    tp0 = torch.zeros((128, idx.n_categories), device="cuda")
    title_only = BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0)

    def custom_rank(plain=False):
        saved = membership.forward_scores
        if plain:
            membership.forward_scores = lambda ftT, fwT, tq, qn=None, *, emit_counts=True: (
                membership.plain_section_scores(ftT, fwT, tq))
        try:
            return title_only._custom_forward(idx, cbatch["term_ids"], qlen, tp0, 50,
                                              qn=cbatch["qn"])
        finally:
            membership.forward_scores = saved

    cases = {
        "K1 B=128": (lambda plain=False: check.run_k1(idx, kbatch, emit, tmax, plain=plain),
                     "membership2_kernel", check.compare),
        "K2 B=128": (lambda plain=False: check.run_k2(idx, m128, emit, plain=plain),
                     "mixed_kernel", check.compare),
        "K2 B=16": (lambda plain=False: check.run_k2(idx, m16, emit, plain=plain),
                    "mixed_kernel", check.compare),
        "K3 body B=128": (lambda plain=False: check.run_k3(idx, cbatch, True, "body", plain=plain),
                          "membership1_kernel", check.compare_section),
        "K4 B=128 C=1": (lambda plain=False: check.run_k4(idx, cbatch, k4_in, plain=plain),
                         "fused_kernel", check.compare_final),
        "custom rank B=128": (custom_rank, "membership1_kernel",
                              lambda got, want: check.compare_final(got[0], want[0])),
    }
    out = {"label": args.label, "device": smi, "setup_s": setup_s, "cases": {}}
    saved = torch.load(args.outputs) if args.outputs and os.path.exists(args.outputs) else None
    outputs = {}
    for name, (run, kname, compare) in cases.items():
        got = run()
        outputs[name] = [x.cpu() for x in got if isinstance(x, torch.Tensor)]
        rep = compare(got, run(plain=True))
        ms = check.time_ms(run, iters=50, warmup=5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                run()
            torch.cuda.synchronize()
        dev_us = {k: sum(e.self_device_time_total for e in prof.key_averages() if k in e.key)
                  for k in (kname, "build_tables_kernel")}
        out["cases"][name] = {
            "wrapper_ms": ms, "kernel_device_ms": dev_us[kname] / 1e3 / 20,
            "table_build_device_ms": dev_us["build_tables_kernel"] / 1e3 / 20,
            "ok": rep["ok"], "max_abs_err": rep["max_abs_err"],
        }
        if saved is not None and name in saved:
            out["cases"][name]["bit_identical"] = len(saved[name]) == len(outputs[name]) and all(
                torch.equal(a, b) for a, b in zip(saved[name], outputs[name]))
    if args.outputs and saved is None:
        torch.save(outputs, args.outputs)
    if args.serve:
        out["serving"] = serve(db, snap, idx, args.bursts)
    print(json.dumps(out), flush=True)
    return 0


def serve(db, snap, idx, bursts: int = 1, n: int = 320, clients: int = 8) -> list[dict]:
    """`bursts` bursts of n POST /query (the benchmark mix) from `clients`
    threads through the checkout's SearchServer (micro-batching on), after
    warmup and a 64-request warm burst, sent by chip_smoke.send_jobs (every
    response 200, client errors raised): per burst, req/s, latency p50/p99
    (host clock), K1 and K2 launches, and the batcher's batch count."""
    import importlib.util

    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.ops.kernels import membership, mixed
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
    from spaghettisearch_tpu_torch.serve.server import SearchServer

    # this checkout's chip_smoke.py, whatever --tree put first on sys.path
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    engine = QueryEngine(db, snapshot=snap, index=idx, device="cuda")
    engine.warmup()
    engine.prewarm_hydration()
    server = SearchServer(engine, batching=True)
    host, port = server.start_background(port=0)
    base = f"http://{host}:{port}"
    queries = bench_queries(snap, n + 64, seed=1, phrase_every=4, db=db)
    runs = []
    try:
        smoke.send_jobs(base, [("post", q) for q in queries[n:]], clients)
        for _ in range(bursts):
            membership.reset_launches()
            mixed.reset_launches()
            b0 = server.batcher.stats.batches
            results, wall = smoke.send_jobs(base, [("post", q) for q in queries[:n]], clients)
            runs.append({
                **smoke.latency_stats(results, n, wall), "k1_launches": membership.LAUNCHES,
                "k2_launches": mixed.LAUNCHES, "batches": server.batcher.stats.batches - b0,
            })
    finally:
        server.shutdown()
    return runs


if __name__ == "__main__":
    raise SystemExit(main())
