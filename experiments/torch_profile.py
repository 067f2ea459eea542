#!/usr/bin/env python3
"""Where the device time goes in the PyTorch port's online path (one GPU).

    python3 experiments/torch_profile.py [--out build/torch_profile.json]

Builds the seeded 100k-page benchmark corpus (spaghettisearch_tpu_torch/
corpus.py), then traces with torch.profiler:
  1. engine.rank on B=128 keyword-only batches and on B=128 mixed batches
     (every 4th query a phrase): device time per kernel name, and the
     device's busy share of each rank's wall time;
  2. a serving burst through the HTTP front end (8 client threads, 320
     POST /query): device busy share of the burst's wall time.
Prints one JSON object with the breakdown and writes it to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def kernel_table(prof, top: int = 12) -> tuple[list[dict], float]:
    """(per-kernel device time rows, summed device time in ms). Only the
    device-side events (kernels, copies, memsets) count: a CPU op's device
    time repeats the kernels it launched."""
    from torch.autograd import DeviceType

    rows = []
    total = 0.0
    for e in prof.key_averages():
        dev_us = e.self_device_time_total
        if e.device_type != DeviceType.CUDA or dev_us <= 0:
            continue
        total += dev_us
        rows.append({"name": e.key[:90], "calls": e.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:top], total / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "build", "torch_profile.json"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: CUDA is not available", file=sys.stderr)
        return 2
    from spaghettisearch_tpu_torch.corpus import bench_queries, write_corpus
    from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query
    from spaghettisearch_tpu_torch.serve.server import SearchServer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    subprocess.run(["make", "-C", os.path.join(HERE, "native"), "-s"], check=True)
    root = os.path.join(HERE, "build", "profile_corpus")
    shutil.rmtree(root, ignore_errors=True)
    db = write_corpus(root, n_pages=100_000, seed=0)
    snap = build_snapshot(db)
    engine = QueryEngine(db, snapshot=snap, device="cuda")
    engine.warmup()
    engine.prewarm_hydration()
    engine.prewarm_wordlist()
    queries = bench_queries(snap, 1280, seed=1, phrase_every=4, db=db)
    kw = [parse_query(q) for q in queries if '"' not in q]
    mixed = [parse_query(q) for q in queries]
    out = {"device": smi, "docs": snap.n_docs}

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for lane, parsed in (("keyword", kw), ("mixed", mixed)):
        batches = [parsed[i : i + 128] for i in range(0, 128 * 8, 128)]
        for b in batches[:2]:  # warm the allocator / pinned pool
            engine.rank(b)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for b in batches:
                engine.rank(b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, dev_ms = kernel_table(prof)
        out[lane] = {
            "batches": len(batches), "rank_wall_ms_per_batch": wall / len(batches),
            "device_ms_per_batch": dev_ms / len(batches),
            "device_busy_share": dev_ms / wall, "kernels": rows,
        }

    server = SearchServer(engine, batching=True)
    host, port = server.start_background(port=0)
    base = f"http://{host}:{port}"
    burst = queries[:320]

    def client(part):
        for q in part:
            req = urllib.request.Request(
                base + "/query", data=json.dumps({"query": q}).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            with urllib.request.urlopen(req, timeout=300) as r:
                if r.status != 200:
                    raise RuntimeError(f"/query answered {r.status}")
                r.read()

    client(burst[:16])  # warm connections and hydration caches
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(burst[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = (time.perf_counter() - t0) * 1e3
    server.shutdown()
    rows, dev_ms = kernel_table(prof)
    out["serving"] = {
        "requests": len(burst), "wall_ms": wall, "req_per_s": len(burst) / wall * 1e3,
        "device_ms": dev_ms, "device_busy_share": dev_ms / wall, "kernels": rows,
        "batcher": {"batches": server.batcher.stats.batches,
                    "mean_batch": server.batcher.stats.mean_batch},
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
