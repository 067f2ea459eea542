#!/usr/bin/env python3
"""probe1m.py on the PyTorch port: where a served mixed batch's time goes
through the engine: one batch at a time, queued the way the micro-batcher
queues them, and the cost of the dispatch alone.

    python3 experiments/torch_probe1m.py [n] [--device cuda] [--reps 5]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing), the
engine warmed first. The original's batches: bench_queries(snap, 512,
phrase_every=8) in four batches of 128. Measures, on the host clock:
  - QueryEngine.rank() on the first batch, serially (dispatch, the device
    work, the fetch; best of --reps);
  - the four batches three times over through rank_async, all queued
    before the first finish() (the batcher's pipelined pattern: its
    steady state is the slowest stage, not the sum);
  - rank() on a keyword-only batch (the keyword-only queries of the four,
    repeated to 128), for the phrase work's increment;
  - the dispatch alone: rank_async of a second batch while the first is
    in flight, timed without a synchronize (kernel launches are
    asynchronous, as JAX's dispatch is).
The exactness check (the original has none): the pipelined results equal
the serial ones bit for bit, batch for batch. Prints the original's lines,
then one JSON line; main() returns the same dict (chip_smoke.py phase 17
calls run() on its engine).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def run(snap, db, eng, reps: int = 5, say=print, warm: bool = True) -> dict:
    idx = eng.index
    dev = idx.device
    say(f"fused={eng.model.supports_mixed(idx)}")
    if warm:
        t0 = time.perf_counter()
        eng.warmup()
        say(f"warmup in {time.perf_counter() - t0:.1f}s")
    parsed = util.parsed_queries(snap, db, 512, 8)
    batches = [parsed[i : i + 128] for i in range(0, 512, 128)]
    n_ph = sum(1 for p in batches[0] if p.phrase_hashes)
    util.reset_launches()
    ms = {}
    ms["mixed serial"] = util.time_host(lambda: eng.rank(batches[0]), reps)
    say(f"mixed 128-batch serial ({n_ph} phrases): {ms['mixed serial']:.4f} ms "
        f"({128e3 / ms['mixed serial']:.0f} qps)")
    serial = [eng.rank(b) for b in batches]
    for h in [eng.rank_async(b) for b in batches]:  # both programs warm
        h.finish()
    best, outs = float("inf"), None
    for _ in range(max(reps // 2, 1)):
        t0 = time.perf_counter()
        handles = [eng.rank_async(b) for b in batches * 3]
        got = [h.finish() for h in handles]
        best = min(best, (time.perf_counter() - t0) / len(handles))
        outs = got
    ms["mixed pipelined"] = best * 1e3
    say(f"mixed 128-batch pipelined: {ms['mixed pipelined']:.4f} ms/batch "
        f"({128e3 / ms['mixed pipelined']:.0f} qps)")
    kw_only = [q for q in parsed if not q.phrase_hashes]
    kw_batch = (kw_only * 2)[:128]
    ms["keyword-only serial"] = util.time_host(lambda: eng.rank(kw_batch), reps)
    say(f"keyword-only 128-batch serial: {ms['keyword-only serial']:.4f} ms "
        f"({128e3 / ms['keyword-only serial']:.0f} qps)")

    def dispatch_only():
        h = eng.rank_async(batches[0])
        t0 = time.perf_counter()
        h2 = eng.rank_async(batches[1])
        dt = time.perf_counter() - t0
        h.finish()
        h2.finish()
        return dt * 1e3

    ms["dispatch only"] = min(dispatch_only() for _ in range(max(reps, 1)))
    say(f"dispatch-only: {ms['dispatch only']:.4f} ms")
    ok = all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
             for a, b in zip(outs, serial * 3))
    say(f"pipelined results equal the serial ones: {ok}")
    return {"probe": "probe1m", "docs": idx.n_docs, "phrase_rows": n_ph, "ms": ms, "ok": ok,
            "launches": util.launches(), **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv, reps=5)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
