#!/usr/bin/env python3
"""segregate_probe.py on the PyTorch port: the price of phrase-class batch
segregation, through the engine.

    python3 experiments/torch_segregate_probe.py [n] [--device cuda] [--reps 3] [--passes 3]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing), the
engine warmed first. The original's workload: bench_queries(snap, 1024,
phrase_every=8), 1/8 of the queries with a phrase. Each pattern is ranked
through QueryEngine.rank_async, its batches queued --passes (3) times
over before the first finish() (the batcher's pipelined pattern), on the host
clock, best of --reps:
  - the mixed 128-batches in query order (the control: every batch holds
    a phrase, so all take the mixed lane, K2);
  - keyword-only 128-batches (K1);
  - one all-phrase 128-batch (the phrase queries, repeated to 128);
  - the segregated pattern: 7 keyword batches and 1 all-phrase batch per
    1,024 queries, as a segregating batcher would emit them.
The micro-batcher segregates phrase-class batches only from 2^19 docs
(engine SEGREGATE_MIN_DOCS, QueryEngine.class_batching_pays); below that,
as at 100k, it does not, and the probe prices the pattern through
engine.rank_async all the same (its output says which). The exactness
check (the original has none): each query's top-50 in the segregated
pattern equals its top-50 in the control (scores within rtol 1e-6, ids
equal except at tied values: a keyword query's rows go through K1 in one
and K2 in the other). Prints the original's lines, then one JSON line;
main() returns the same dict (chip_smoke.py phase 17 calls run() on its
engine).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def pipelined(eng, batches, reps: int, label: str, say, passes: int = 3):
    """ms per batch, best of reps runs of the batches queued `passes`
    times over, then finished; after one untimed pass. -> (ms, the last
    run's results of the first pass)."""
    for h in [eng.rank_async(b) for b in batches]:
        h.finish()
    best, outs = float("inf"), None
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        handles = [eng.rank_async(b) for b in batches * passes]
        got = [h.finish() for h in handles]
        best = min(best, (time.perf_counter() - t0) / len(handles))
        outs = got[: len(batches)]
    n_q = sum(len(b) for b in batches) / len(batches)
    say(f"{label}: {best * 1e3:.4f} ms/batch ({n_q / best:.0f} qps)")
    return best * 1e3, outs


def run(snap, db, eng, reps: int = 3, say=print, warm: bool = True, passes: int = 3) -> dict:
    import numpy as np
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.retrieval.engine import SEGREGATE_MIN_DOCS

    idx = eng.index
    dev = idx.device
    segregates = eng.class_batching_pays()
    say(f"fused={eng.model.supports_mixed(idx)}; the batcher segregates here: {segregates} "
        f"({idx.n_docs} docs, from {SEGREGATE_MIN_DOCS})")
    if warm:
        t0 = time.perf_counter()
        eng.warmup()
        say(f"warmup in {time.perf_counter() - t0:.1f}s")
    parsed = util.parsed_queries(snap, db, 1024, 8)
    kw = [p for p in parsed if not p.phrase_hashes]
    ph = [p for p in parsed if p.phrase_hashes]
    say(f"workload: {len(kw)} keyword / {len(ph)} phrase")
    util.reset_launches()
    ms = {}
    mixed_batches = [parsed[i : i + 128] for i in range(0, 1024, 128)]
    ms["mixed (control)"], ctrl = pipelined(eng, mixed_batches, reps,
                                            "mixed 128-batch (control)", say, passes)
    kw_batches = [kw[i : i + 128] for i in range(0, len(kw) - 127, 128)]
    ms["keyword"], _ = pipelined(eng, kw_batches, reps, "keyword 128-batch", say, passes)
    ph_batch = (ph * ((127 + len(ph)) // len(ph)))[:128]
    ms["all-phrase"], _ = pipelined(eng, [ph_batch], reps, "ALL-phrase 128-batch", say, passes)
    seg = kw_batches[:7] + [ph[:128] if len(ph) >= 128 else ph_batch]
    ms["segregated"], seg_out = pipelined(eng, seg, reps,
                                          "segregated (7kw+1ph) per-batch mean", say, passes)
    n_q = sum(len(x) for x in seg)
    qps = n_q / (ms["segregated"] * len(seg) / 1e3)
    ctrl_qps = 1024 / (ms["mixed (control)"] * len(mixed_batches) / 1e3)
    say(f"segregated pattern: {n_q} queries in {ms['segregated'] * len(seg):.4f} ms -> "
        f"{qps:.0f} qps (control {ctrl_qps:.0f})")

    # each query's answer in both patterns (a query's text names it)
    def by_query(batches, outs):
        return {p.raw: (s, i) for b, (ss, ii) in zip(batches, outs)
                for p, s, i in zip(b, ss, ii)}

    want, got = by_query(mixed_batches, ctrl), by_query(seg, seg_out)
    keys = [k for k in got if k in want]
    rep = check.compare_topk(
        tuple(torch.from_numpy(np.stack([got[k][j] for k in keys])) for j in (0, 1)),
        tuple(torch.from_numpy(np.stack([want[k][j] for k in keys])) for j in (0, 1)))
    say(f"segregated answers against the control's ({len(keys)} queries): {rep}")
    return {"probe": "segregate", "docs": idx.n_docs, "batcher_segregates": segregates,
            "ms": ms, "qps": qps, "control_qps": ctrl_qps, "vs_control": rep,
            "ok": rep["ok"] and len(keys) == len(got), "launches": util.launches(),
            **util.card(dev)}


def main(argv=None) -> dict:
    ap = util.parser(__doc__, reps=3)
    ap.add_argument("--passes", type=int, default=3,
                    help="times each pattern's batches are queued per timed run")
    return util.main_with(run, __doc__, argv, ap=ap, passes="passes")


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
