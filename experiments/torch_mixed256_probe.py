#!/usr/bin/env python3
"""mixed256_probe.py on the PyTorch port: the mixed program (K2) at the
engine's batch buckets, to see how its cost grows with the rows.

    python3 experiments/torch_mixed256_probe.py [n] [--device cuda] [--reps 8]

n is the benchmark corpus's page count (the original's default,
1,000,000; built under build/bench/corpus{n//1000}k when missing). The
original's batches: the first B of bench_queries(snap, 256,
phrase_every=8) (Q=4, P=16, rows sorted phrase-first, topics off) at
B = 16 (the engine's B_SMALL), 128 (WARM_B_MAX) and 256 (B_BIG, the
engine's opt-in wide bucket); score_queries_mixed (K2, the hot fold,
finalize, top-50; no bound) timed by CUDA events (host clock with
--device cpu), with the ms per row and the queries per second each
batch's device time allows. The exactness check (the original has none):
a query's rows are independent of the others, so each query's top-50 is
the same at every batch size (scores within rtol 1e-6, since the hot
matmul's summation order may follow the batch's shape; ids equal except
at tied values). Prints the original's lines,
then one JSON line; main() returns the same dict (chip_smoke.py phase 17
calls run()).
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402

SIZES = (16, 128, 256)


def run(snap, db, eng, reps: int = 8, say=print) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check

    idx = eng.index
    dev = idx.device
    parsed = util.parsed_queries(snap, db, 256, 8)
    util.reset_launches()
    ms, by_query = {}, {}
    for bsz in SIZES:
        batch = util.mixed_batch(snap, idx, parsed[:bsz])
        ms[bsz] = check.time_on(lambda: util.mixed_rank(idx, batch), dev, iters=reps, warmup=1)
        say(f"mixed-{bsz}: {ms[bsz]:.4f} ms queued ({ms[bsz] / bsz * 1e3:.2f} us/row, "
            f"{bsz * 1e3 / ms[bsz]:.0f} qps ceiling)")
        s, i = util.mixed_rank(idx, batch)
        inv = torch.from_numpy(batch["perm"]).argsort().to(s.device)  # rows -> query order
        by_query[bsz] = (s[inv], i[inv])
    ok = True
    for bsz in SIZES[:-1]:
        rep = check.compare_topk(by_query[bsz], tuple(x[:bsz] for x in by_query[SIZES[-1]]))
        say(f"queries 0-{bsz - 1}: mixed-{bsz} against mixed-{SIZES[-1]}'s rows: {rep}")
        ok &= rep["ok"]
    return {"probe": "mixed256", "docs": idx.n_docs, "ms": ms, "ok": ok,
            "launches": util.launches(), **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
