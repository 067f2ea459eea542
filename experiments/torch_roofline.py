#!/usr/bin/env python3
"""roofline.py on the PyTorch port: the card's achievable memory read rate,
and the two flagship programs' achieved GB/s as a share of it.

    python3 experiments/torch_roofline.py [--device cuda] [--skip-1m] [--skip-headline]
        [--pages 100000] [--pages1m 1000000] [--peak-mib 2048] [--reps 3] [--seed 0]

The stream peak: 8 full reads (a sum each, so each trip is one stream of
the array, as the original's comment at roofline.py:36-38 asks) of a
--peak-mib (2 GiB) float32 tensor, queued, one synchronization, best of
5; GB/s = 8 x its bytes over the host wall.

The programs, each through QueryEngine.rank_async, best of --reps runs of
6 queued batches (ms per batch, host clock):
  1. the headline keyword program: B=256, topk=10, keyword queries of
     bench_queries(snap, 1024, phrase_every=0) on the benchmark corpus of
     --pages pages (the original's 100k crawl corpus; doc-sorted, the
     body T bound), on a big_batch engine;
  2. the 1M mixed program: B=128, 16 phrase rows and 112 keyword rows of
     bench_queries(snap, 1024, phrase_every=8) on the --pages1m corpus
     (the original's 1M), the fused lane's static sweep and its planes.
The bytes each must move per batch, read from the engine's live
DeviceIndex as the original counts them: section_bytes (the ftT + fwT
stream of a section, times dyn_t_factor's swept share of body T where
the T bound applies), the hot matmul's W, PageRank and the magnitudes,
the [B, D] scores written and read once more, and for the mixed program
the position planes. Achieved GB/s is those bytes over the batch's time,
reported as a share of the measured stream peak and of the published
3.35 TB/s. Beside it, check.bound_ms of the program's kernel (K1, K2) on
the same batch: a different count (the term id of each real slot, the
weight of each slot a row asks for, the kernel's outputs), so the two are
labeled apart. The original's VPU compare-load estimate (a figure of the
TPU's vector unit) has no counterpart and is left out.

The exactness check: each program's batch ranked through the kernels
equals the same rank on the kernels' plain versions on the same device
(check.compare_topk). Prints the original's lines, then one JSON line;
main() returns the same dict. --skip-1m as in the original;
--skip-headline runs only the stream peak and the 1M program (the 1M tier
call, where the headline's 100k corpus is not built).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402

MiB = 1 << 20
#: the published memory rate of an H100 SXM (check.HBM_BYTES_PER_S)
PUBLISHED_GBPS = 3350.0


def measure_stream_peak(device, peak_mib: int = 2048) -> float:
    """Achievable read rate, GB/s: 8 sums of a peak_mib float32 tensor
    queued, one synchronization, best of 5 (after a warm run)."""
    import torch

    x = torch.ones((peak_mib * MiB // 4,), dtype=torch.float32, device=device)
    reads = 8

    def trip():
        outs = [x.sum() for _ in range(reads)]
        util.sync(device)
        return outs

    trip()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        trip()
        best = min(best, time.perf_counter() - t0)
    nbytes = x.numel() * x.element_size()
    del x
    return reads * nbytes / best / 1e9


def nbytes(t) -> int:
    return 0 if t is None else int(t.numel() * t.element_size())


def section_bytes(sec, dyn_factor: float = 1.0) -> float:
    """ftT + fwT stream per batch (the membership sweep reads both)."""
    return (nbytes(sec.fwd.ftT) + nbytes(sec.fwd.fwT)) * dyn_factor


def dyn_t_factor(idx) -> float:
    """Measured fraction of the static T sweep the dynamic-T bound leaves:
    sum over doc blocks of their tmax / (n_blocks * T)."""
    if idx.body.tmax_blocks is None:
        return 1.0
    tm = idx.body.tmax_blocks.cpu().numpy().astype(np.float64)
    t_static = idx.body.fwd.ftT.shape[0]
    return float(tm.sum() / (tm.size * t_static))


def kernel_bound(idx, batch: dict, phrases: bool) -> dict:
    """check.bound_ms of the program's kernel (K1, or K2 with phrases) on
    the batch as the engine lays it out (util.mixed_batch)."""
    from spaghettisearch_tpu_torch.ops.kernels import check

    b = dict(batch, split=idx.hot_body_map is not None)
    sweeps = [(getattr(idx, s).fwd.ftT, check.row_terms(b, s, phrases))
              for s in ("title", "body")]
    n_out = 4 if idx.has_zero_weight else 2
    ms, by = check.bound_ms(sweeps, idx.n_words, batch["term_ids"].shape[0],
                            idx.n_docs_padded, n_out)
    return {"kernel": "K2" if phrases else "K1", "bound_ms": ms, "bound_by": by}


def program(name: str, eng, snap, parsed: list, topk: int, by: dict, reps: int, peak: float,
            say, phrases: bool) -> dict:
    idx = eng.index
    util.reset_launches()
    ms = util.pipelined_ms(eng, parsed, reps, chain=6, topk=topk)
    util.sync(idx.device)
    launched = util.launches()
    got = eng.rank(parsed, topk=topk)
    with util.plain_kernels():
        want = eng.rank(parsed, topk=topk)
    vs_plain = util.topk_agree(got, want)
    total = sum(by.values())
    ach = total / (ms / 1e3) / 1e9
    kb = kernel_bound(idx, util.mixed_batch(snap, idx, parsed), phrases)
    say(f"[{name}] {ms:.4f} ms/{len(parsed)}-batch  bytes={total / 1e9:.4f} GB -> {ach:.1f} "
        f"GB/s = {100 * ach / peak:.1f}% of stream peak, {100 * ach / PUBLISHED_GBPS:.1f}% of "
        f"3.35 TB/s; {kb['kernel']} bound (check.bound_ms, its own bytes) {kb['bound_ms']:.4f} "
        f"ms; top-{topk} equal to the plain path: {vs_plain['ok']}")
    return {
        "ms_per_batch": ms, "batch": len(parsed), "topk": topk,
        "bytes_per_batch_GB": total / 1e9, "achieved_GBps": ach,
        "pct_of_stream_peak": 100 * ach / peak, "pct_of_published": 100 * ach / PUBLISHED_GBPS,
        "bytes_split": {k: int(v) for k, v in by.items()},
        "kernel_bound": kb, "launches": launched, "vs_plain": vs_plain,
    }


def headline(snap, db, eng, reps: int, peak: float, say=print) -> dict:
    """Program 1 on a big_batch engine over the corpus (`eng`)."""
    idx = eng.index
    kw = [p for p in util.parsed_queries(snap, db, 1024, 0) if not p.phrase_hashes]
    batch = (kw * 2)[:256]
    f_dyn = dyn_t_factor(idx)
    by = {
        "body_sweep": section_bytes(idx.body, f_dyn),
        "title_sweep": section_bytes(idx.title, f_dyn),
        "hot_matmul_W": nbytes(idx.hot_body_w),
        "rank_mag": nbytes(idx.pagerankT) + nbytes(idx.mag_title) + nbytes(idx.mag_body),
        "scores_rt": 2 * 256 * idx.n_docs_padded * 4,  # [B, D] write + top-k read
    }
    out = program(f"headline kw {snap.n_docs // 1000}k", eng, snap, batch, 10, by, reps, peak,
                  say, phrases=False)
    out["dyn_t_factor"] = f_dyn
    return out


def mixed(snap, db, eng, reps: int, peak: float, say=print) -> dict:
    """Program 2 on the engine over the corpus (`eng`)."""
    idx = eng.index
    parsed = util.parsed_queries(snap, db, 1024, 8)
    ph = [p for p in parsed if p.phrase_hashes]
    kw = [p for p in parsed if not p.phrase_hashes]
    batch = ph[:16] + kw[:112]
    by = {
        "body_sweep": section_bytes(idx.body),  # the mixed lane: static T
        "title_sweep": section_bytes(idx.title),
        "posT_body": nbytes(idx.body.posT),
        "posT_title": nbytes(idx.title.posT),
        "hot_matmul_W": nbytes(idx.hot_body_w),
        "rank_mag": nbytes(idx.pagerankT) + nbytes(idx.mag_title) + nbytes(idx.mag_body),
        "scores_rt": 2 * 128 * idx.n_docs_padded * 4,
    }
    return program(f"mixed {snap.n_docs // 1000}k", eng, snap, batch, 50, by, reps, peak, say,
                   phrases=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-1m", action="store_true", help="no 1M mixed program")
    ap.add_argument("--skip-headline", action="store_true", help="no headline program")
    ap.add_argument("--pages", type=int, default=100_000, help="the headline's corpus pages")
    ap.add_argument("--pages1m", type=int, default=1_000_000, help="the mixed program's pages")
    ap.add_argument("--peak-mib", type=int, default=2048, help="the stream peak's tensor, MiB")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0, help="the corpora's seed")
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch.bench import ensure_bench_corpus, load_bench_corpus
    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    dev = check.probe_device(args.device)
    peak = measure_stream_peak(dev, args.peak_mib)
    print(f"measured stream peak: {peak:.1f} GB/s ({args.peak_mib} MiB x 8 reads)", flush=True)
    out = {"probe": "roofline", "stream_peak_GBps": peak, "peak_mib": args.peak_mib,
           "published_GBps": PUBLISHED_GBPS}
    ok = True
    for key, n, skip, fn, big in (("headline_kw", args.pages, args.skip_headline, headline, True),
                                  ("mixed_1m", args.pages1m, args.skip_1m, mixed, False)):
        if skip:
            continue
        db, snap = load_bench_corpus(ensure_bench_corpus(n, device=str(dev), seed=args.seed))
        try:
            eng = QueryEngine(db, snapshot=snap, device=dev, big_batch=big)
            res = fn(snap, db, eng, args.reps, peak)
        finally:
            db.close()
        res["pages"] = n
        out[key] = res
        ok &= res["vs_plain"]["ok"]
        del eng
        gc.collect()
    out.update(ok=ok, **util.card(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
