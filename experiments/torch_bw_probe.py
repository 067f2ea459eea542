#!/usr/bin/env python3
"""bw_probe.py on the PyTorch port: the card's memory rate on a 64 MB
array, its bf16 matmul rate, and the production forward scorer's QPS.

    python3 experiments/torch_bw_probe.py [--device cuda] [--docs 100000] [--words 50000]
        [--mib 64] [--mm 4096] [--reps 5]

Measures, by CUDA events over --reps calls after a warm one (host clock
with --device cpu):
  - a sum of a 64 MB float32 array (one read) and its scaling by
    1.0000001 (a read and a write), in GB/s;
  - a 4096^3 bfloat16 matmul (torch.matmul, float32 accumulation), in
    TFLOP/s: this measures the card, it ports no kernel;
  - the production forward scorer (score_queries_forward: K1, finalize,
    exact top-10; topics off, qn unset as in the original) on bench.py's
    synth_snapshot(--docs, --words) at B = 256 and 1024 rows of four
    df-weighted keywords (numpy seed 1), in QPS.
The original also swept the TPU kernel's n_blocks (m = 4, 8, 16), a
Mosaic grid dimension; K1 has no counterpart (its grid follows the doc
blocks and the row tiles), so only B is swept here.

The checks: the matmul of two all-ones matrices is 4096 in every element;
the B=1024 batch's first 256 rows are the B=256 batch, and their top-10
are equal bit for bit (a row's scores do not depend on its batch). Prints
the original's lines, then one JSON line; main() returns the same dict.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--words", type=int, default=50_000)
    ap.add_argument("--mib", type=float, default=64e6 / (1 << 20), help="the array's MiB")
    ap.add_argument("--mm", type=int, default=4096, help="the matmul's side")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from spaghettisearch_tpu_torch.corpus import synth_snapshot
    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_forward
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    dev = check.probe_device(args.device)
    out = {"probe": "bw_probe", "ms": {}, "rates": {}}

    def timeit(name, fn, bytes_moved=None):
        ms = check.time_on(fn, dev, iters=args.reps, warmup=1)
        out["ms"][name] = ms
        extra = ""
        if bytes_moved:
            out["rates"][name + " GB/s"] = bytes_moved / (ms / 1e3) / 1e9
            extra = f"  {out['rates'][name + ' GB/s']:7.1f} GB/s"
        print(f"{name:34s} {ms:9.4f} ms{extra}", flush=True)
        return ms

    n = int(args.mib * (1 << 20)) // 4
    big = torch.ones((n,), dtype=torch.float32, device=dev)
    nb = n * 4
    timeit(f"reduce {nb / 1e6:.0f}MB (read)", lambda: big.sum(), nb)
    timeit(f"scale {nb / 1e6:.0f}MB (read+write)", lambda: big * 1.0000001, 2 * nb)
    del big

    a = torch.ones((args.mm, args.mm), dtype=torch.bfloat16, device=dev)
    ms = timeit(f"matmul {args.mm}^3 bf16", lambda: torch.matmul(a, a))
    tflops = 2 * args.mm ** 3 / (ms / 1e3) / 1e12
    out["rates"]["matmul TFLOP/s"] = tflops
    mm_ok = bool((torch.matmul(a, a) == args.mm).all())
    print(f"  -> {tflops:.1f} TFLOP/s", flush=True)
    del a

    snap = synth_snapshot(n_docs=args.docs, n_words=args.words)
    idx = DeviceIndex.from_snapshot(snap, dev)
    rng = np.random.default_rng(1)
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    tq_all = rng.choice(args.words, size=(1024, 4), p=df / df.sum()).astype(np.int32)
    tops = {}
    util.reset_launches()
    for b in (256, 1024):
        tq = torch.from_numpy(tq_all[:b].copy()).to(dev)
        qlen = torch.full((b,), 4.0, dtype=torch.float32, device=dev)
        tp = torch.zeros((b, idx.n_categories), dtype=torch.float32, device=dev)

        def score(tq=tq, qlen=qlen, tp=tp):
            return score_queries_forward(
                idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
                tq, qlen, tp, topk=10, emit_counts=idx.has_zero_weight,
            )

        ms = timeit(f"score_fwd B={b}", score)
        out["rates"][f"score_fwd B={b} qps"] = b / (ms / 1e3)
        print(f"  -> {b / (ms / 1e3):8.0f} qps", flush=True)
        tops[b] = score()
    util.sync(dev)
    out["launches"] = util.launches()
    rows_ok = util.equal(tops[256], tuple(t[:256] for t in tops[1024]))
    print(f"matmul exact: {mm_ok}; B=1024's first 256 rows equal B=256's top-10: {rows_ok}",
          flush=True)
    out.update(docs=args.docs, words=args.words, matmul_exact=mm_ok, rows_equal=rows_ok,
               ok=mm_ok and rows_ok, **util.card(dev))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
