#!/usr/bin/env python3
"""fused2_probe.py on the PyTorch port: one fused scorer with the top-k
inside (K5, csrc/fused_topk.cu), so the [B, D] score matrix never exists,
against the production keyword scorer.

    python3 experiments/torch_fused2_probe.py [--device cuda] [--docs 100000]

The original's shapes and draws: corpus.synth_snapshot(n_docs=100,000,
n_words=50,000) on the device, B=256 queries of Q=4 terms drawn
proportional to body df (seed 1), query_len = Q, k=10, k_pad=16. Times
the production path (score_queries_forward: K1, finalize, exact top-10,
topics off) and K5 (one launch geometry replaces the TPU kernel's
doc_block 512/1024 loop), by CUDA events on the card (host clock with
--device cpu, where K5 is its plain version), and K5's plain version; the
exactness check is the original's: K5's top-10 values allclose to
production's at rtol 1e-5, atol 1e-6 (the prototype's finalize drops the
PageRank term, which is zero here). Prints the original's lines, then one
JSON line; main() returns the same dict (chip_smoke.py phase 17).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--words", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    from spaghettisearch_tpu_torch.corpus import synth_snapshot
    from spaghettisearch_tpu_torch.ops.kernels import check, fused_topk, membership
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_forward
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    dev = check.probe_device(args.device)
    n_docs, n_words, b, q, k = args.docs, args.words, args.batch, 4, 10
    k_pad = 16
    snap = synth_snapshot(n_docs=n_docs, n_words=n_words)
    idx = DeviceIndex.from_snapshot(snap, dev)

    rng = np.random.default_rng(1)
    df = (snap.body.post_offsets[1:] - snap.body.post_offsets[:-1]).astype(np.float64)
    p = df / df.sum()
    tq = torch.from_numpy(rng.choice(n_words, size=(b, q), p=p).astype(np.int32)).to(dev)
    qlen = torch.full((b,), float(q), dtype=torch.float32, device=dev)
    tp = torch.zeros((b, idx.n_categories), dtype=torch.float32, device=dev)
    fwd = (idx.title.fwd.ftT, idx.title.fwd.fwT, idx.body.fwd.ftT, idx.body.fwd.fwT)

    def prod():
        return score_queries_forward(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerank,
            tq, qlen, tp, topk=k,
        )

    def fused():
        return fused_topk.fused_topk(*fwd, idx.mag_title, idx.mag_body, tq, qlen, k_pad)

    def fused_plain():
        return fused_topk.plain_fused_topk(*fwd, idx.mag_title, idx.mag_body, tq, qlen, k_pad)

    def timeit(name, fn, reps):
        ms = check.time_on(fn, dev, iters=reps, warmup=1)
        print(f"{name:30s} {ms:8.4f} ms/batch -> {b / ms * 1e3:8.0f} qps", flush=True)
        return ms

    rows = [set(r.tolist()) for r in tq.cpu()]
    bound = check.bound_ms([(fwd[0], rows), (fwd[2], rows)], n_words, b, fwd[0].shape[1], 0,
                           extra_bytes=2 * 4 * fwd[0].shape[1] + b * k_pad * 8)
    print(f"K5 bound: {bound[0]:.4f} ms ({bound[1]})", flush=True)
    membership.reset_launches()
    fused_topk.reset_launches()
    prod_ms = timeit("prod K1+finalize+topk", prod, args.reps)
    k5_ms = timeit("fused K5", fused, args.reps)
    launches = {"K1": membership.LAUNCHES, "K5": fused_topk.LAUNCHES}
    plain_ms = timeit("fused K5 plain version", fused_plain, max(1, args.reps // 5))
    want = [x.cpu().numpy() for x in prod()]
    got = fused()
    rep = check.compare_topk(got, fused_plain())
    ok = bool(np.allclose(got[0].cpu().numpy()[:, :k], want[0], rtol=1e-5, atol=1e-6))
    if ok:
        print("fused K5 matches", flush=True)
    else:
        print(f"fused K5 FAILED: {got[0][:2, :4]} vs {want[0][:2, :4]}", flush=True)
    print(f"fused K5 vs its plain version: {rep}", flush=True)
    res = {
        "probe": "fused2", "device": str(dev), "docs": n_docs, "batch": b,
        "doc_sort": idx.doc_perm is not None, "prod_ms": prod_ms, "k5_ms": k5_ms,
        "k5_plain_ms": plain_ms, "k5_bound_ms": bound[0], "k5_bound_by": bound[1],
        "ok": ok and rep["ok"], "matches_prod": ok,
        "vs_plain": rep, "launches": launches,
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
