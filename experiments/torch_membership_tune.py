#!/usr/bin/env python3
"""membership_tune.py on the PyTorch port: the one-section membership
kernel (K3, ss_membership1 in csrc/membership.cu) alone at the body
shapes of the 100k-doc headline bench, beside its plain version and
torch.sparse.mm, the library call for the same function.

    python3 experiments/torch_membership_tune.py [--device cuda] [--docs 100352]

The original's shapes and draws (seed 0): ft int32 / fw f32 [64, 100,352]
(every slot real), B=256 queries of Q=4 terms, 50,000 words. Its Mosaic
variants (mult / f32 compare / T-sum accumulation, doc_block 512-2048,
b_block 8-32) are tilings of one function that K3 computes with its own
launch geometry (probe tables, one thread per doc), so the rows here are:
K3 with counts (the original's "prod" kernel emits both), its plain
version, and torch.sparse.mm of the CSR [D, V+1] weight matrix (and a
matrix of ones for the counts) by the [V+1, B] query-multiplicity matrix,
built outside the timed region. Each is timed by CUDA events on the card
(host clock with --device cpu, where K3 is its plain version) and printed
as ms and Telem/s (B x T x D membership tests per second), as the
original prints them. The check is the original's: scores within rtol
1e-5 of the reference (here the plain version) and counts equal, for K3
and for the library call. Prints one JSON line; main() returns the same
dict (chip_smoke.py phase 17).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sparse_operands(ft, fw, tq, n_words: int):
    """(W, W1, M): CSR [D, V+1] of the weights and of ones (each doc's
    columns sorted; a term twice in a doc is two entries), and the dense
    [V+1, B] query-multiplicity matrix, so sparse.mm(W, M)[d, b] is
    score[b, d] and sparse.mm(W1, M)[d, b] is count[b, d]."""
    import torch

    cols, order = ft.t().sort(dim=1)
    vals = fw.t().gather(1, order)
    d, t = cols.shape
    crow = torch.arange(0, d * t + 1, t, dtype=torch.int64, device=ft.device)
    b, q = tq.shape
    m = torch.zeros((n_words + 1, b), dtype=torch.float32, device=ft.device)
    m.index_put_((tq.long().flatten(), torch.arange(b, device=ft.device).repeat_interleave(q)),
                 torch.ones(b * q, device=ft.device), accumulate=True)

    def csr(v):
        return torch.sparse_csr_tensor(crow, cols.reshape(-1).long(), v.reshape(-1).contiguous(),
                                       size=(d, n_words + 1))

    return csr(vals), csr(torch.ones_like(vals)), m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=100_352)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check, membership

    dev = check.probe_device(args.device)
    rng = np.random.default_rng(0)
    t, d_total = 64, args.docs  # body shapes of the headline bench
    b, q = args.batch, 4
    n_words = 50_000
    ft = rng.integers(0, n_words, (t, d_total)).astype(np.int32)
    fw = rng.random((t, d_total)).astype(np.float32)
    tq = rng.integers(0, n_words, (b, q)).astype(np.int32)
    ftT = torch.from_numpy(ft).to(dev)
    fwT = torch.from_numpy(fw).to(dev)
    tqd = torch.from_numpy(tq).to(dev)
    elems = b * t * d_total

    def timeit(name, fn, reps):
        ms = check.time_on(fn, dev, iters=reps, warmup=1)
        print(f"{name:34s} {ms:8.4f} ms  ({elems / ms / 1e9:5.2f} Telem/s)", flush=True)
        return ms

    w, w1, m = sparse_operands(ftT, fwT, tqd, n_words)
    bound = check.bound_ms([(ftT, [set(r.tolist()) for r in tq])], n_words, b, d_total, 2)
    print(f"bound (scores and counts): {bound[0]:.4f} ms ({bound[1]})", flush=True)
    membership.reset_launches()
    k3_ms = timeit("K3 (ss_membership1, counts)",
                   lambda: membership.forward_scores(ftT, fwT, tqd), args.reps)
    launches = {"K3": membership.LAUNCHES_1SEC}
    plain_ms = timeit("K3 plain version",
                      lambda: membership.plain_section_scores(ftT, fwT, tqd),
                      max(1, args.reps // 5))
    lib_ms = timeit("torch.sparse.mm (score, count)",
                    lambda: (torch.sparse.mm(w, m), torch.sparse.mm(w1, m)), args.reps)
    want = membership.plain_section_scores(ftT, fwT, tqd)
    rows = {}
    for name, got in (("K3", membership.forward_scores(ftT, fwT, tqd)),
                      ("torch.sparse.mm", (torch.sparse.mm(w, m).t(), torch.sparse.mm(w1, m).t()))):
        ok = bool(torch.allclose(got[0], want[0], rtol=1e-5)) and bool(torch.equal(got[1], want[1]))
        if not ok:
            print(f"  ^ {name} MISMATCH", flush=True)
        rows[name] = {"ok": ok, "max_abs_err": float((got[0] - want[0]).abs().max())}
    res = {"probe": "membership_tune", "device": str(dev), "t": t, "docs": d_total, "batch": b,
           "k3_ms": k3_ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound[0],
           "bound_by": bound[1],
           "k3_telem_s": elems / k3_ms / 1e9, "ok": all(r["ok"] for r in rows.values()),
           "checks": rows, "launches": launches}
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
