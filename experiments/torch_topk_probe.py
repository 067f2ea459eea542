#!/usr/bin/env python3
"""topk_probe.py on the PyTorch port: top-k strategies over a [B, D] f32
score matrix on the card.

    python3 experiments/torch_topk_probe.py [--device cuda] [--batch 256] [--docs 100000]

The original's draws: a seeded normal [256, 100,000] f32 matrix (numpy
seed 0), k=10. Times, by CUDA events on the card (host clock with
--device cpu): torch.topk; the exact two-stage top-k (a top-k within each
of m blocks, then a top-k over the m * k candidates: every global top-k
element is top-k within its block, so nothing is lost) at m = 64, 256 and
1024; k rounds of argmax-and-mask; and the port's production top-k
(ops/scoring.py exact_top_k, with lax.top_k's tie rule). The original's
jax.lax.approx_max_k has no PyTorch counterpart and is not run: nothing
approximate is timed. The exactness check is the original's: each exact
variant's values equal torch.topk's, the argmax rounds' values equal them
as a set per row. Prints the original's lines, then one JSON line; main()
returns the same dict (chip_smoke.py phase 17 calls run()).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

APPROX = ("approx_max_k r=.99", "approx_max_k r=.95")


def two_stage_topk(x, k: int, m: int):
    """Exact two-stage top-k over the last axis -> (values, indices) [B, k]:
    pad D to a multiple of m with -inf, top-k in each of the m blocks, then
    top-k over the [B, m * k] candidates."""
    import torch

    b, d = x.shape
    pad = (-d) % m
    xp = torch.nn.functional.pad(x, (0, pad), value=-float("inf")) if pad else x
    w = xp.shape[1] // m
    bs, bi = torch.topk(xp.view(b, m, w), min(k, w), dim=2)  # [B, m, k]
    base = (torch.arange(m, device=x.device) * w)[None, :, None]
    cand_i = (bi + base).reshape(b, -1)
    s, pos = torch.topk(bs.reshape(b, -1), k, dim=1)
    return s, torch.gather(cand_i, 1, pos)


def argmax_topk(x, k: int):
    """k rounds of argmax, each masking its winner with -inf -> (values,
    indices) [B, k]."""
    import torch

    xx = x.clone()
    rows = torch.arange(x.shape[0], device=x.device)
    vs, is_ = [], []
    for _ in range(k):
        i = torch.argmax(xx, dim=1)
        vs.append(xx[rows, i])
        is_.append(i)
        xx[rows, i] = -float("inf")
    return torch.stack(vs, 1), torch.stack(is_, 1)


def run(dev, b: int = 256, d: int = 100_000, k: int = 10, reps: int = 5, say=print) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.ops.scoring import exact_top_k

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    ms = {}

    def timeit(name, fn):
        ms[name] = check.time_on(fn, dev, iters=reps, warmup=1)
        say(f"{name:28s} {ms[name]:8.4f} ms")
        return fn()

    want_s, _ = timeit("exact top_k", lambda: torch.topk(x, k, dim=1))
    ok = True
    for m in (64, 256, 1024):
        got_s, _ = timeit(f"two-stage m={m}", lambda m=m: two_stage_topk(x, k, m))
        if not torch.equal(got_s, want_s):
            say(f"two-stage m={m} mismatch")
            ok = False
    prod_s, _ = timeit("exact_top_k (production)", lambda: exact_top_k(x, k))
    if not torch.equal(prod_s, want_s):
        say("exact_top_k mismatch")
        ok = False
    for name in APPROX:
        say(f"{name:28s} not run: jax.lax.approx_max_k has no PyTorch counterpart, "
            "and nothing approximate is timed")
    got_s, _ = timeit("argmax xk", lambda: argmax_topk(x, k))
    if not torch.equal(torch.sort(got_s, 1).values, torch.sort(want_s, 1).values):
        say("argmax xk mismatch")
        ok = False
    if ok:
        say("all exact variants verified")
    return {"probe": "topk", "batch": b, "docs": d, "k": k, "ms": ms,
            "not_run": list(APPROX), "ok": ok}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    from spaghettisearch_tpu_torch.bench import card
    from spaghettisearch_tpu_torch.ops.kernels import check

    dev = check.probe_device(args.device)
    res = run(dev, args.batch, args.docs, args.k, args.reps)
    res.update(card(dev))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
