#!/usr/bin/env python3
"""h2d_probe.py on the PyTorch port: what a batch's small host-to-device
copies cost when dispatches are queued back to back, and how many the
engine makes per batch.

    python3 experiments/torch_h2d_probe.py [n] [--device cuda] [--reps 3] [--calls 30]
        [--heavy 4096]

The engine puts each host array of a batch on the device by itself
(retrieval/engine.py _to_dev: term_ids, qlen, topic_probs, qn, qnb,
hot_sids, and for a mixed batch ph_ids, ph_valid and pn). This probe
queues --calls dispatches of two programs, an instant one (the sum of
every input) and a ~15 ms one (six [heavy, heavy] float32 matmuls on a
resident matrix, then the same sums), whose inputs are, per call:
  (a) the nine small arrays of a B=128 mixed batch (the original counts
      them as ten), fresh numpy arrays, each through _to_dev;
  (b) one packed numpy array of the same bytes, through _to_dev, unpacked
      on the device as views;
  (c) the arrays already on the device;
  (d) the packed array from pinned host memory, copied with
      non_blocking=True.
Each: ms per call on the host clock, from the first dispatch to the
synchronization after the last, best of --reps. Then the uploads the
engine really makes: _to_dev calls and their bytes in one rank_async of a
keyword-only and of a mixed B=128 batch of bench_queries(snap, 512,
phrase_every=8) on the benchmark corpus of n pages (default 100,000).

The exactness check: for the same call's inputs, the four ways give the
same sums, bit for bit, in both programs. Prints the original's lines,
then one JSON line; main() returns the same dict (chip_smoke.py phase 17
calls run() on its own engine).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402

B, Q, C, P = 128, 4, 8, 16
#: the heavy program's matmuls (~15 ms at 4096 in float32 on an H100)
HEAVY_ITERS = 6


def fresh_small(i: int) -> tuple:
    rng = np.random.default_rng(i)
    return (
        rng.integers(0, 30000, (B, Q)).astype(np.int32),       # term_ids
        rng.random(B, dtype=np.float32),                        # qlen
        rng.random((B, C), dtype=np.float32),                   # topic_probs
        rng.integers(0, 30000, (B, P)).astype(np.int32),        # ph_ids
        rng.random((B, P), dtype=np.float32),                   # ph_valid
        rng.integers(1, 5, B).astype(np.int32),                 # qn
        rng.integers(0, 3, B).astype(np.int32),                 # pn
        rng.integers(1, 5, B).astype(np.int32),                 # qnb
        rng.integers(-1, 512, (B, Q)).astype(np.int32),         # hot_sids
    )


SHAPES = [a.shape for a in fresh_small(0)]
FLOATS = [a.dtype == np.float32 for a in fresh_small(0)]
SIZES = [a.size for a in fresh_small(0)]


def pack(arrs) -> np.ndarray:
    return np.concatenate([a.view(np.int32).ravel() for a in arrs])


def unpack(blob) -> list:
    import torch

    out, off = [], 0
    for shape, is_f, size in zip(SHAPES, FLOATS, SIZES):
        seg = blob[off : off + size].view(shape)
        out.append(seg.view(torch.float32) if is_f else seg)
        off += size
    return out


def sums(arrs):
    import torch

    return torch.stack([a.float().sum() for a in arrs])


def run(snap, db, eng, reps: int = 3, say=print, calls: int = 30, heavy_n: int = 4096) -> dict:
    import torch

    from spaghettisearch_tpu_torch.retrieval import engine as eng_mod

    dev = eng.index.device
    to_dev = eng_mod._to_dev
    smalls = [fresh_small(i) for i in range(calls)]
    packs = [pack(s) for s in smalls]
    pinned = [torch.from_numpy(p).pin_memory() if dev.type == "cuda" else torch.from_numpy(p)
              for p in packs]
    resident = [tuple(to_dev(a, dev) for a in s) for s in smalls]
    big = torch.from_numpy(np.random.default_rng(0).random((heavy_n, heavy_n), np.float32)).to(dev)

    def heavy():
        x = big
        for _ in range(HEAVY_ITERS):
            x = x @ big * 1e-3
        return x.sum()

    ways = {
        "9 small numpy arrays": lambda i: [to_dev(a, dev) for a in smalls[i]],
        "1 packed numpy array": lambda i: unpack(to_dev(packs[i], dev)),
        "pre-uploaded device arrays": lambda i: list(resident[i]),
        "1 packed pinned, non_blocking": lambda i: unpack(pinned[i].to(dev, non_blocking=True)),
    }
    programs = {"instant program (pure dispatch+upload)": lambda i, f: sums(f(i)),
                "~15 ms compute program (overlap regime)": lambda i, f: sums(f(i)) + heavy()}
    ms: dict = {}
    first: dict = {}
    for pname, prog in programs.items():
        say(f"{pname}:")
        ms[pname] = {}
        for wname, way in ways.items():
            util.sync(dev)
            prog(0, way)  # warm
            util.sync(dev)
            best = float("inf")
            for _ in range(max(reps, 1)):
                t0 = time.perf_counter()
                hs = [prog(i, way) for i in range(calls)]
                util.sync(dev)
                best = min(best, (time.perf_counter() - t0) / calls * 1e3)
            first[(pname, wname)] = hs[0]
            ms[pname][wname] = best
            say(f"  {wname:34s} {best:7.4f} ms/call")
    heavy_ms = util.time_host(lambda: (heavy(), util.sync(dev)), reps)
    say(f"the heavy program alone: {heavy_ms:.4f} ms")
    ok = all(torch.equal(first[(p, w)], first[(p, "9 small numpy arrays")])
             for p in programs for w in ways)
    say(f"the four ways' sums equal, bit for bit: {ok}")

    # the engine's own uploads per batch
    parsed = util.parsed_queries(snap, db, 512, 8)
    kw = [p for p in parsed if not p.phrase_hashes]
    ph = [p for p in parsed if p.phrase_hashes]
    batches = {"keyword B=128": (kw * 2)[:128], "mixed B=128": ph[:16] + kw[:112]}
    uploads = {name: util.count_uploads(eng, batch) for name, batch in batches.items()}
    for name, u in uploads.items():
        say(f"engine {name}: {u['uploads']} uploads, {u['bytes']} bytes")
    return {"probe": "h2d_probe", "calls": calls, "heavy_n": heavy_n, "ms": ms,
            "heavy_alone_ms": heavy_ms, "engine_uploads": uploads, "ok": ok, **util.card(dev)}


def main(argv=None) -> dict:
    ap = util.parser(__doc__, n_default=100_000, reps=3)
    ap.add_argument("--calls", type=int, default=30)
    ap.add_argument("--heavy", type=int, default=4096, help="the heavy program's matrix side")
    return util.main_with(run, __doc__, argv, ap=ap, calls="calls", heavy_n="heavy")


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
