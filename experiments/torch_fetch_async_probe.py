#!/usr/bin/env python3
"""fetch_async_probe.py on the PyTorch port: does a non-blocking copy into
pinned memory, queued right behind a batch's device program, take the
device-to-host fetch off the host's path?

    python3 experiments/torch_fetch_async_probe.py [--device cuda] [--reps 5] [--n 4096]
        [--iters 18] [--batches 12]

A ~50 ms device program (--iters tanh(y @ a * 1e-4) steps over an
[n, n] float32 matrix) with a [128, 100] float32 result, the serving
shape of a packed top-k. Per rep r the program runs on seed r and:
  A. synchronous: dispatch, synchronize, then the .cpu() fetch (timed
     alone), and the whole from dispatch to the host array;
  B. what the engine does (retrieval/engine.py _RankHandle): at dispatch a
     copy_(non_blocking=True) into pinned memory and an event; then wait
     on the event and read the array (timed alone), and the whole;
  C. --batches batches pipelined, dispatching k+1 before fetching k, with
     a synchronous .cpu() fetch (which waits on everything queued before
     it on the stream, batch k+1 included);
  D. the same with B's copy and event at each dispatch, so fetching k
     waits only for k.
Times on the host clock: A and B per rep, C and D ms per batch, best of
three. The exactness check: each seed's fetched [128, 100] array is equal
bit for bit in A, B, C and D. Prints the original's lines, then one JSON
line; main() returns the same dict (chip_smoke.py phase 17 calls run()).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def run(device, reps: int = 5, say=print, n: int = 4096, iters: int = 18,
        batches: int = 12) -> dict:
    import torch

    a = torch.ones((n, n), dtype=torch.float32, device=device)
    on_card = torch.device(device).type == "cuda"

    def prog(seed: float):
        y = a + seed
        for _ in range(iters):
            y = torch.tanh(y @ a * 1e-4)
        return y[:128, :100]

    def async_copy(out):
        """The engine's pattern: pinned host buffer, non-blocking copy, an
        event behind it. -> (host tensor, event or None)."""
        if not on_card:
            return out.clone(), None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    def wait(pending):
        host, ev = pending
        if ev is not None:
            ev.synchronize()
        return host.numpy()

    prog(0.0).cpu()  # warm
    fetched: dict = {"A": {}, "B": {}, "C": {}, "D": {}}
    ms: dict = {"A fetch": [], "A whole": [], "B fetch": [], "B whole": []}
    for r in range(reps):
        t0 = time.perf_counter()
        out = prog(float(r))
        util.sync(device)
        t1 = time.perf_counter()
        fetched["A"][r] = out.cpu().numpy()
        t2 = time.perf_counter()
        ms["A fetch"].append((t2 - t1) * 1e3)
        ms["A whole"].append((t2 - t0) * 1e3)
    for r in range(reps):
        t0 = time.perf_counter()
        pending = async_copy(prog(float(r)))
        if pending[1] is not None:
            pending[1].synchronize()
        t1 = time.perf_counter()
        fetched["B"][r] = wait(pending).copy()
        t2 = time.perf_counter()
        ms["B fetch"].append((t2 - t1) * 1e3)
        ms["B whole"].append((t2 - t0) * 1e3)
    say("A fetch after synchronize (.cpu()): "
        + " ".join(f"{v:.4f}" for v in ms["A fetch"]) + " ms")
    say("B fetch after the event (pinned, non_blocking at dispatch): "
        + " ".join(f"{v:.4f}" for v in ms["B fetch"]) + " ms")

    def pipeline(use_async: bool, key: str) -> float:
        t0 = time.perf_counter()
        pend = []
        for k in range(batches):
            out = prog(float(k))
            pend.append(async_copy(out) if use_async else out)
            if k >= 1:
                p = pend[k - 1]
                fetched[key][k - 1] = wait(p).copy() if use_async else p.cpu().numpy()
        p = pend[-1]
        fetched[key][batches - 1] = wait(p).copy() if use_async else p.cpu().numpy()
        return (time.perf_counter() - t0) / batches * 1e3

    for label, key, use_async in (("C pipelined, synchronous fetch", "C", False),
                                  ("D pipelined + non-blocking copy at dispatch", "D", True)):
        v = [pipeline(use_async, key) for _ in range(3)]
        ms[key + " per batch"] = v
        say(f"{label}: " + " ".join(f"{x:.4f}" for x in v) + " ms/batch")
    ok = all(np.array_equal(fetched[w][r], fetched["A"][r])
             for w in ("B", "C", "D") for r in fetched[w] if r in fetched["A"])
    ok &= all(np.array_equal(fetched["C"][k], fetched["D"][k]) for k in range(batches))
    say(f"fetched arrays equal across A, B, C and D: {ok}")
    return {"probe": "fetch_async_probe", "n": n, "iters": iters, "batches": batches, "ms": ms,
            "ok": ok, **util.card(device)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n", type=int, default=4096, help="the program's matrix side")
    ap.add_argument("--iters", type=int, default=18, help="the program's matmul steps")
    ap.add_argument("--batches", type=int, default=12, help="C and D: batches pipelined")
    args = ap.parse_args(argv)
    from spaghettisearch_tpu_torch.ops.kernels import check

    dev = check.probe_device(args.device)
    res = run(dev, args.reps, n=args.n, iters=args.iters, batches=args.batches)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
