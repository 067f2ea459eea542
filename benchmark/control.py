"""The control of the comparison: the configuration's reference in
bfloat16 in the port's place.

    python benchmark/control.py --workload <cell> --seeds 11,12,13 [--pool 150000]

For each seed it draws the cell's shard and stream as a run does, takes the
check's sample of the first `--pool` queries (the answers a window would
hold), and compares the configuration's reference (its `reference`, as
a run builds it) computed in bfloat16 (weights, and magnitudes where it
has them, and sums: the nearest precision below the float32 the
configuration states) with the same reference in float32, by the same
numbers and limits a run uses. The comparison is sound only if
the control fails it; the smallest reading over the seeds is each
number's upper reading.
The benchmark's runs do not run this; it needs a CUDA card unless
`--device cpu` is given (the CPU tests run it at a tiny size).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def control_readings(cell: dict, seed: int, pool: int, device: str) -> dict:
    """The control's worst numbers on one seed."""
    import numpy as np
    import torch

    from benchmark import collection, compare, reference, traffic
    from benchmark.run import CHECK_QUERIES, TOPK, WARM_BLOCKS, make_reference

    dev = torch.device(device)
    coll = collection.generate(cell["config_data"], seed, dev, snapshot=False,
                               content_seed=cell["content_seed"])
    texts = traffic.make_stream(cell["traffic_data"], coll, pool, seed,
                                content_seed=cell["content_seed"], first=WARM_BLOCKS).texts
    rng = np.random.default_rng([int(seed), 0xC4])
    picks = np.sort(rng.choice(pool, size=min(CHECK_QUERIES, pool), replace=False))
    cfg = cell["config_data"]
    ref = make_reference(cfg, coll, dev)
    low = make_reference(cfg, coll, dev, dtype=torch.bfloat16)
    k = TOPK
    rows = []
    for q in picks.tolist():
        vals, ids = reference.top_k(low.scores(texts[q]), k)
        rows.append(compare.gaps(vals, ids, ref.scores(texts[q])))
    return compare.worst(rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--pool", type=int, default=150_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if sys.path and os.path.abspath(sys.path[0]) == HERE:
        sys.path[0] = ROOT
    from benchmark.run import load_cell

    cell = load_cell(args.workload)
    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    out = {}
    for s in (int(x) for x in args.seeds.split(",")):
        out[s] = control_readings(cell, s, args.pool, args.device)
        print(json.dumps({"seed": s, **out[s]}), flush=True)
    limits = cell["limits"]
    fails = {s: [n for n, v in r.items() if v > limits[n]] for s, r in out.items()}
    print(json.dumps({"workload": args.workload, "limits": limits,
                      "upper": {n: min(r[n] for r in out.values()) for n in limits},
                      "control_fails_every_seed": all(fails.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
