"""Shared set-up of the corpus probes of experiments/ on the PyTorch port
(torch_probe1m_decomp.py, torch_mixed_tbound_probe.py, ...): their command
line, the benchmark corpus and a QueryEngine on the device, the original
probes' query batches laid out as the engine lays them out, and timing.

Each probe has run(snap, db, eng, reps=..., say=print) -> dict, which
chip_smoke.py calls on the corpus and engine it has loaded, and main(argv),
which builds or reuses the corpus (spaghettisearch_tpu_torch.bench
ensure_bench_corpus, under build/bench/corpus{n // 1000}k), opens an
engine on --device (cuda by default; no CUDA exits with a message, never a
fallback to the CPU), calls run(), and prints the result as its last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def parser(doc: str, n_default: int = 1_000_000, positional: bool = True,
           reps: int = 8) -> argparse.ArgumentParser:
    """The probes' command line: the corpus's page count (positional where
    the original takes one, else --pages), --device, --seed (the corpus's
    seed), --reps (timed calls per variant)."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    if positional:
        ap.add_argument("n", nargs="?", type=int, default=n_default, help="corpus pages")
    else:
        ap.add_argument("--pages", dest="n", type=int, default=n_default, help="corpus pages")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="the corpus's seed")
    ap.add_argument("--reps", type=int, default=reps)
    return ap


def open_engine(args, doc_sort: bool | None = None):
    """-> (db, snap, eng): the benchmark corpus of args.n pages and a
    QueryEngine on args.device (doc_sort None: the index's own rule)."""
    from spaghettisearch_tpu_torch.bench import ensure_bench_corpus, load_bench_corpus
    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    dev = check.probe_device(args.device)
    db, snap = load_bench_corpus(ensure_bench_corpus(args.n, device=str(dev), seed=args.seed))
    t0 = time.perf_counter()
    eng = QueryEngine(db, snapshot=snap, device=dev, doc_sort=doc_sort)
    idx = eng.index
    print(f"device index in {time.perf_counter() - t0:.1f}s  docs={idx.n_docs}  "
          f"doc_sort={idx.doc_perm is not None}  pos_dense={idx.pos_dense}", flush=True)
    return db, snap, eng


def main_with(run, doc: str, argv=None, *, n_default: int = 1_000_000,
              positional: bool = True, reps: int = 8, doc_sort: bool | None = None,
              ap: argparse.ArgumentParser | None = None, **run_args) -> dict:
    """A probe's main(): parse (with `ap`, a parser() the probe extended;
    its own options are passed to run() by the names in run_args, whose
    values name the option), open the corpus and engine, run, print the
    result's JSON line last."""
    args = (ap or parser(doc, n_default, positional, reps)).parse_args(argv)
    db, snap, eng = open_engine(args, doc_sort)
    try:
        res = run(snap, db, eng, reps=args.reps,
                  **{k: getattr(args, opt) for k, opt in run_args.items()})
    finally:
        db.close()
    res["n"] = args.n
    print(json.dumps(res), flush=True)
    return res


def card(device) -> dict:
    from spaghettisearch_tpu_torch.bench import card as bench_card

    return bench_card(device)


def parsed_queries(snap, db, n: int, phrase_every: int, seed: int = 1) -> list:
    from spaghettisearch_tpu_torch.corpus import bench_queries
    from spaghettisearch_tpu_torch.retrieval.engine import parse_query

    return [parse_query(x) for x in bench_queries(snap, n, seed=seed, phrase_every=phrase_every,
                                                  db=db)]


def mixed_batch(snap, idx, parsed: list, q: int = 4, p: int = 16) -> dict:
    """The originals' mixed batch: keyword rows as the engine fills them
    (QueryEngine._fill_keyword_rows with the index's hot map), phrase
    slots, rows sorted phrase-first (np.lexsort((-qn, -qnb, -pn))), topics
    off; tensors on the index's device, and the row order applied
    ("perm")."""
    import torch

    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine

    b = len(parsed)
    term_ids, qlen, qn, qnb, hot_sids = QueryEngine._fill_keyword_rows(
        parsed, b, q, snap, idx.hot_body_map
    )
    ph_ids = np.full((b, p), snap.n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    pn = np.zeros(b, np.int32)
    for i, pq in enumerate(parsed):
        pids = snap.term_ids(pq.phrase_hashes)[:p]
        ph_ids[i, : len(pids)] = pids
        ph_valid[i, : len(pids)] = 1.0
        pn[i] = len(pids)
    perm = np.lexsort((-qn, -qnb, -pn))
    arrays = {"term_ids": term_ids, "qlen": qlen, "qn": qn, "qnb": qnb,
              "hot_sids": hot_sids, "ph_ids": ph_ids, "ph_valid": ph_valid, "pn": pn}
    out = {k: torch.from_numpy(np.ascontiguousarray(v[perm])).to(idx.device)
           for k, v in arrays.items()}
    out["perm"] = perm
    out["tp"] = torch.zeros((b, idx.n_categories), dtype=torch.float32, device=idx.device)
    return out


def mixed_rank(idx, batch: dict, topk: int = 50, posT=None, **kw):
    """score_queries_mixed (K2, the hot fold, finalize, top-k through
    doc_perm) on a mixed_batch(), the engine's configuration (counts as
    the index needs them); posT = (title, body) planes replaces the
    index's; kw goes to score_queries_mixed (body_tmax, tmax_stage)."""
    from spaghettisearch_tpu_torch.ops.scoring import score_queries_mixed

    tpos, bpos = posT if posT is not None else (idx.title.posT, idx.body.posT)
    return score_queries_mixed(
        idx.title.fwd, idx.body.fwd, tpos, bpos, idx.mag_title, idx.mag_body, idx.pagerank,
        batch["term_ids"], batch["qlen"], batch["tp"], batch["ph_ids"], batch["ph_valid"],
        qn=batch["qn"], pn=batch["pn"], qnb=batch["qnb"], hot_sids=batch["hot_sids"],
        hot_w=idx.hot_body_w, doc_map=idx.doc_perm, topk=topk,
        emit_counts=idx.has_zero_weight, **kw,
    )


def tensor(a, device):
    """A host array as a contiguous tensor on `device`."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def equal(a, b) -> bool:
    """Two (scores, ids) results bit for bit (-inf slots included)."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def time_host(fn, reps: int) -> float:
    """Best of reps host-clock runs of fn (which ends synchronized), ms,
    after one untimed run."""
    fn()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    """K1 and K2 launches since the last reset_launches() (K2_tmax: the K2
    launches with the body bound)."""
    from spaghettisearch_tpu_torch.ops.kernels import membership, mixed

    return {"K1": membership.LAUNCHES, "K2": mixed.LAUNCHES, "K2_tmax": mixed.LAUNCHES_TMAX}


def reset_launches() -> None:
    from spaghettisearch_tpu_torch.ops.kernels import membership, mixed

    membership.reset_launches()
    mixed.reset_launches()
