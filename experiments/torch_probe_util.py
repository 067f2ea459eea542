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
import contextlib
import functools
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


@contextlib.contextmanager
def plain_kernels():
    """Route the scorers through the kernels' plain versions (the on-card
    reference of an exactness check): K1, K2, K3, K4 and the finalize."""
    from spaghettisearch_tpu_torch.ops.kernels import finalize, fused, membership, mixed

    saved = (membership.forward_scores_2sec, membership.forward_scores,
             mixed.mixed_scores_2sec, fused.fused_final_scores, finalize.finalize_chunked)

    def k2_plain(t_ftT, t_fwT, b_ftT, b_fwT, t_pos, b_pos, term_ids, qn, ph_ids,
                 ph_valid, pn, *, emit_counts=True, qnb=None, body_tmax=None,
                 tmax_stage="kw"):
        out = mixed.plain_mixed_scores(
            t_ftT, t_fwT, b_ftT, b_fwT, t_pos, b_pos, term_ids, ph_ids, ph_valid, qnb=qnb
        )
        return out if emit_counts else (out[0], None, out[2], None)

    def k3_plain(ftT, fwT, term_ids, qn=None, *, emit_counts=True):
        s, c = membership.plain_section_scores(ftT, fwT, term_ids)
        return s, (c if emit_counts else None)

    membership.forward_scores_2sec = membership.plain_forward_scores_2sec
    membership.forward_scores = k3_plain
    mixed.mixed_scores_2sec = k2_plain
    fused.fused_final_scores = fused.plain_fused_final_scores
    finalize.finalize_chunked = finalize.plain_finalize_chunked
    try:
        yield
    finally:
        (membership.forward_scores_2sec, membership.forward_scores,
         mixed.mixed_scores_2sec, fused.fused_final_scores, finalize.finalize_chunked) = saved


@functools.lru_cache(maxsize=None)
def _spin_cycles_per_ms(index: int) -> float:
    """Clock cycles of torch.cuda._sleep per ms on card `index` (measured)."""
    import torch

    with torch.cuda.device(index):
        torch.cuda._sleep(1_000_000)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        return 20_000_000 / start.elapsed_time(end)


def _graph_error(exc: BaseException) -> str:
    """An exception during CUDA-graph capture and the innermost call of
    this repository it passed through (the call that broke the capture)."""
    import traceback

    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if f.filename.startswith(REPO) and "torch_probe_util" not in f.filename]
    where = (f"{os.path.relpath(frames[-1].filename, REPO)}:{frames[-1].lineno} "
             f"`{frames[-1].line}`") if frames else "outside this repository"
    return f"{type(exc).__name__}: {str(exc).splitlines()[0] if str(exc) else ''} (at {where})"


def capture_graph(fns, device):
    """Capture the thunks `fns`, one after another, into one CUDA graph
    (after a warm run on a side stream, as torch.cuda.graph asks). -> (the
    graph, the outputs it writes on each replay), or (None, the capture's
    error, see _graph_error)."""
    import torch

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            for fn in fns:
                fn()
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs = [fn() for fn in fns]
    except RuntimeError as exc:
        torch.cuda.synchronize(device)
        return None, _graph_error(exc)
    return graph, outs


def timed_ways(fns, device, reps: int) -> tuple[dict, list, str | None]:
    """One batch's program per thunk in `fns` (each returns a tuple of
    tensors), timed five ways, each best of `reps`, in ms per batch:
      queued        the N calls back to back, one synchronization, host wall;
      serial        each call synchronized before the next, host wall;
      dispatch_only the host wall of the same N calls before that
                    synchronization (what the host pays to queue a batch);
      device_only   CUDA events around each call, queued behind a spin
                    kernel that holds the stream until the host has queued
                    the call, so no host gap enters (the card's counterpart
                    of a chain of batches inside one compiled program; None
                    if a hold ended first);
      graph         one replay of a CUDA graph of the N calls.
    device_only and graph are None on the CPU; graph is None when capture
    fails, and the third value then says which call broke it. -> (ms, the
    outputs of each way {name: list per batch}, the capture error)."""
    import torch

    n = len(fns)
    on_card = torch.device(device).type == "cuda"
    outs: dict[str, list] = {}
    for fn in fns:  # warm
        fn()
    sync(device)
    best = {"queued": float("inf"), "dispatch_only": float("inf")}
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        got = [fn() for fn in fns]
        t1 = time.perf_counter()
        sync(device)
        t2 = time.perf_counter()
        best["queued"] = min(best["queued"], (t2 - t0) / n)
        best["dispatch_only"] = min(best["dispatch_only"], (t1 - t0) / n)
        outs["queued"] = got
    ms = {k: v * 1e3 for k, v in best.items()}
    serial = float("inf")
    for _ in range(max(reps, 1)):
        got = []
        t0 = time.perf_counter()
        for fn in fns:
            got.append(fn())
            sync(device)
        serial = min(serial, (time.perf_counter() - t0) / n)
        outs["serial"] = got
    ms["serial"] = serial * 1e3
    ms["device_only"] = ms["graph"] = None
    if not on_card:
        return ms, outs, None
    # each batch behind its own hold: N batches at once can overflow the
    # card's launch queue, and the host then waits for the hold to end
    hold = int((4 * ms["dispatch_only"] + 2.0) * _spin_cycles_per_ms(
        torch.device(device).index or 0))
    dev_best, held = float("inf"), True
    for _ in range(max(reps, 1)):
        events, got = [], []
        for fn in fns:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(hold)
            start.record()
            got.append(fn())
            end.record()
            held &= not start.query()  # the hold outlasted the host's queueing
            events.append((start, end))
        sync(device)
        dev_best = min(dev_best, sum(a.elapsed_time(b) for a, b in events) / n)
        outs["device_only"] = got
    ms["device_only"] = dev_best if held else None
    graph, got = capture_graph(fns, device)
    if graph is None:
        return ms, outs, got
    graph.replay()
    sync(device)
    g_best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        graph.replay()
        sync(device)
        g_best = min(g_best, (time.perf_counter() - t0) / n)
    ms["graph"] = g_best * 1e3
    outs["graph"] = got
    return ms, outs, None


def same_outputs(outs: dict) -> dict:
    """Each way's outputs of timed_ways against the queued ones, bit for
    bit. -> {way: equal}."""
    ref = outs["queued"]
    return {way: all(equal(a, b) for a, b in zip(got, ref)) for way, got in outs.items()
            if way != "queued"}


def topk_agree(got, want) -> dict:
    """Two (scores, ids) top-k results, numpy or tensors, by
    check.compare_topk: -inf slots equal, values within its rtol, ids equal
    except at tied values. -> its report ("ok", "max_abs_err", ...)."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check

    def as_t(x):
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))

    return check.compare_topk(tuple(map(as_t, got)), tuple(map(as_t, want)))


def count_uploads(eng, batch: list) -> dict:
    """The host arrays one rank_async of `batch` puts on the device (the
    engine's _to_dev calls) and their bytes."""
    from spaghettisearch_tpu_torch.retrieval import engine as eng_mod

    seen = []
    saved = eng_mod._to_dev

    def counted(x, device):
        seen.append(np.ascontiguousarray(x).nbytes)
        return saved(x, device)

    eng_mod._to_dev = counted
    try:
        eng.rank_async(batch).finish()
    finally:
        eng_mod._to_dev = saved
    return {"uploads": len(seen), "bytes": int(sum(seen))}


def same_results(got: list[dict], want: list[dict], rtol: float = 1e-6) -> bool:
    """Equal ranked result lists up to ties: every position's FinalRank
    within rtol relative of the reference's, and where the Urls differ the
    scores tie (bench.py --mode parity's rule, extended to the k-th cut);
    the other fields equal where the Urls are."""
    if len(got) != len(want):
        return False
    ref = {r["Url"]: r["FinalRank"] for r in want}

    def tol(a, b):
        return abs(a - b) <= rtol * max(abs(b), 1e-9)

    for g, w in zip(got, want):
        if not tol(g["FinalRank"], w["FinalRank"]):
            return False
        if g["Url"] != w["Url"]:
            if not tol(ref.get(g["Url"], want[-1]["FinalRank"]), w["FinalRank"]):
                return False
        else:
            for key in ("Page_title", "Summary", "Children", "Parents", "Words_mapping"):
                if g[key] != w[key]:
                    return False
    return True


def pipelined_ms(eng, batch: list, reps: int, chain: int, topk: int = 50) -> float:
    """QueryEngine.rank_async of `batch` `chain` times queued, then finish()
    each: best of reps, ms per batch on the host clock (after two untimed
    batches)."""
    for h in [eng.rank_async(batch, topk) for _ in range(2)]:
        h.finish()
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        for h in [eng.rank_async(batch, topk) for _ in range(chain)]:
            h.finish()
        best = min(best, (time.perf_counter() - t0) / chain)
    return best * 1e3
