#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spaghettisearch_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases (any failure raises and the script exits non-zero):
  1. the card: name, count, `nvidia-smi` name and power limit;
  2. build: `make -C native` and the three CUDA sources of csrc/
     (membership.cu: K1 + K3, mixed.cu: K2, fused.cu: K4), all at once
     (nvcc for sm_90a; ptxas registers / shared memory / spills printed);
  3. corpus: the seeded benchmark corpus (corpus.py) written to
     build/smoke_corpus, its snapshot, and the device index;
  4. kernels vs their plain versions on the card at the main path's shapes,
     with CUDA-event times of both: K1 at B=128 with Q=4 and Q=32, both
     count variants, the hot split, the doc-sorted bound on and off; K2 at
     B=128 (Q=4, P=16) and at the serving shape B=16 (Q=4, P=4), int16 and
     f32 planes, both count variants; K1 and K2 on the adversarial batches
     that stress their probe tables (check.ADVERSARIAL, B=128), and K2 on
     log_full at B=16 too (with every_row, docs overflow K2's phrase-hit
     log: the rescan path); K3 (title and body, both count variants) and
     K4 (C=1 and C=8) on the same batches; each batch's probe tables, as
     the K1/K2/K3/K4 entry points build them, equal to their plain build;
     K3 (one section) at B=128, Q=4 and Q=32, both count variants,
     qn-sorted rows; K4 (fused) at B=128, Q=4 and Q=32, topics off (C=1)
     and a seeded C=8 blend; each kernel's bound from this run's data
     (bound_ms) and, for K1 and K3, the time of torch.sparse.mm per
     section, the library call computing the same function, held first
     against the plain version; per B=128 batch, score_queries_fused vs
     the production keyword scorer, and one custom-blend rank (two K3
     calls, phrase fold, finalize, top-k);
  5. serving: the port's SearchServer (micro-batching on) after warmup()
     answers POST /query, GET /query/{terms} and GET /wordlist/{prefix}
     from several client threads; every response must be 200 JSON, the
     ranked results must equal the plain-version path on the card (ties at
     equal scores aside), and K1 and K2 must have launched;
  6. fused ranking: score_queries_fused (K4) on a B=128 keyword batch, ids
     mapped through doc_perm, equals BlendedRanker.score_keywords top-50;
  7. a custom-blend engine (title only): the query mix through
     query_batch; keyword batches take K3, phrase batches the sparse lane;
     results equal the plain path;
  8. --ranker bm25 serving: a SearchServer over a BM25 engine answers the
     query mix from several clients, every response 200 and equal to the
     plain path; K1 launched and the sparse-lane matcher ran;
  9. the exact CSR route: an index truncated by a lowered DOC_TERM_CAP
     answers keyword and phrase queries through score_csr, equal to the
     untruncated dense plain path.
Every phase that ranks resets the launch counts before it and reads them
after. The line before the last is the kernels' JSON record; the last line
is {"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
PAGES = 100_000  # the benchmark corpus's size (bench.py build_bench_corpus)
QUERIES = 320  # POST /query requests of each serving phase
CLIENTS = 8  # concurrent HTTP client threads
#: the CSR route sums a doc's postings in scatter order, the dense path in
#: slot order: the JAX package's own bar between the two formulations
#: (tests/test_scoring_paths.py) is rel 1e-5, abs 1e-7 on scores
CSR_RTOL = 1e-5


def say(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def plain_kernels():
    """Route the scorers through the kernels' plain versions (the on-card
    reference of the ranking phases)."""
    from spaghettisearch_tpu_torch.ops.kernels import fused, membership, mixed

    saved = (membership.forward_scores_2sec, membership.forward_scores,
             mixed.mixed_scores_2sec, fused.fused_final_scores)

    def k2_plain(t_ftT, t_fwT, b_ftT, b_fwT, t_pos, b_pos, term_ids, qn, ph_ids,
                 ph_valid, pn, *, emit_counts=True, qnb=None):
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
    try:
        yield
    finally:
        (membership.forward_scores_2sec, membership.forward_scores,
         mixed.mixed_scores_2sec, fused.fused_final_scores) = saved


@contextlib.contextmanager
def count_matcher_calls():
    """Count the sparse phrase lane's matcher calls (the engine's forward
    and CSR matchers) inside the block: yields a one-element list."""
    from spaghettisearch_tpu_torch.retrieval import engine as eng_mod

    calls = [0]
    saved = eng_mod.match_phrase_fwd_batch, eng_mod.match_phrase_batch

    def counted(fn):
        def wrapper(*a, **k):
            calls[0] += 1
            return fn(*a, **k)
        return wrapper

    eng_mod.match_phrase_fwd_batch, eng_mod.match_phrase_batch = map(counted, saved)
    try:
        yield calls
    finally:
        eng_mod.match_phrase_fwd_batch, eng_mod.match_phrase_batch = saved


def reset_launches() -> None:
    from spaghettisearch_tpu_torch.ops.kernels import fused, membership, mixed

    for mod in (membership, mixed, fused):
        mod.reset_launches()


def launches() -> dict:
    from spaghettisearch_tpu_torch.ops.kernels import fused, membership, mixed

    return {"membership": membership.LAUNCHES, "mixed": mixed.LAUNCHES,
            "membership_1sec": membership.LAUNCHES_1SEC, "fused": fused.LAUNCHES}


def same_results(got: list[dict], want: list[dict], rtol: float = 1e-6) -> bool:
    """Equal ranked lists up to ties: every position's FinalRank within
    rtol relative of the reference's, and where the Urls differ the scores
    tie (bench.py --mode parity's rule, extended to the k-th cut)."""
    if len(got) != len(want):
        return False
    ref = {r["Url"]: r["FinalRank"] for r in want}
    tol = lambda a, b: abs(a - b) <= rtol * max(abs(b), 1e-9)  # noqa: E731
    for g, w in zip(got, want):
        if not tol(g["FinalRank"], w["FinalRank"]):
            return False
        if g["Url"] != w["Url"]:
            s = ref.get(g["Url"], want[-1]["FinalRank"])
            if not tol(s, w["FinalRank"]):
                return False
        for key in ("Page_title", "Summary", "Children", "Parents", "Words_mapping"):
            if g["Url"] == w["Url"] and g[key] != w[key]:
                return False
    return True


def same_topk(got_s, got_i, want_s, want_i, rtol: float, atol: float) -> bool:
    """Equal [B, K] top-k rows up to ties: scores position by position
    within rtol/atol (-inf where the reference has -inf), and where the ids
    differ the got id's reference score ties the reference's score there
    (the k-th score for an id the reference did not rank)."""
    import numpy as np

    got_s, got_i, want_s, want_i = (np.asarray(x.cpu()) for x in (got_s, got_i, want_s, want_i))
    if got_s.shape != want_s.shape:
        return False
    for gs, gi, ws, wi in zip(got_s, got_i, want_s, want_i):
        fin = np.isfinite(ws)
        if not np.array_equal(np.isfinite(gs), fin):
            return False
        if not np.allclose(gs[fin], ws[fin], rtol=rtol, atol=atol):
            return False
        ref = dict(zip(wi[fin].tolist(), ws[fin].tolist()))
        last = ws[fin][-1] if fin.any() else 0.0
        for g, w, s in zip(gi[fin], wi[fin], ws[fin]):
            if g != w and abs(ref.get(int(g), last) - s) > atol + rtol * abs(s):
                return False
    return True


def check_ranked(queries: list[str], got: list[list[dict]], want: list[list[dict]],
                 what: str, rtol: float = 1e-6) -> int:
    """Every ranked list well-formed and equal to the reference's. -> the
    number of results."""
    n_hits = 0
    for q, g, w in zip(queries, got, want):
        n_hits += len(g)
        ranks = [r["FinalRank"] for r in g]
        if ranks != sorted(ranks, reverse=True) or not all(
            isinstance(x, float) and x == x and abs(x) != float("inf") for x in ranks
        ):
            raise RuntimeError(f"{what}: bad FinalRank order/values for {q!r}")
        if not same_results(g, w, rtol):
            raise RuntimeError(f"{what}: results differ from the plain path for {q!r}")
    return n_hits


def send_jobs(base: str, jobs: list[tuple[str, str]], clients: int) -> tuple[dict, float]:
    """Send `jobs` ((kind, arg): post / get / wordlist) to the server at
    `base` from `clients` threads. Raises the first client error, and
    unless every response is 200. -> ({(kind, arg): (status, body,
    seconds)}, wall seconds)."""
    results: dict[tuple[str, str], tuple[int, object, float]] = {}
    lock = threading.Lock()
    errors: list[BaseException] = []

    def fetch(kind: str, arg: str) -> None:
        t = time.perf_counter()
        if kind == "post":
            req = urllib.request.Request(
                base + "/query", data=json.dumps({"query": arg}).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
        elif kind == "get":
            req = base + "/query/" + urllib.parse.quote(arg)
        else:
            req = base + "/wordlist/" + urllib.parse.quote(arg)
        with urllib.request.urlopen(req, timeout=300) as r:
            status, body = r.status, json.loads(r.read())
        with lock:
            results[(kind, arg)] = (status, body, time.perf_counter() - t)

    def client(part: list[tuple[str, str]]) -> None:
        try:
            for job in part:
                fetch(*job)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(jobs[i::clients],)) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if not all(v[0] == 200 for v in results.values()):
        raise RuntimeError("a request did not answer 200")
    return results, wall


def http_burst(engine, jobs: list[tuple[str, str]], clients: int) -> tuple[dict, float]:
    """Serve `engine` through the port's SearchServer (micro-batching on)
    and send_jobs(jobs, clients) to it."""
    from spaghettisearch_tpu_torch.serve.server import SearchServer

    server = SearchServer(engine, batching=True)
    host, port = server.start_background(port=0)
    try:
        return send_jobs(f"http://{host}:{port}", jobs, clients)
    finally:
        server.shutdown()


def latency_stats(results: dict, n: int, wall: float) -> dict:
    """n requests answered in `wall` seconds: req/s, and the POST
    latencies' p50 and p99 (host clock)."""
    lat = sorted(v[2] for k, v in results.items() if k[0] == "post")
    return {"requests": n, "req_per_s": n / wall, "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[int(len(lat) * 0.99)]}


def latency_line(results: dict, n: int, wall: float) -> str:
    st = latency_stats(results, n, wall)
    return (f"{n} POST /query from {CLIENTS} clients in {wall:.3f}s = {st['req_per_s']:.1f} "
            f"req/s; latency p50 {st['p50_ms']:.2f} ms, p99 {st['p99_ms']:.2f} ms")


#: the H100 SXM's data-sheet rates at 700 W: memory bytes/s, and float32
#: operations/s outside the tensor cores (the rate the probe's integer and
#: f32 work is held to)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def row_terms(batch: dict, section: str, phrases: bool = False) -> list[set]:
    """Per row, the distinct query terms a section's sweep matches: the
    keyword columns below the row's active count (qnb for the body under
    the hot split, qn otherwise), and with `phrases` the row's valid phrase
    terms. Unknown words (n_words) match no slot and may stay."""
    tq = batch["term_ids"].cpu().numpy()
    cold = batch["split"] and section == "body"
    active = (batch["qnb"] if cold else batch["qn"]).cpu().numpy()
    rows = [{int(t) for t in tq[i, : active[i]] if t >= 0} for i in range(len(tq))]
    if phrases:
        ids, valid = batch["ph_ids"].cpu().numpy(), batch["ph_valid"].cpu().numpy()
        for i, r in enumerate(rows):
            r.update(int(t) for t, v in zip(ids[i], valid[i]) if v > 0 and t >= 0)
    return rows


def bound_ms(index, sweeps: list, b: int, n_out: int, extra_bytes: int = 0) -> tuple[float, str]:
    """The least time the card could take for a membership call at batch b
    on this run's data: the larger of its bytes over the memory rate and
    its operations over the peak rate. `sweeps` holds (ftT, row_terms) per
    section swept. Bytes: the term id (4 B) of every real slot, the weight
    (4 B) of each slot whose term some row asks for, each of the n_out f32
    [b, D] outputs written once, and extra_bytes. Operations: one
    membership test per real slot, one multiply-add (2) per (slot, row)
    match. -> (ms, "bytes" or "operations")."""
    import torch

    slots = hits = pairs = 0
    for ftT, rows in sweeps:
        real = ftT[ftT >= 0].long()
        slots += real.numel()
        occ = torch.bincount(real, minlength=index.n_words + 1).cpu().numpy()
        hits += int(occ[sorted(set().union(*rows))].sum())
        pairs += sum(int(occ[sorted(r)].sum()) for r in rows)
    nbytes = 4 * slots + 4 * hits + n_out * b * index.n_docs_padded * 4 + extra_bytes
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * (slots + 2 * pairs) / PEAK_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def library_calls(idx, n_words: int, batch: dict, want: list,
                  sections=("title", "body")) -> list:
    """The operands of torch.sparse.mm(W, M) per section, the one PyTorch
    call that computes the membership scores (and counts, with a W of
    ones): W the CSR [D, V+1] doc-term weight matrix from the forward
    tiles (each doc's columns sorted), M the dense [V+1, B]
    query-multiplicity matrix of the columns the section's sweep reads
    (row_terms' rule); sparse.mm(W, M)[d, b] is score[b, d]. Built outside
    the timed region. `want` holds the plain version's (score, count or
    None) per section: each call's result is held against it (scores
    within check.RTOL, counts exact) before it is timed, and a
    disagreement raises."""
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check

    b, q = batch["term_ids"].shape
    big = torch.iinfo(torch.int32).max
    calls = []
    for sec, (w_score, w_count) in zip(sections, want):
        fwd = getattr(idx, sec).fwd
        ft, order = torch.where(fwd.ftT >= 0, fwd.ftT, big).t().sort(dim=1)
        fw = fwd.fwT.t().gather(1, order)
        real = ft != big
        crow = torch.zeros(ft.shape[0] + 1, dtype=torch.int64, device=ft.device)
        crow[1:] = real.sum(1).cumsum(0)
        cold = batch["split"] and sec == "body"
        active = batch["qnb"] if cold else batch["qn"]
        col = torch.arange(q, device=ft.device)[None, :]
        tq = torch.where(col < active[:, None], batch["term_ids"].long(), n_words)
        m = torch.zeros((n_words + 1, b), dtype=torch.float32, device=ft.device)
        m.index_put_((tq.clamp(min=0, max=n_words).flatten(),
                      torch.arange(b, device=ft.device).repeat_interleave(q)),
                     torch.ones(b * q, device=ft.device), accumulate=True)
        m[n_words] = 0.0  # unknown words and inactive columns
        for w, ref, what in ((fw[real], w_score, "scores"),
                             (torch.ones_like(fw[real]), w_count, "counts")):
            if ref is None:
                continue
            mat = torch.sparse_csr_tensor(crow, ft[real].long(), w, size=(ft.shape[0], n_words + 1))
            got = torch.sparse.mm(mat, m).t()
            same = (torch.equal(got, ref) if what == "counts"
                    else bool(torch.isclose(got, ref, rtol=check.RTOL, atol=0.0).all()))
            if not same:
                err = float((got - ref).abs().max())
                raise RuntimeError(f"torch.sparse.mm {sec} {what} differ from the plain "
                                   f"version (max abs err {err})")
            calls.append((mat, m))
    return calls


def build_all() -> list:
    """`make -C native` and one nvcc per CUDA source, all started together."""
    from spaghettisearch_tpu_torch.ops.kernels import fused, membership, mixed

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as ex:
        native = ex.submit(subprocess.run, ["make", "-C", os.path.join(HERE, "native"), "-s"],
                           check=True)
        libs = [ex.submit(mod.library) for mod in (membership, mixed, fused)]
        native.result()
        built = [f.result() for f in libs]
    say(f"# native libraries and kernels built in {time.perf_counter() - t0:.1f}s")
    for lib in built:
        say(f"# kernel {os.path.relpath(lib.path, HERE)} built in {lib.seconds:.1f}s (sm_90a):")
        for line in lib.log.splitlines():
            if re.search(r"Compiling entry|registers|spill|smem|Function properties", line):
                say("#   " + line.strip())
    return built


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="corpus and query seed")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from spaghettisearch_tpu_torch.corpus import make_queries, write_corpus
    from spaghettisearch_tpu_torch.index.snapshot import build_snapshot
    from spaghettisearch_tpu_torch.models.blended import BlendedRanker
    from spaghettisearch_tpu_torch.models.bm25 import BM25Ranker
    from spaghettisearch_tpu_torch.ops import scoring
    from spaghettisearch_tpu_torch.ops.kernels import check, mixed
    from spaghettisearch_tpu_torch.retrieval import device_index
    from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine, parse_query

    t_start = time.perf_counter()
    # 1. the card
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"# device: {name} (count {count}); torch {torch.__version__}, CUDA {torch.version.cuda}")
    say(smi)

    # 2. build
    build_all()

    # 3. corpus + index
    t0 = time.perf_counter()
    root = os.path.join(HERE, "build", "smoke_corpus")
    shutil.rmtree(root, ignore_errors=True)
    db = write_corpus(root, n_pages=PAGES, seed=args.seed, log=lambda m: say(f"# corpus: {m}"))
    snap = build_snapshot(db)
    t_corpus = time.perf_counter() - t0
    engine = QueryEngine(db, snapshot=snap, device="cuda")
    idx = engine.index
    torch.cuda.synchronize()
    nt = (idx.body.fwd.ftT >= 0).sum(dim=0)[: idx.n_docs].float()
    say(
        f"# corpus: {snap.n_docs} docs, {snap.n_words} words, "
        f"{snap.body.n_postings} body + {snap.title.n_postings} title postings "
        f"in {t_corpus:.1f}s; index built in {time.perf_counter() - t0 - t_corpus:.1f}s"
    )
    say(
        f"# index: D_pad {idx.n_docs_padded}, body T {idx.body.fwd.ftT.shape[0]} "
        f"(distinct terms/doc mean {float(nt.mean()):.1f}, p50 {float(nt.median()):.0f}, "
        f"max {int(nt.max())}), title T {idx.title.fwd.ftT.shape[0]}, "
        f"doc_sort {idx.doc_perm is not None}, hot terms "
        f"{0 if idx.hot_body_map is None else len(idx.hot_body_map)}, posT C "
        f"{idx.title.pos_c}/{idx.body.pos_c} {str(idx.body.posT.dtype)}, "
        f"posting_cap {idx.posting_cap}, pos_cap {idx.pos_cap}, pos_mat "
        f"{idx.title.pos_mat is not None}/{idx.body.pos_mat is not None}, "
        f"zero weights {idx.has_zero_weight}, device bytes {idx.device_bytes()}"
    )

    # 4. kernels vs plain versions on the card
    t0 = time.perf_counter()
    df = snap.body.df(range(snap.n_words)).astype("float64")
    records = {"membership": [], "mixed": [], "membership_1sec": [], "fused": []}
    main_counts = idx.has_zero_weight  # the engine's emit_counts
    doc_sort = idx.body.tmax_blocks is not None
    idx32 = dataclasses.replace(idx, **{  # the f32 planes a pathological corpus keeps
        sec: dataclasses.replace(getattr(idx, sec),
                                 posT=mixed.deq_posT(getattr(idx, sec).posT).contiguous())
        for sec in ("title", "body")
    })

    def held(kname: str, rep: dict, what: str) -> None:
        say(f"# {what}: {rep}")
        if not rep["ok"]:
            raise RuntimeError(f"{kname} kernel disagrees with its plain version: {rep}")
        records[kname].append(rep)

    def hold_tables(batch, what: str, one: str | None = None) -> None:
        for phrases in (False, True) if "ph_ids" in batch and one is None else (False,):
            if not check.tables_agree(batch, phrases, one=one):
                raise RuntimeError(f"the probe tables of {what} (phrases={phrases}, {one or 'K1/K2'}) "
                                   "differ from their plain version")
        say(f"# probe tables {what} ({one or 'K1/K2'}): equal to the plain build")

    def hold_k1(batch, what: str) -> None:
        hold_tables(batch, what)
        for emit in (True, False):
            for tmax in sorted({doc_sort, False}):
                got = check.run_k1(idx, batch, emit, body_tmax=tmax)
                want = check.run_k1(idx, batch, emit, body_tmax=tmax, plain=True)
                held("membership", check.compare(got, want),
                     f"K1 {what} counts={emit} split={batch['split']} tmax={tmax}")

    def hold_k2(index, batch, what: str, emits=(True, False)) -> None:
        hold_tables(batch, what)
        for emit in emits:
            got = check.run_k2(index, batch, emit)
            want = check.run_k2(index, batch, emit, plain=True)
            held("mixed", check.compare(got, want),
                 f"K2 {what} counts={emit} planes={index.body.posT.dtype}")

    for q in (4, 32):
        hold_k1(check.to_device(check.keyword_batch(idx, 128, q, seed=q, df=df), "cuda"),
                f"B=128 Q={q}")
    mbatch = check.to_device(
        check.mixed_batch(idx, 128, 4, 16, seed=1, df=df, snap=snap), "cuda"
    )
    mbatch16 = check.to_device(  # the serving shape: B=16, P=P_BASE
        check.mixed_batch(idx, 16, 4, 4, seed=2, df=df, snap=snap), "cuda"
    )

    def hold_k3(batch, what: str) -> None:
        hold_tables(batch, what, one="K3")
        for section in ("title", "body"):
            for emit in (True, False):
                got = check.run_k3(idx, batch, emit, section)
                want = check.run_k3(idx, batch, emit, section, plain=True)
                held("membership_1sec", check.compare_section(got, want),
                     f"K3 {section} {what} counts={emit}")

    def hold_k4(batch, what: str) -> None:
        hold_tables(batch, what, one="K4")
        for c in (1, 8):
            inputs = check.fused_inputs(idx, batch, c, seed=c)
            got = check.run_k4(idx, batch, inputs)
            want = check.run_k4(idx, batch, inputs, plain=True)
            held("fused", check.compare_final(got, want), f"K4 {what} C={c}")

    for index in (idx, idx32):
        hold_k2(index, mbatch, "B=128 Q=4 P=16")
        hold_k2(index, mbatch16, "B=16 Q=4 P=4")
    for kind in check.ADVERSARIAL:  # batches that stress the probe tables
        batch = check.to_device(
            check.adversarial_batch(idx, kind, seed=7, df=df, snap=snap, b=128), "cuda"
        )
        b, q = batch["term_ids"].shape
        hold_k1(batch, f"adversarial {kind} B={b} Q={q}")
        hold_k2(idx, batch, f"adversarial {kind} B={b} Q={q} P=4")
        hold_k3(batch, f"adversarial {kind} B={b} Q={q}")
        hold_k4(batch, f"adversarial {kind} B={b} Q={q}")
    # every_row and log_full at B=128 (above) and log_full at the serving
    # shape give docs more phrase hits in a section than K2's log keeps:
    # the rescan path
    full16 = check.to_device(
        check.adversarial_batch(idx, "log_full", seed=8, df=df, snap=snap, b=16), "cuda"
    )
    hold_k2(idx, full16, "adversarial log_full B=16 Q=4 P=4")
    for q in (4, 32):
        batch = check.to_device(check.keyword_batch(idx, 128, q, seed=q + 1, df=df, split=False),
                                "cuda")
        if not bool((batch["qn"][:-1] >= batch["qn"][1:]).all()):
            raise RuntimeError("K3 batch rows are not qn-sorted")
        hold_k3(batch, f"B=128 Q={q} qn-sorted")
        hold_k4(batch, f"B=128 Q={q}")
    kbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df), "cuda")
    cbatch = check.to_device(check.keyword_batch(idx, 128, 4, seed=4, df=df, split=False), "cuda")
    k4_in = check.fused_inputs(idx, cbatch, 1, seed=1)
    times = {
        "membership": (
            check.time_ms(lambda: check.run_k1(idx, kbatch, main_counts, doc_sort)),
            check.time_ms(lambda: check.run_k1(idx, kbatch, main_counts, doc_sort, plain=True), iters=5),
        ),
        "mixed": (
            check.time_ms(lambda: check.run_k2(idx, mbatch, main_counts)),
            check.time_ms(lambda: check.run_k2(idx, mbatch, main_counts, plain=True), iters=3, warmup=1),
        ),
    }
    k2_b16 = (
        check.time_ms(lambda: check.run_k2(idx, mbatch16, main_counts)),
        check.time_ms(lambda: check.run_k2(idx, mbatch16, main_counts, plain=True), iters=3,
                      warmup=1),
    )
    variants = {}  # K3 and K4 per variant at B=128, Q=4, qn-sorted rows
    for section in ("title", "body"):
        for emit in (True, False):
            variants[f"K3 {section} counts={emit}"] = (
                check.time_ms(lambda: check.run_k3(idx, cbatch, emit, section)),
                check.time_ms(lambda: check.run_k3(idx, cbatch, emit, section, plain=True),
                              iters=5),
            )
    for c in (1, 8):
        inputs = k4_in if c == 1 else check.fused_inputs(idx, cbatch, c, seed=c)
        variants[f"K4 C={c}"] = (
            check.time_ms(lambda: check.run_k4(idx, cbatch, inputs)),
            check.time_ms(lambda: check.run_k4(idx, cbatch, inputs, plain=True), iters=5),
        )
    for what, (ms, plain_ms) in variants.items():
        say(f"# {what} B=128 Q=4: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({smi})")
    # the kernels line: the custom-blend route's K3 variant, K4 topics off
    times["membership_1sec"] = variants["K3 body counts=True"]
    times["fused"] = variants["K4 C=1"]
    for kname, (ms, plain_ms) in times.items():
        say(f"# {kname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per B=128 call ({smi})")
    say(f"# mixed B=16 Q=4 P=4 (the serving shape): kernel {k2_b16[0]:.4f} ms, plain "
        f"{k2_b16[1]:.4f} ms per call ({smi})")
    k1_want = check.run_k1(idx, kbatch, main_counts, doc_sort, plain=True)
    lib_k1 = library_calls(idx, snap.n_words, kbatch, [k1_want[:2], k1_want[2:]])
    lib_k3 = library_calls(idx, snap.n_words, cbatch,
                           [check.run_k3(idx, cbatch, True, "body", plain=True)],
                           sections=("body",))
    say("# library calls equal the plain versions (K1: title + body; K3: body, with counts)")
    library = {  # one PyTorch call per section for the same function (yardstick only)
        "membership": check.time_ms(lambda: [torch.sparse.mm(w, m) for w, m in lib_k1]),
        "membership_1sec": check.time_ms(lambda: [torch.sparse.mm(w, m) for w, m in lib_k3]),
        "mixed": None,  # no single call: phrase chains over position planes
        "fused": None,  # no single call: membership, cosine normalisation and blend in one
    }
    secs = ("title", "body")
    n_k = 4 if main_counts else 2

    def sweeps(batch, sections=secs, phrases=False):
        return [(getattr(idx, s).fwd.ftT, row_terms(batch, s, phrases)) for s in sections]

    bounds = {
        "membership": bound_ms(idx, sweeps(kbatch), 128, n_k),
        "mixed": bound_ms(idx, sweeps(mbatch, phrases=True), 128, n_k),
        "membership_1sec": bound_ms(idx, sweeps(cbatch, ("body",)), 128, 2),
        "fused": bound_ms(idx, sweeps(cbatch), 128, 1, extra_bytes=4 * idx.n_docs_padded * 3),
    }
    k2_b16_bound = bound_ms(idx, sweeps(mbatch16, phrases=True), 16, n_k)
    say(f"# bounds (ms, what sets them; 4 B per real slot, 4 B per slot a row asks for, "
        f"each output once, over 3.35 TB/s): {bounds}; mixed B=16 {k2_b16_bound}")
    say(f"# library (torch.sparse.mm per section): {library}")
    qlen = kbatch["qn"].clamp(min=1).to(torch.float32)
    tp0 = torch.zeros((128, idx.n_categories), device="cuda")
    model = engine.model

    def rank_fused():
        return scoring.score_queries_fused(
            idx.title.fwd, idx.body.fwd, idx.mag_title, idx.mag_body, idx.pagerankT,
            kbatch["term_ids"], qlen, tp0, topk=50,
        )

    def rank_forward():
        return model.score_keywords(
            idx, kbatch["term_ids"], qlen, tp0, topk=50, qn=kbatch["qn"],
            qnb=kbatch["qnb"], hot_sids=kbatch["hot_sids"],
        )

    title_only = BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0)
    qlen_c = cbatch["qn"].clamp(min=1).to(torch.float32)

    def rank_custom():  # the custom-blend route's keyword rank
        return title_only._custom_forward(idx, cbatch["term_ids"], qlen_c, tp0, 50, qn=cbatch["qn"])

    fused_ms, forward_ms = check.time_ms(rank_fused), check.time_ms(rank_forward)
    custom_ms = check.time_ms(rank_custom)
    say(f"# score_queries_fused {fused_ms:.4f} ms vs score_queries_forward (production "
        f"keyword scorer: K1, hot split, finalize, top-k) {forward_ms:.4f} ms per B=128 "
        f"batch ({smi})")
    say(f"# custom-blend rank (two K3 calls with counts, phrase fold, finalize, top-k) "
        f"{custom_ms:.4f} ms per B=128 batch ({smi}); kernel phase "
        f"{time.perf_counter() - t0:.1f}s")
    phase_launches = {}

    # 5. serving through the port's HTTP front end (the reference blend)
    t0 = time.perf_counter()
    engine.warmup()
    n_hyd = engine.prewarm_hydration()
    engine.prewarm_wordlist()
    say(f"# warmup + hydration prewarm ({n_hyd} records) in {time.perf_counter() - t0:.1f}s")
    queries = make_queries(snap, db, QUERIES, seed=args.seed + 1)
    kw_only = [q for q in queries if '"' not in q][:32]
    prefixes = ["w0", "w00", "w001", "w12", "w2", "zz"]
    reset_launches()
    results, t_post = http_burst(engine, [("post", q) for q in queries], CLIENTS)
    # one client, one request at a time: single-row keyword batches (K1)
    results.update(http_burst(
        engine, [("get", q) for q in kw_only] + [("wordlist", p) for p in prefixes], 1
    )[0])
    phase_launches["serving"] = launches()
    say(f"# serving: {len(results)} responses; kernel launches {phase_launches['serving']}")
    say(f"# serving: {latency_line(results, len(queries), t_post)}")
    if min(phase_launches["serving"][k] for k in ("membership", "mixed")) == 0:
        raise RuntimeError(f"a kernel of the main path never launched: {phase_launches}")
    for pre in prefixes:
        words = results[("wordlist", pre)][1]
        if not isinstance(words, list) or not all(w.startswith(pre) for w in words):
            raise RuntimeError(f"/wordlist/{pre} answered {words!r:.200}")
    ref_q = queries + kw_only
    with plain_kernels():
        ref = engine.query_batch(ref_q)
    got = [results[("post", q)][1] for q in queries] + [results[("get", q)][1] for q in kw_only]
    n_hits = check_ranked(ref_q, got, ref, "serving")
    say(f"# serving: all {len(ref_q)} ranked responses equal the plain path ({n_hits} results)")

    # 6. fused ranking (K4) vs the production keyword scorer
    reset_launches()
    fs, fi = rank_fused()
    phase_launches["fused_rank"] = launches()
    ws, wi = rank_forward()
    if idx.doc_perm is not None:  # the fused path returns permuted-space ids
        fi = idx.doc_perm[fi.long()]
    if not same_topk(fs, fi, ws, wi, rtol=1e-5, atol=1e-6):
        raise RuntimeError("score_queries_fused disagrees with score_keywords top-50")
    say(f"# fused ranking: B=128 top-50 equals score_keywords (ids through doc_perm, "
        f"{int(torch.isfinite(ws).sum())} ranked); launches {phase_launches['fused_rank']}")

    # 7. a custom-blend engine (kernel K3; phrases on the sparse lane)
    t0 = time.perf_counter()
    custom = QueryEngine(db, snapshot=snap, index=idx, device="cuda",
                         model=BlendedRanker(w_pagerank=0.0, w_title=1.0, w_body=0.0))
    custom.warmup()
    reset_launches()
    with count_matcher_calls() as matcher:
        got_kw = custom.query_batch(kw_only)
        kw_launches = launches()
        got = custom.query_batch(queries)
    phase_launches["custom_blend"] = launches()
    if kw_launches["membership_1sec"] == 0 or kw_launches["membership"] or matcher[0] == 0:
        raise RuntimeError(f"custom blend routes: keyword {kw_launches}, "
                           f"all {phase_launches['custom_blend']}, matcher calls {matcher[0]}")
    with plain_kernels():
        ref = custom.query_batch(kw_only + queries)
    n_hits = check_ranked(kw_only + queries, got_kw + got, ref, "custom blend")
    say(f"# custom blend: {len(kw_only) + len(queries)} queries equal the plain path "
        f"({n_hits} results); launches {phase_launches['custom_blend']}, sparse-lane "
        f"matcher calls {matcher[0]}; {time.perf_counter() - t0:.1f}s")

    # 8. --ranker bm25 serving (K1 over BM25 tiles; every phrase on the sparse lane)
    t0 = time.perf_counter()
    bm25 = QueryEngine(db, snapshot=snap, index=idx, device="cuda", model=BM25Ranker())
    bm25.warmup()
    bm25.prewarm_hydration()
    say(f"# bm25: engine + warmup in {time.perf_counter() - t0:.1f}s")
    reset_launches()
    with count_matcher_calls() as matcher:
        results, wall = http_burst(bm25, [("post", q) for q in queries], CLIENTS)
    phase_launches["bm25_serving"] = launches()
    say(f"# bm25 serving: {latency_line(results, len(queries), wall)}; launches "
        f"{phase_launches['bm25_serving']}, sparse-lane matcher calls {matcher[0]}")
    if phase_launches["bm25_serving"]["membership"] == 0 or matcher[0] == 0:
        raise RuntimeError("bm25 serving did not run K1 and the sparse lane")
    with plain_kernels():
        ref = bm25.query_batch(queries)
    n_hits = check_ranked(queries, [results[("post", q)][1] for q in queries], ref, "bm25")
    say(f"# bm25 serving: all {len(queries)} responses equal the plain path ({n_hits} results)")

    # 9. the exact CSR route on a truncated index
    t0 = time.perf_counter()
    nt_np = nt.cpu().numpy()
    cap = int(sorted(nt_np)[-3]) - 1  # at least three docs past the cap
    saved_cap = device_index.DOC_TERM_CAP
    device_index.DOC_TERM_CAP = cap
    try:
        trunc = QueryEngine(db, snapshot=snap, device="cuda")
    finally:
        device_index.DOC_TERM_CAP = saved_cap
    if not trunc.index.dense_truncated:
        raise RuntimeError(f"DOC_TERM_CAP={cap} did not truncate the index")
    csr_calls = [0]
    score_csr = BlendedRanker.score_csr

    def counted_csr(*a, **k):
        csr_calls[0] += 1
        return score_csr(*a, **k)

    csr_q = kw_only + queries[:128]
    reset_launches()
    BlendedRanker.score_csr = counted_csr
    try:
        with count_matcher_calls() as matcher:
            got = trunc.query_batch(kw_only) + trunc.query_batch(queries[:128])
    finally:
        BlendedRanker.score_csr = score_csr
    phase_launches["csr"] = launches()
    if csr_calls[0] < 2 or matcher[0] == 0 or any(phase_launches["csr"].values()):
        raise RuntimeError(f"CSR route: score_csr calls {csr_calls[0]}, matcher calls "
                           f"{matcher[0]}, launches {phase_launches['csr']}")
    with plain_kernels():
        ref = engine.query_batch(csr_q)
    n_hits = check_ranked(csr_q, got, ref, "CSR route", rtol=CSR_RTOL)
    say(f"# CSR route: DOC_TERM_CAP {cap} truncates {int((nt_np > cap).sum())} docs; "
        f"{len(csr_q)} queries through score_csr ({csr_calls[0]} calls, {matcher[0]} CSR "
        f"matcher calls) equal the dense plain path ({n_hits} results); "
        f"{time.perf_counter() - t0:.1f}s")
    say(f"# smoke took {time.perf_counter() - t_start:.1f}s")

    kernels = []
    for kname, src, rep_line, path in (
        ("membership", "membership.cu", "spaghettisearch_tpu/ops/kernels/membership.py:274",
         "serving"),
        ("mixed", "mixed.cu", "spaghettisearch_tpu/ops/kernels/mixed.py:514", "serving"),
        ("membership_1sec", "membership.cu",
         "spaghettisearch_tpu/ops/kernels/membership.py:322", "custom_blend"),
        ("fused", "fused.cu", "spaghettisearch_tpu/ops/kernels/fused.py:111", "fused_rank"),
    ):
        n = phase_launches[path][kname]
        if n == 0:
            raise RuntimeError(f"{kname} never launched on its ranked path ({path})")
        kernels.append({
            "name": kname,
            "route": "cuda",
            "source": f"spaghettisearch_tpu_torch/csrc/{src}",
            "replaces": rep_line,
            "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in records[kname]),
            "ms": times[kname][0],
            "plain_ms": times[kname][1],
            "bound_ms": bounds[kname][0],
            "bound_by": bounds[kname][1],
            "library_ms": library[kname],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
