"""Kernel-vs-plain checks at the main path's shapes.

Builds seeded query batches the way the engine lays them out (term-count
sorted rows, cold terms first under the hot split, phrase rows first in
mixed batches), runs a kernel's wrapper and its plain version on the same
tensors, and reports their agreement. Used by the GPU tests and by
chip_smoke.py; on CPU tensors both sides are the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from . import finalize as fin
from . import fused as k4
from . import fused_topk as k5
from . import membership as k1
from . import mixed as k2
from . import phrase_delta as k6
from . import probe

#: the bar the JAX package holds its kernels to against their twins
#: (tests/test_scoring_paths.py: rtol=1e-6); counts and masks are exact
RTOL = 1e-6
#: the H100 SXM's data-sheet rates at 700 W: memory bytes/s, and float32
#: operations/s outside the tensor cores (the rate the probe's integer and
#: f32 work is held to)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def keyword_batch(index, b: int, q: int, seed: int, df=None, split: bool = True) -> dict:
    """A seeded [b, q] keyword batch: 1-4 terms per row (up to q for rows
    of a catch-all batch), drawn proportional to `df` (uniform when None),
    a few unknown-word rows included; with the index's hot cache (and
    split), cold terms first and hot slots in hot_sids; rows sorted like
    engine.rank_async (by term count when there is no split)."""
    rng = np.random.default_rng(seed)
    n_words = index.n_words
    p = None if df is None else df / df.sum()
    max_terms = 4 if q <= 4 else q
    rows = []
    for i in range(b):
        n = int(rng.integers(1, max_terms + 1))
        ids = rng.choice(n_words, size=n, p=p).astype(np.int32)
        if i % 16 == 5:
            ids[0] = n_words  # unknown word: the sentinel id
        rows.append(ids.tolist())
    return rows_batch(index, rows, q, split)[0]


def rows_batch(index, rows: list[list[int]], q: int, split: bool = True,
               extra=None) -> tuple[dict, np.ndarray]:
    """A keyword batch from each row's term ids (at most q; n_words is the
    unknown-word sentinel), laid out as the engine lays it out: with the
    index's hot cache (and split), cold terms first and hot slots in
    hot_sids; rows sorted by (cold count, term count), descending, after
    `extra` ([B] keys sorted on first, descending: phrase slot counts).
    -> (batch, the row order applied)."""
    b = len(rows)
    n_words = index.n_words
    hot_map = index.hot_body_map if split else None
    term_ids = np.full((b, q), n_words, np.int32)
    qn = np.zeros(b, np.int32)
    qnb = np.zeros(b, np.int32)
    hot_sids = np.full((b, q), -1, np.int32)
    for i, ids in enumerate(rows):
        n = len(ids)
        qn[i] = n
        if hot_map is None:
            term_ids[i, :n] = ids
            qnb[i] = n
            continue
        cold = [t for t in ids if t not in hot_map]
        hots = [t for t in ids if t in hot_map]
        term_ids[i, :n] = cold + hots
        qnb[i] = len(cold)
        for j, t in enumerate(hots):
            hot_sids[i, j] = hot_map[t]
    keys = (-qn, -qnb) if extra is None else (-qn, -qnb, -extra)
    perm = np.lexsort(keys)
    return {
        "term_ids": term_ids[perm], "qn": qn[perm], "qnb": qnb[perm],
        "hot_sids": hot_sids[perm], "split": hot_map is not None,
    }, perm


def mixed_batch(
    index, b: int, q: int, p: int, seed: int, df=None, snap=None,
) -> dict:
    """keyword_batch plus phrase slots: every 4th row holds a phrase (the
    benchmark mix's share). With `snap`, half of those are 2-3 term phrases read off a real
    document's adjacent body positions (so chains hold); the rest are 1-5
    random terms, some repeated. Rows sorted phrase-rows-first like
    the engine's fused lane."""
    rng = np.random.default_rng(seed + 7919)
    kw = keyword_batch(index, b, q, seed, df=df)
    ph_ids = np.full((b, p), index.n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    pn = np.zeros(b, np.int32)
    for k, i in enumerate(range(0, b, 4)):
        ids = _real_phrase(snap, rng) if snap is not None and k % 2 == 0 else None
        if ids is None:
            n = int(rng.integers(1, min(5, p) + 1))
            ids = rng.integers(0, index.n_words, n).astype(np.int32)
            if n > 1 and k % 3 == 0:
                ids[1] = ids[0]
        ph_ids[i, : len(ids)] = ids
        ph_valid[i, : len(ids)] = 1.0
        pn[i] = len(ids)
    perm = np.lexsort((-kw["qn"], -kw["qnb"], -pn))
    out = {k: (v[perm] if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    out.update(ph_ids=ph_ids[perm], ph_valid=ph_valid[perm], pn=pn[perm])
    return out


def _real_phrase(snap, rng) -> np.ndarray | None:
    """Word ids at 2-3 adjacent body positions of a random document."""
    csr = snap.body
    n_post = csr.n_postings
    if n_post == 0:
        return None
    d = csr.doc_ids[int(rng.integers(0, n_post))]
    mine = np.flatnonzero(csr.doc_ids[:n_post] == d)
    word_of = np.searchsorted(csr.post_offsets, mine, side="right") - 1
    at: dict[float, int] = {}
    for k, w in zip(mine.tolist(), word_of.tolist()):
        for v in csr.positions[csr.pos_offsets[k] : csr.pos_offsets[k + 1]].tolist():
            if v >= 0:
                at[v] = w
    if not at:
        return None
    p0 = sorted(at)[int(rng.integers(0, len(at)))]
    ids = [at[p0]]
    for step in range(1, int(rng.integers(2, 4))):
        if p0 + step not in at:
            break
        ids.append(at[p0 + step])
    return np.asarray(ids, np.int32)


#: the batches that stress the probe tables (adversarial_batch)
ADVERSARIAL = ("dup", "every_row", "q32", "phrase_kw", "phrase_rep", "sentinel", "b13", "b80",
               "log_full", "int_max")
#: the kinds whose batch size is their point
_FIXED_B = {"b13": 13, "b80": 80}


def adversarial_batch(index, kind: str, seed: int, df=None, snap=None, b: int = 16) -> dict:
    """A mixed batch (keyword and phrase fields, phrase rows first like
    the engine's fused lane) built to stress the probe tables; Q=4 and P=4
    unless said:
      dup         a term two or three times in a row (multiplicity);
      every_row   the most frequent term in every row, and as position 0
                  of every phrase, alone in every other one (one term,
                  many rows: long table runs, many phrase hits per doc);
      q32         Q=32, every row 32 distinct terms (the largest table);
      phrase_kw   phrase terms that are also keyword terms of their row;
      phrase_rep  repeated phrase terms ([a, a], [a, b, a], [a, a, a]);
      sentinel    all-sentinel rows, unknown-word keywords and phrase terms,
                  a phrase whose slot 0 is invalid, an invalid middle slot;
      b13         13 rows (a ragged row tile);
      b80         80 rows (two row tiles, the second ragged);
      log_full    one real 2-3 term phrase in every row: at B=16 a doc
                  holding one of its terms logs exactly the 16 phrase hits
                  K2's log keeps, one holding two overflows it and is
                  checked by a rescan (csrc/mixed.cu kLog);
      int_max     keyword columns past a row's count padded with int32 max
                  (probe.TERM_PAD) instead of the unknown-word id, and an
                  int32-max term inside the count of every 4th row: K4 and
                  a qn-less K3 read every column, and no table may hold
                  such an entry."""
    rng = np.random.default_rng(seed)
    n_words = index.n_words
    pr = None if df is None else df / df.sum()
    b = _FIXED_B.get(kind, b)
    q = 32 if kind == "q32" else 4
    p = 4
    top = int(np.argmax(df)) if df is not None else 0

    def draw(n: int) -> list[int]:
        return rng.choice(n_words, size=n, p=pr).astype(np.int32).tolist()

    shared = None
    if kind == "log_full":
        while shared is None or len(shared) < 2:
            shared = _real_phrase(snap, rng) if snap is not None else np.asarray(draw(2), np.int32)

    def phrase(k: int) -> tuple[list[int], list[float]]:
        if shared is not None:
            return shared.tolist()[:p], [1.0] * min(len(shared), p)
        ids = _real_phrase(snap, rng) if snap is not None and k % 2 == 0 else None
        ids = draw(int(rng.integers(1, 4))) if ids is None else ids.tolist()
        valid = [1.0] * len(ids)
        if kind == "every_row":  # a 1-term phrase matches wherever top occurs
            ids = [top] if k % 2 == 0 else [top] + ids[: p - 1]
            valid = [1.0] * len(ids)
        elif kind == "phrase_rep":
            a, c = ids[0], (ids[1] if len(ids) > 1 else draw(1)[0])
            ids = ([a, a], [a, c, a], [a, a, a])[k % 3]
            valid = [1.0] * len(ids)
        elif kind == "sentinel":
            if k % 4 == 1:
                ids = [n_words] + ids[1:]  # an unknown word at position 0
            elif k % 4 == 2:
                valid = [0.0] + valid[1:]  # slot 0 invalid: no phrase
            elif k % 4 == 3 and len(ids) >= 2:
                ids = [ids[0], n_words, ids[1]]
                valid = [1.0, 0.0, 1.0]  # an invalid middle slot
        return ids[:p], valid[:p]

    rows, phrases = [], []
    for i in range(b):
        ph = phrase(i // 2) if i % 2 == 0 or shared is not None else ([], [])
        n = int(rng.integers(1, q + 1))
        if kind == "dup":
            a = draw(1)[0]
            ids = [a, a] + draw(n) if i % 2 else [a] + draw(1) + [a, a]
        elif kind == "every_row":
            ids = [top] + draw(n - 1)
        elif kind == "q32":
            ids = rng.choice(n_words, size=min(q, n_words), replace=False, p=pr).tolist()
        elif kind == "phrase_kw":
            ids = ph[0] + draw(n)
        elif kind == "sentinel":
            ids = [] if i % 4 == 1 else ([n_words] + draw(n - 1) if i % 4 == 3 else draw(n))
        elif kind == "int_max":
            ids = [probe.TERM_PAD] + draw(n - 1) if i % 4 == 1 else draw(n)
        else:
            ids = draw(n)
        rows.append([int(t) for t in ids[:q]])
        phrases.append(ph)
    ph_ids = np.full((b, p), n_words, np.int32)
    ph_valid = np.zeros((b, p), np.float32)
    for i, (ids, valid) in enumerate(phrases):
        ph_ids[i, : len(ids)] = ids
        ph_valid[i, : len(valid)] = valid
    pn = (ph_valid > 0).sum(1).astype(np.int32)
    out, perm = rows_batch(index, rows, q, extra=pn)
    if kind == "int_max":
        out["term_ids"][out["term_ids"] == n_words] = probe.TERM_PAD
    out.update(ph_ids=ph_ids[perm], ph_valid=ph_valid[perm], pn=pn[perm])
    return out


def to_device(batch: dict, device) -> dict:
    return {
        k: (torch.from_numpy(np.ascontiguousarray(v)).to(device) if isinstance(v, np.ndarray) else v)
        for k, v in batch.items()
    }


def tables_agree(batch: dict, phrases: bool = False, one: str | None = None) -> bool:
    """The probe tables an entry point builds on the card equal, entry for
    entry, their plain version's (probe.cuda_tables vs probe.plain_tables)
    for a to_device() batch: K1's (or, with phrases, K2's) title and body
    tables, or with one="K3" K3's one table (columns < qn), with one="K4"
    K4's shared table (all columns)."""
    if one is not None:
        qn = batch["qn"] if one == "K3" else None
        args, kw = [batch["term_ids"], qn, None], {"sections": 1}
    else:
        args, kw = [batch["term_ids"], batch["qn"], batch["qnb"] if batch["split"] else None], {}
    if phrases:
        args += [batch["ph_ids"], batch["ph_valid"]]
    got, want = probe.cuda_tables(*args, **kw), probe.plain_tables(*args, **kw)
    return (
        got[2] == want[2] and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        and (want[3] is None or torch.equal(got[3], want[3]))
    )


def run_k1(index, batch: dict, emit_counts: bool, body_tmax: bool, plain: bool = False):
    """K1's wrapper (or its plain version) on a to_device() batch."""
    fn = k1.plain_forward_scores_2sec if plain else k1.forward_scores_2sec
    return fn(
        index.title.fwd.ftT, index.title.fwd.fwT, index.body.fwd.ftT, index.body.fwd.fwT,
        batch["term_ids"], batch["qn"], emit_counts=emit_counts,
        qnb=batch["qnb"] if batch["split"] else None,
        body_tmax=index.body.tmax_blocks if body_tmax else None,
    )


def run_k3(index, batch: dict, emit_counts: bool, section: str, plain: bool = False):
    """K3's wrapper (or its plain version) on one section of the index, on
    a to_device() batch (the full term tile, as the custom-blend route)."""
    sec = getattr(index, section).fwd
    if plain:
        s, c = k1.plain_section_scores(sec.ftT, sec.fwT, batch["term_ids"])
        return s, (c if emit_counts else None)
    return k1.forward_scores(
        sec.ftT, sec.fwT, batch["term_ids"], batch["qn"], emit_counts=emit_counts
    )


def fused_inputs(index, batch: dict, c: int, seed: int) -> tuple:
    """K4's per-query inputs for a to_device() keyword batch: query_len =
    the row's term count (>= 1) and, with c == 1, topics off (the index's
    first PageRank row, zero probabilities); with c > 1, a seeded [c, D]
    PageRank and Dirichlet topic probabilities."""
    dev = batch["term_ids"].device
    b = batch["term_ids"].shape[0]
    qlen = batch["qn"].clamp(min=1).to(torch.float32)
    if c == 1:
        return qlen, index.pagerankT[:1].contiguous(), torch.zeros((b, 1), device=dev)
    rng = np.random.default_rng(seed)
    prT = rng.uniform(0, 1e-3, (c, index.n_docs_padded)).astype(np.float32)
    tp = rng.dirichlet(np.ones(c), b).astype(np.float32)
    return qlen, torch.from_numpy(prT).to(dev), torch.from_numpy(tp).to(dev)


def run_k4(index, batch: dict, inputs: tuple, plain: bool = False):
    """K4's wrapper (or its plain version) -> final [B, D]."""
    qlen, prT, tp = inputs
    fn = k4.plain_fused_final_scores if plain else k4.fused_final_scores
    return fn(
        index.title.fwd.ftT, index.title.fwd.fwT, index.body.fwd.ftT, index.body.fwd.fwT,
        index.mag_title, index.mag_body, prT, batch["term_ids"], qlen, tp,
    )


def run_k2(index, batch: dict, emit_counts: bool, plain: bool = False,
           tmax_stage: str | None = None):
    """K2's wrapper (or its plain version) on a to_device() batch; with
    tmax_stage, the wrapper bounds those body loops by the index's
    body_tmax (the plain version needs no bound)."""
    qnb = batch["qnb"] if batch["split"] else None
    args = (
        index.title.fwd.ftT, index.title.fwd.fwT, index.body.fwd.ftT, index.body.fwd.fwT,
        index.title.posT, index.body.posT, batch["term_ids"],
    )
    if plain:
        out = k2.plain_mixed_scores(*args, batch["ph_ids"], batch["ph_valid"], qnb=qnb)
        return out if emit_counts else (out[0], None, out[2], None)
    bound = {} if tmax_stage is None else {"body_tmax": index.body.tmax_blocks,
                                            "tmax_stage": tmax_stage}
    return k2.mixed_scores_2sec(
        *args, batch["qn"], batch["ph_ids"], batch["ph_valid"], batch["pn"],
        emit_counts=emit_counts, qnb=qnb, **bound,
    )


def finalize_case(b: int, d: int, seed: int, *, hot: bool = True, counts: bool = False,
                  phrase: bool = False, c: int = 1, weights=None, device="cpu") -> dict:
    """Seeded inputs of the finalize kernel (finalize.finalize_chunked's
    arguments) at [b, d]: sparse non-negative scores (a hit in ~1 of 8
    docs), integer counts with zero-weight hits, the hot GEMM's output as a
    [b, d + 64] buffer read in place, a phrase fold as the [b, d, 3] view
    of a [b, d + 1, 3] accumulator (as scoring.phrase_fold leaves it),
    magnitudes with zeros under both zero and positive scores (0/0 -> 0,
    +inf), C topic categories, and every fifth row with no hit at all."""
    rng = np.random.default_rng(seed)

    def sparse(shape, p):
        return (rng.random(shape) < p) * rng.uniform(0.01, 2.0, shape)

    ts, bs = sparse((b, d), 0.12), sparse((b, d), 0.12)
    ts[::5] = 0.0
    bs[::5] = 0.0
    args = {"ts": ts, "bs": bs, "tc": None, "bc": None, "hot": None, "phrase": None}
    if counts:  # a count per hit, and hits of zero weight
        args["tc"] = (ts > 0) * rng.integers(1, 3, (b, d)) + (rng.random((b, d)) < 0.01)
        args["bc"] = (bs > 0) * rng.integers(1, 3, (b, d))
        args["tc"][::5] = 0
    if hot:
        args["hot"] = sparse((b, d + 64), 0.05)
    if phrase:
        acc = np.zeros((b, d + 1, 3))
        hit = rng.random((b, d)) < 0.01
        acc[:, :d, 0] = hit * rng.uniform(0.0, 1.0, (b, d))
        acc[:, :d, 1] = hit * rng.uniform(0.0, 1.0, (b, d))
        acc[:, :d, 2] = hit
        args["phrase"] = acc
    mag_t, mag_b = rng.uniform(0.5, 4.0, d), rng.uniform(0.5, 4.0, d)
    mag_t[rng.random(d) < 0.02] = 0.0
    mag_b[rng.random(d) < 0.02] = 0.0
    out = {k: None if v is None else torch.from_numpy(np.asarray(v, np.float32)).to(device)
           for k, v in args.items()}
    if phrase:
        out["phrase"] = out["phrase"][:, :d]
    out.update(
        mag_title=torch.from_numpy(mag_t.astype(np.float32)).to(device),
        mag_body=torch.from_numpy(mag_b.astype(np.float32)).to(device),
        pagerank=torch.from_numpy(rng.uniform(0, 1e-3, (d, c)).astype(np.float32)).to(device),
        query_len=torch.from_numpy(rng.integers(1, 9, b).astype(np.float32)).to(device),
        topic_probs=torch.from_numpy(
            rng.dirichlet(np.ones(c), b).astype(np.float32) if c else np.zeros((b, 0), np.float32)
        ).to(device),
    )
    if weights is not None:
        out["weights"] = weights
    return out


def run_finalize(case: dict, plain: bool = False):
    """The finalize wrapper (or its plain version) on a finalize_case()
    -> (final [B, D], cmax [B, M])."""
    fn = fin.plain_finalize_chunked if plain else fin.finalize_chunked
    a = dict(case)
    pos = [a.pop(k) for k in ("ts", "tc", "bs", "bc", "mag_title", "mag_body", "pagerank",
                              "query_len", "topic_probs")]
    if "weights" in a:
        pos.append(a.pop("weights"))
    return fn(*pos, **a)


def finalize_bound_ms(b: int, d: int, *, hot: bool = True, counts: bool = False,
                      phrase: bool = False, c: int = 1) -> float:
    """The least time of a finalize call: ts, bs, the hot GEMM's output,
    the counts and the phrase fold's three channels where present, each a
    [b, D] f32 read once; `final` [b, M*128] and cmax [b, M] written once;
    mag_title, mag_body and pagerank [D, C] read once; over 3.35 TB/s (no
    operation count: a few flops a byte)."""
    m = -(-d // fin.CHUNK)
    streams = 2 + hot + 2 * counts + 3 * phrase
    nbytes = 4 * (streams * b * d + b * m * fin.CHUNK + b * m + (2 + c) * d)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def compare_finalize(got, want, exact: bool = True) -> dict:
    """finalize outputs (final, cmax) against the plain version's: bit for
    bit (exact), or compare_final's RTOL on both where sqd sums C > 1
    categories in another order. -> {"ok", "final", "cmax", "max_abs_err"}."""
    reps = [compare_final(g, w) for g, w in zip(got, want)]
    if exact:
        same = [bool(torch.equal(g.contiguous().view(torch.int32), w.contiguous().view(torch.int32)))
                for g, w in zip(got, want)]
        return {"ok": all(same), "final": same[0], "cmax": same[1],
                "max_abs_err": reps[0]["max_abs_err"]}
    return {"ok": all(r["ok"] for r in reps), "final": reps[0], "cmax": reps[1],
            "max_abs_err": reps[0]["max_abs_err"]}


def topk_case(index, b: int, seed: int, df=None, copies: int = 20) -> tuple:
    """K5's adversarial case on a device index. Copies of the forward
    columns and magnitudes in which two new term ids are planted in a
    doc's first body slot (its weight kept): TIE in one doc whose columns
    are then copied over `copies` docs spread along the doc axis (their
    finals tie across doc tiles, more of them than a k_pad of 16: the
    k-th cut falls inside the tie), FEW in 3 other docs. A [b, 4] batch
    whose rows are: no hit (unknown words), FEW (fewer hits than k_pad),
    TIE, a duplicated term, then df-weighted rows of 1-4 terms
    (unknown-word pads). Pick b not a multiple of fused_topk.ROWS for a
    ragged row tile. -> (title_ftT, title_fwT, body_ftT, body_fwT,
    mag_title, mag_body, term_ids, query_len), on the index's device."""
    rng = np.random.default_rng(seed)
    dev = index.title.fwd.ftT.device
    n_words, n_docs = index.n_words, index.n_docs
    tie, few = n_words + 1, n_words + 2
    arrs = [index.title.fwd.ftT.clone(), index.title.fwd.fwT.clone(), index.body.fwd.ftT.clone(),
            index.body.fwd.fwT.clone(), index.mag_title.clone(), index.mag_body.clone()]
    docs = torch.nonzero(arrs[2][0, :n_docs] >= 0).flatten().cpu().numpy()
    src, *few_docs = (int(d) for d in rng.choice(docs, 4, replace=False))
    arrs[2][0, src] = tie
    targets = np.linspace(0, n_docs - 1, copies).astype(np.int64)
    targets = torch.from_numpy(targets[~np.isin(targets, [src, *few_docs])]).to(dev)
    for a in arrs[:4]:
        a[:, targets] = a[:, src : src + 1].clone()
    for a in arrs[4:]:
        a[targets] = a[src].clone()
    arrs[2][0, few_docs] = few
    p = None if df is None else df / df.sum()
    tq = np.full((b, 4), n_words, np.int32)
    for i in range(b):
        n = int(rng.integers(1, 5))
        tq[i, :n] = rng.choice(n_words, size=n, p=p)
    tq[0] = n_words
    tq[1] = [few, n_words, n_words, n_words]
    tq[2] = [tie, n_words, n_words, n_words]
    tq[3, :2] = tq[3, 0]
    qlen = (tq < n_words).sum(1).clip(min=1).astype(np.float32)
    return (*arrs, torch.from_numpy(tq).to(dev), torch.from_numpy(qlen).to(dev))


def run_k5(args: tuple, k_pad: int = 16, plain: bool = False):
    """K5's wrapper (or its plain version) -> (values, ids) [B, k_pad]."""
    fn = k5.plain_fused_topk if plain else k5.fused_topk
    return fn(*args, k_pad)


def k5_inputs(index, batch: dict) -> tuple:
    """K5's arguments for a to_device() keyword batch (all Q columns, as
    the prototype reads them; query_len = the row's term count)."""
    return (index.title.fwd.ftT, index.title.fwd.fwT, index.body.fwd.ftT, index.body.fwd.fwT,
            index.mag_title, index.mag_body, batch["term_ids"],
            batch["qn"].clamp(min=1).to(torch.float32))


def run_k6(index, batch: dict, emit_flag: bool, rows: int | None = None, plain: bool = False):
    """K6's wrapper (or its plain version) on the first `rows` rows (all
    by default) of a to_device() mixed batch."""
    sl = slice(None, rows)
    fn = k6.plain_phrase_delta if plain else k6.phrase_delta
    return fn(index.title.fwd.ftT, index.title.fwd.fwT, index.body.fwd.ftT, index.body.fwd.fwT,
              index.title.posT, index.body.posT, batch["ph_ids"][sl].contiguous(),
              batch["ph_valid"][sl].contiguous(), batch["pn"][sl].contiguous(),
              emit_flag=emit_flag)


def compare_delta(got, want) -> dict:
    """K6's (add_t, add_b, flag | None): adds within RTOL, the flag and
    the matched set exact. -> a report like compare()'s."""
    rep = compare((got[0], got[2], got[1], None if got[2] is None else torch.zeros_like(got[1])),
                  (want[0], want[2], want[1],
                   None if want[2] is None else torch.zeros_like(want[1])))
    rep["matched"] = int(((want[0] > 0) | (want[1] > 0)).sum())
    return rep


def compare(got, want) -> dict:
    """Scores within RTOL; counts and candidacy masks exact. -> a report
    with max_abs_err / max_rel_err over the score outputs and `ok`."""
    ts, tc, bs, bc = got
    ws, wc, wbs, wbc = want
    max_abs = max_rel = 0.0
    ok = True
    for g, w in ((ts, ws), (bs, wbs)):
        diff = (g - w).abs()
        max_abs = max(max_abs, float(diff.max()))
        rel = diff / w.abs().clamp_min(1e-30)
        max_rel = max(max_rel, float(torch.where(w != 0, rel, diff).max()))
        ok &= bool(torch.isclose(g, w, rtol=RTOL, atol=0.0).all())
    if tc is not None:
        ok &= bool(torch.equal(tc, wc)) and bool(torch.equal(bc, wbc))
        cand_g = (tc + bc) > 0
        cand_w = (wc + wbc) > 0
    else:
        cand_g = (ts + bs) > 0
        cand_w = (ws + wbs) > 0
    ok &= bool(torch.equal(cand_g, cand_w))
    return {
        "ok": ok, "max_abs_err": max_abs, "max_rel_err": max_rel,
        "candidates": int(cand_w.sum()),
    }


def compare_section(got, want) -> dict:
    """compare() for one section's (score, count | None)."""
    z = torch.zeros_like(want[0])
    return compare(
        (got[0], got[1], z, None if got[1] is None else z),
        (want[0], want[1], z, None if want[1] is None else z),
    )


def compare_final(got, want) -> dict:
    """Final blended scores: the -inf (non-candidate) and +inf sets exact,
    finite scores within RTOL. -> a report like compare()'s."""
    ok = bool(torch.equal(got == -float("inf"), want == -float("inf")))
    ok &= bool(torch.equal(got == float("inf"), want == float("inf")))
    fin = torch.isfinite(want)
    ok &= bool(torch.equal(torch.isfinite(got), fin))
    g, w = got[fin], want[fin]
    diff = (g - w).abs()
    max_abs = float(diff.max()) if diff.numel() else 0.0
    rel = diff / w.abs().clamp_min(1e-30)
    max_rel = float(torch.where(w != 0, rel, diff).max()) if diff.numel() else 0.0
    ok &= bool(torch.isclose(g, w, rtol=RTOL, atol=0.0).all())
    return {"ok": ok, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "candidates": int(fin.sum())}


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def row_terms(batch: dict, section: str, phrases: bool = False) -> list[set]:
    """Per row, the distinct query terms a section's sweep matches: the
    keyword columns below the row's active count (qnb for the body under
    the hot split, qn otherwise), and with `phrases` the row's valid phrase
    terms (bound_ms's rows)."""
    tq = batch["term_ids"].cpu().numpy()
    cold = batch["split"] and section == "body"
    active = (batch["qnb"] if cold else batch["qn"]).cpu().numpy()
    rows = [{int(t) for t in tq[i, : active[i]] if t >= 0} for i in range(len(tq))]
    if phrases:
        ids, valid = batch["ph_ids"].cpu().numpy(), batch["ph_valid"].cpu().numpy()
        for i, r in enumerate(rows):
            r.update(int(t) for t, v in zip(ids[i], valid[i]) if v > 0 and t >= 0)
    return rows


def bound_ms(sweeps: list, n_words: int, b: int, d: int, n_out: int,
             extra_bytes: int = 0) -> tuple[float, str]:
    """The least time the card could take for a membership call at batch b
    over D docs on this data: the larger of its bytes over the memory rate
    and its operations over the peak rate. `sweeps` holds (ftT, rows) per
    section swept, rows a set of term ids per query row. Bytes: the term
    id (4 B) of every real slot, the weight (4 B) of each slot whose term
    some row asks for, each of the n_out f32 [b, D] outputs written once,
    and extra_bytes. Operations: one membership test per real slot, one
    multiply-add (2) per (slot, row) match. -> (ms, "bytes" or
    "operations")."""
    slots = hits = pairs = 0
    for ftT, rows in sweeps:
        real = ftT[ftT >= 0].long()
        slots += real.numel()
        occ = torch.bincount(real, minlength=n_words + 1).cpu().numpy()
        hits += int(occ[sorted(set().union(*rows))].sum())
        pairs += sum(int(occ[sorted(r)].sum()) for r in rows)
    nbytes = 4 * slots + 4 * hits + n_out * b * d * 4 + extra_bytes
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * (slots + 2 * pairs) / PEAK_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def time_on(fn, device, iters: int = 20, warmup: int = 3) -> float:
    """time_ms on a CUDA device; on the CPU the mean host time of fn() in
    ms (the experiments' --device cpu runs)."""
    if torch.device(device).type == "cuda":
        return time_ms(fn, iters, warmup)
    import time

    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def probe_device(name: str):
    """The torch.device an experiment's --device names; CUDA that is not
    there exits with a message (no fallback to the CPU)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available (pass --device cpu)")
    if dev.type == "cuda":
        from ..scoring import set_exact_matmul

        set_exact_matmul()
    return dev


def compare_topk(got, want, rtol: float = RTOL, atol: float = 1e-6) -> dict:
    """[B, K] top-k (values, ids) against the reference's: the -inf slots
    exact, every other value within rtol/atol position by position, and
    the ids equal wherever a doc ranks, except where the reference's own
    value at that slot ties the got id's (a tie within the tolerance,
    ordered differently by a different summation order). -> a report with
    max_abs_err over the finite slots, id_diffs and `ok`."""
    gv, gi, wv, wi = (x.cpu() for x in (*got, *want))
    ranked = wv > -float("inf")
    ok = bool(torch.equal(gv > -float("inf"), ranked))
    ok &= bool(torch.isclose(gv, wv, rtol=rtol, atol=atol).all())
    both = torch.isfinite(gv) & torch.isfinite(wv)
    max_abs = float((gv - wv).abs()[both].max()) if bool(both.any()) else 0.0
    diff = ranked & (gi != wi)
    for b, k in diff.nonzero().tolist():
        row = (wi[b] == gi[b, k]).nonzero()
        ref = float(wv[b, row[0, 0]]) if len(row) else float(wv[b, -1])
        ok &= abs(ref - float(wv[b, k])) <= atol + rtol * abs(float(wv[b, k]))
    return {"ok": ok, "max_abs_err": max_abs, "id_diffs": int(diff.sum()),
            "ranked": int(ranked.sum())}
