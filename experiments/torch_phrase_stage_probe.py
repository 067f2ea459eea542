#!/usr/bin/env python3
"""phrase_stage_probe.py on the PyTorch port: the sparse phrase lane's
forward matcher (ops/phrase.py match_phrase_fwd_batch) split by stage.

    python3 experiments/torch_phrase_stage_probe.py [--pages 100000] [--device cuda] [--reps 10]

The corpus is the benchmark corpus of --pages pages (the original's, 100k;
built under build/bench/corpus{n//1000}k when missing). The original's
batch: bp=8 phrases of up to P=4 terms, the first 8 phrase queries of
bench_queries(snap, 512, seed=5, phrase_every=8), each row's generator its
rarest term (title + body df), posting_cap the index's. Stages, each a
program of torch ops written here (probes, not kernels), each cut short
after its stage and reduced to one value that is fetched, so every stage's
work is done: the candidates (the generator's title and body posting
windows, gathered and sorted), the candidates' forward-row gathers (ft and
fj of both sections), the membership compares, the title's position fetch
through the scalar CSR (pos_offsets, positions) and through pos_mat's row
gather; then the whole matcher with and without pos_mat. Timed by CUDA
events (host clock with --device cpu). The exactness check: the matcher
with pos_mat and without it return the same matches (doc ids, weights
and flags equal). Prints the original's lines, then one JSON line; main()
returns the same dict (chip_smoke.py phase 17 calls run()).
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_probe_util as util  # noqa: E402


def run(snap, db, eng, reps: int = 10, say=print) -> dict:
    import torch

    from spaghettisearch_tpu_torch.ops.kernels import check
    from spaghettisearch_tpu_torch.ops.phrase import match_phrase_fwd_batch

    idx = eng.index
    dev = idx.device
    parsed = [p for p in util.parsed_queries(snap, db, 512, 8, seed=5) if p.phrase_hashes]
    say(f"pos_cap {idx.pos_cap} posting_cap {idx.posting_cap} pos_mat "
        f"{idx.title.pos_mat is not None}/{idx.body.pos_mat is not None}")
    bp, p = 8, 4
    ids = np.full((bp, p), snap.n_words, np.int32)
    valid = np.zeros((bp, p), bool)
    gens = np.zeros(bp, np.int32)
    for i, pq in enumerate(parsed[:bp]):
        row = snap.term_ids(pq.phrase_hashes)[:p]
        ids[i, : len(row)] = row
        valid[i, : len(row)] = True
        gens[i] = int(np.argmin(snap.title.df(row) + snap.body.df(row)))
    ids_t, valid_t, gens_t = (util.tensor(a, dev) for a in (ids, valid, gens))
    cap = idx.posting_cap
    t, b = idx.title, idx.body
    tf, bf = t.fwd_device(), b.fwd_device()
    d_pad = tf.ft.shape[0]
    imax = torch.iinfo(torch.int32).max

    def windows(offsets, doc_ids, tid):  # [bp] -> [bp, cap], int32-max pad
        start = offsets[tid.long()].long()
        end = offsets[tid.long() + 1].long()
        w = start[:, None] + torch.arange(cap, device=dev)
        v = w < end[:, None]
        w = torch.where(v, w, doc_ids.shape[0] - 1)
        return torch.where(v, doc_ids[w], imax)

    def stage_cand():
        gen = torch.gather(ids_t, 1, gens_t.long()[:, None])[:, 0]
        return torch.sort(torch.cat([windows(t.offsets, t.doc_ids, gen),
                                     windows(b.offsets, b.doc_ids, gen)], 1), 1).values

    cand = stage_cand()
    cr = torch.clamp(cand, max=d_pad - 1).long()

    def stage_rows():
        return (tf.ft[cr].sum() + tf.fj[cr].sum() + bf.ft[cr].sum() + bf.fj[cr].sum()).item()

    def member(ft, fj):  # [bp, E, T] against [bp, P]: found and the posting index
        ftc, fjc = ft[cr], fj[cr]
        eq = ftc[:, None, :, :] == ids_t[:, :, None, None]  # [bp, P, E, T]
        found = eq.any(-1)
        j = torch.where(eq, fjc[:, None], 0).amax(-1)
        return found, j

    def stage_member():
        acc = 0
        for ft, fj in ((tf.ft, tf.fj), (bf.ft, bf.fj)):
            found, j = member(ft, fj)
            acc = acc + found.sum() + j.sum()
        return acc.item()

    def stage_pos_scalar():
        found, j = member(tf.ft, tf.fj)
        poff, pos = t.pos_offsets, t.positions
        j = torch.where(found, j, poff.shape[0] - 2).long()
        ps = poff[j].long()
        pe = torch.where(found, poff[j + 1].long(), ps)
        pidx = ps[..., None] + torch.arange(idx.pos_cap, device=dev)
        pv = pidx < pe[..., None]
        pidx = torch.where(pv, pidx, pos.shape[0] - 1)
        return torch.where(pv, pos[pidx], float("inf")).sum().item()

    def stage_pos_mat():
        found, j = member(tf.ft, tf.fj)
        jm = torch.where(found, j, t.pos_mat.shape[0] - 1).long()
        return t.pos_mat[jm].sum().item()

    t_w, b_w = eng._phrase_weights(idx)

    def full(pm: bool):
        return match_phrase_fwd_batch(
            tf.ft, tf.fj, t_w, t.pos_offsets, t.positions, bf.ft, bf.fj, b_w, b.pos_offsets,
            b.positions, t.offsets, t.doc_ids, b.offsets, b.doc_ids, ids_t, valid_t, gens_t,
            t.pos_mat if pm else None, b.pos_mat if pm else None,
            posting_cap=cap, pos_cap=idx.pos_cap, n_docs=idx.match_pad,
        )

    ms = {}
    for label, fn in (
        (f"candidates (gather+sort 2x{cap})", lambda: stage_cand()[:, :1].sum().item()),
        ("row gathers [E,T] x4", stage_rows),
        ("+ membership compares", stage_member),
        ("title member + scalar pos gather", stage_pos_scalar),
        *((("title member + pos_mat row gather", stage_pos_mat),) if t.pos_mat is not None
          else ()),
    ):
        ms[label] = check.time_on(fn, dev, iters=reps, warmup=1)
        say(f"{label:35s}: {ms[label]:10.4f} ms")
    outs = {}
    for pm in (False, True) if t.pos_mat is not None else (False,):
        label = f"full matcher bp={bp} cap={cap} pos_mat={pm}"
        ms[label] = check.time_on(lambda pm=pm: full(pm), dev, iters=reps, warmup=1)
        outs[pm] = full(pm)
        say(f"{label}: {ms[label]:10.4f} ms")
    matched = int((outs[False][0] < idx.match_pad).sum())
    ok = True
    if True in outs:
        ok = all(torch.equal(a, c) for a, c in zip(outs[False], outs[True]))
        say(f"matcher with pos_mat == without: {ok} ({matched} matches)")
    return {"probe": "phrase_stage", "docs": idx.n_docs, "bp": bp, "posting_cap": cap,
            "pos_mat": t.pos_mat is not None, "ms": ms, "matches": matched, "ok": ok,
            **util.card(dev)}


def main(argv=None) -> dict:
    return util.main_with(run, __doc__, argv, n_default=100_000, positional=False, reps=10)


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
