"""The yardstick of the kernels: the card's peaks and each call's least time.

`membership_bound_s` is a frozen copy of the count of the port's
`ops/kernels/check.bound_ms` (the one its smoke reports): for a membership
sweep over both sections of the forward index at batch b over D docs,

- bytes: 4 per real slot (a doc's distinct term), 4 per slot whose term
  some row of the batch asks for in that section, and each f32 [b, D]
  output written once;
- operations: one membership test per real slot and a multiply-add (2)
  per (slot, row) match;

over the published peaks below. It is computed from the generated
collection's document frequencies and the batch's own terms. K2 (the
fused mixed lane) also needs, for its chain check, the position planes of
every doc that holds all of a phrase's terms in a section: C planes x 2 B
(int16) for each of those terms' slots, C the section's most tokens of one
word in one doc (`plane_bytes`); each (doc, term) once a batch. The rows
follow the port's routing of a batch: the title sweep asks for every
keyword and phrase term, the body sweep for every phrase term and the
keywords outside the hot split (the HOT_TERMS highest-df body words, which
a dense matmul scores instead). D is the real doc count, not the port's
padded one, so the count is a least time. If the port changes what a
kernel must read, correct this count in a benchmark change.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM, dense rates at 700 W (data sheet): HBM3 bytes/s and the
#: non-tensor-core 32-bit rate, as check.bound_ms takes them
PEAKS = {"hbm_bytes_per_s": 3.35e12, "ops_per_s": 67e12}

#: the port's hot split of the body section (retrieval/device_index.py
#: HOT_H_MAX and HOT_W_BUDGET_BYTES)
HOT_TERMS = 512
HOT_BUDGET_BYTES = 2 << 30
DOC_BLOCK = 512


def hot_ranks(coll) -> set[int]:
    """The ranks the port's hot split takes out of the body sweep: the
    highest body-df words, ties by word id, as many as the budget holds."""
    df = coll.body.df
    ranks = np.flatnonzero(coll.word_id >= 0)
    d_pad = -(-coll.n_docs // DOC_BLOCK) * DOC_BLOCK
    h = min(HOT_TERMS, HOT_BUDGET_BYTES // (d_pad * 4), ranks.size)
    if h >= 128:
        h = (h // 128) * 128
    if h < 8:
        return set()
    by_id = ranks[np.argsort(coll.word_id[ranks], kind="stable")]
    top = by_id[np.argsort(-df[by_id], kind="stable")[:h]]
    return {int(r) for r in top if df[r] > 0}


def batch_rows(kw: list, ph: list, hot: set[int]) -> tuple[list[set], list[set]]:
    """Per query row, the distinct terms the title and the body sweep ask
    for."""
    title, body = [], []
    for k, p in zip(kw, ph):
        k, p = {int(x) for x in k}, {int(x) for x in p}
        title.append(k | p)
        body.append({x for x in k if x not in hot} | p)
    return title, body


class PhrasePlanes:
    """The position-plane bytes a batch's phrase rows need
    (`batch_bytes`), from each section's tokens: per rank, the docs that
    hold it, on `device`."""

    def __init__(self, coll, device):
        import torch

        self.n_docs, self.device = coll.n_docs, torch.device(device)
        self.sections = []
        for sec in (coll.title, coll.body):
            t = torch.from_numpy(np.ascontiguousarray(sec.tok)).to(self.device)
            real = t >= 0
            doc = torch.arange(coll.n_docs, device=self.device)[:, None].expand_as(t)[real]
            key = torch.unique(t[real].long() * coll.n_docs + doc)
            del t, real, doc
            off = torch.zeros(coll.vocab_size + 1, dtype=torch.int64)
            off[1:] = torch.cumsum(torch.bincount(key // coll.n_docs,
                                                  minlength=coll.vocab_size).cpu(), 0)
            self.sections.append((key % coll.n_docs, off.numpy(), int(sec.max_tf)))

    def batch_bytes(self, ph_rows) -> int:
        import torch

        rows = [sorted({int(x) for x in p}) for p in ph_rows if len(p)]
        total = 0
        for docs, off, c in self.sections:
            need = {}
            for r in rows:
                cand = torch.ones(self.n_docs, dtype=torch.bool, device=self.device)
                for t in r:
                    held = torch.zeros_like(cand)
                    held[docs[int(off[t]): int(off[t + 1])]] = True
                    cand &= held
                for t in r:
                    need[t] = cand if t not in need else need[t] | cand
            if need:
                total += 2 * c * int(torch.stack(list(need.values())).sum())
        return total


def membership_bound_s(coll, title_rows: list[set], body_rows: list[set], b: int,
                       n_out: int = 2, plane_bytes: int = 0) -> tuple[float, str]:
    """Least seconds of one membership call, with `plane_bytes` of position
    planes for K2 -> (seconds, "bytes" or "operations")."""
    slots = coll.title.n_postings + coll.body.n_postings
    hits = pairs = 0
    for df, rows in ((coll.title.df, title_rows), (coll.body.df, body_rows)):
        asked = set().union(*rows) if rows else set()
        hits += int(sum(int(df[t]) for t in asked))
        pairs += sum(int(df[t]) for r in rows for t in r)
    nbytes = 4 * slots + 4 * hits + n_out * b * coll.n_docs * 4 + plane_bytes
    by_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    by_ops = (slots + 2 * pairs) / PEAKS["ops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_roofline_pct(run, kernel: str, phrase_lane: bool) -> float | None:
    """A membership kernel's share of its least time over the traced
    window, in %: the summed bounds of the batches its lane served (keyword
    batches for K1, batches holding a phrase for the fused lane's K2) over
    the kernel's summed device time. None where it did not run; None, with
    a note, where its launches do not pair one to one with those batches."""
    import sys

    from benchmark import devtrace

    if run.events is None:
        return None
    launches, seconds = devtrace.kernel(run.events, kernel)
    lane = [b for b in run.batches if b.has_phrase == phrase_lane]
    if launches == 0 or seconds <= 0:
        return None
    if launches != len(lane):
        print(f"{kernel}: {launches} launches for {len(lane)} batches of its lane; "
              "no roofline share", file=sys.stderr)
        return None
    import torch

    hot = hot_ranks(run.coll)
    planes = None
    if phrase_lane:
        planes = PhrasePlanes(run.coll, "cuda" if torch.cuda.is_available() else "cpu")
    bound = 0.0
    for b in lane:
        sl = slice(b.i0, b.i0 + b.n)
        title, body = batch_rows(run.kw[sl], run.ph[sl], hot)
        extra = 0 if planes is None else planes.batch_bytes(run.ph[sl])
        bound += membership_bound_s(run.coll, title, body, b.n, plane_bytes=extra)[0]
    return 100.0 * bound / seconds
