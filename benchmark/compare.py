"""The comparison that decides `correct`.

For each checked query the port's top-k row (scores, doc ids) is held
against the reference's scores of every document of the shard:

- score_gap: at every rank, the gap between the port's score and the
  reference's score at that rank, relative to the latter;
- id_gap: at every rank, the gap between the reference's own score of the
  doc the port put there and the reference's score at that rank, relative
  to the latter. Docs that tie (or all but tie) may trade places; a doc
  that does not belong at its rank opens a gap.

Both are taken over the ranked (finite) positions and the maximum over
all checked queries is the number compared. A rank that one side fills
and the other leaves empty, a doc the reference does not rank at all, or
a doc given twice in one row read MISMATCH.
"""

from __future__ import annotations

import torch

from .reference import top_k

#: the reading of a structural mismatch (a number far above every limit)
MISMATCH = 1.0e30
#: scores below this are compared absolutely (a relative gap of a score
#: near 0 says nothing)
FLOOR = 1.0e-3
NUMBERS = ("score_gap", "id_gap")


def gaps(got_vals, got_ids, final: torch.Tensor) -> dict[str, float]:
    """One query: the port's (or the control's) top-k row against the
    reference's scores `final` [D]."""
    gv = torch.as_tensor(got_vals, dtype=torch.float32).to(final.device)
    gi = torch.as_tensor(got_ids).to(final.device).long()
    rv, _ = top_k(final, gv.numel())
    g_fin, r_fin = torch.isfinite(gv), torch.isfinite(rv)
    if not torch.equal(g_fin, r_fin):
        return {"score_gap": MISMATCH, "id_gap": MISMATCH}
    if not bool(r_fin.any()):
        return {"score_gap": 0.0, "id_gap": 0.0}
    rv, gv, gi = rv[r_fin], gv[r_fin], gi[r_fin]
    denom = rv.abs().clamp(min=FLOOR)
    score_gap = float(((gv - rv).abs() / denom).max())
    if bool(((gi < 0) | (gi >= final.numel())).any()) or gi.unique().numel() != gi.numel():
        return {"score_gap": score_gap, "id_gap": MISMATCH}
    at = final[gi]
    if not bool(torch.isfinite(at).all()):
        return {"score_gap": score_gap, "id_gap": MISMATCH}
    return {"score_gap": score_gap, "id_gap": float(((at - rv).abs() / denom).max())}


def worst(rows: list[dict[str, float]]) -> dict[str, float]:
    return {n: max((r[n] for r in rows), default=0.0) for n in NUMBERS}
