"""Retrieval quality evaluation: recall@k and rank-order agreement.

BASELINE.json defines the north star as QPS *at recall@10 parity*; this
module provides the parity measurement between two rankers (e.g. the device
engine vs the reference-semantics oracle, or sharded vs single-chip).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ParityReport:
    queries: int
    recall_at_k: float
    exact_order: float  # fraction of queries with identical ranking order
    score_max_rel_err: float

    def to_json(self) -> dict:
        return {
            "queries": self.queries,
            "recall_at_k": round(self.recall_at_k, 6),
            "exact_order": round(self.exact_order, 6),
            "score_max_rel_err": self.score_max_rel_err,
        }


def recall_at_k(got: list[str], want: list[str], k: int) -> float:
    """|top-k(got) ∩ top-k(want)| / min(k, |want|)."""
    want_k = set(want[:k])
    if not want_k:
        return 1.0
    return len(set(got[:k]) & want_k) / len(want_k)


def compare_rankings(
    results_a: list[list[tuple[str, float]]],
    results_b: list[list[tuple[str, float]]],
    k: int = 10,
) -> ParityReport:
    """results_*: per query, [(doc_key, score)] sorted by rank."""
    assert len(results_a) == len(results_b)
    recalls, exact, max_err = [], 0, 0.0
    for a, b in zip(results_a, results_b):
        recalls.append(recall_at_k([d for d, _ in a], [d for d, _ in b], k))
        if [d for d, _ in a[:k]] == [d for d, _ in b[:k]]:
            exact += 1
        bmap = dict(b)
        for doc, score in a[:k]:
            if doc in bmap and bmap[doc] != 0:
                max_err = max(max_err, abs(score - bmap[doc]) / abs(bmap[doc]))
    n = len(results_a)
    return ParityReport(
        queries=n,
        recall_at_k=sum(recalls) / max(n, 1),
        exact_order=exact / max(n, 1),
        score_max_rel_err=max_err,
    )
