"""Topic probability model: P(topic | query) for topic-sensitive PageRank.

Multinomial naive-Bayes over the ODP topic term-frequency table, equivalent
to the reference's computeTopicProbs (reference:
retrieval/main_retrieve.go:106-159). The reference ships with this model
*disabled* (call sites commented out at main_retrieve.go:40-41,87-88), and
its accumulator starts at 0 and is only multiplied (main_retrieve.go:142-145)
so it would yield all-zero probabilities even if enabled. We reproduce the
disabled-by-default behavior; `fixed=True` starts the product at 1.0, making
the model actually usable (a documented improvement, off by default).
"""

from __future__ import annotations

from ..store.tables import Database


def compute_topic_probs(
    db: Database, query_word_hashes: list[str], fixed: bool = False
) -> dict[str, float]:
    metadata = dict(db.topic_meta.items())
    if not metadata:
        return {}

    topic_tf: dict[str, list[float]] = {}
    for wh in query_word_hashes:
        topic_freq = db.inv_topic.get(wh) or {}
        for topic, freq in topic_freq.items():
            topic_tf.setdefault(topic, []).append(float(freq))

    probs: dict[str, float] = {}
    for topic, meta in metadata.items():
        tfs = topic_tf.get(topic)
        if tfs:
            word_count = float(meta.get("wordCount", 0.0)) or 1.0
            p = 1.0 if fixed else 0.0  # reference quirk: product seeded at 0
            for tf in tfs:
                p *= tf / word_count
            probs[topic] = p / float(len(metadata))
        else:
            probs[topic] = 0.0
    return probs
