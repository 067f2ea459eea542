"""Doc-sharded serving: a QueryEngine whose ranking runs on the sharded
index (parallel/sharded.py) instead of the single-device DeviceIndex (the
counterpart of spaghettisearch_tpu/retrieval/sharded_engine.py).

Everything host-side (parsing, hydration, summaries, wordlist) is
inherited; only `rank` changes: the batch is scored per shard with a local
top-k, and the pieces are merged on the mesh's first device. Phrase sets are
per row.

Request consistency: everything a query touches (snapshot, sharded index,
scorers) is bundled into ONE atomically swapped `_live` tuple, so a
/refresh concurrent with a query never mixes the new index with the old
snapshot's doc-id space. Scorers are reused across refreshes while the
padded geometry is unchanged (scorer_meta).

The shards go on `devices` when given; else on the CPU for device="cpu",
every one on card N for device="cuda:N", and one per visible card for
device="cuda" (which needs n_shards * n_query_rows cards). Serve this way
with `cli.server --meshShards N` (and `--meshBatch Q` for a 2-D
query-rows x docs mesh).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import MAX_RESULTS
from ..parallel.mesh import make_mesh, make_mesh2d
from ..parallel.sharded import (
    ShardedIndex,
    index_args,
    make_sharded_mixed_scorer,
    make_sharded_scorer,
    scorer_meta,
)
from ..utils.timing import TRACER
from .engine import (
    B_SMALL,
    P_LEVELS,
    Q_BASE,
    Q_CATCHALL,
    SEGREGATE_MIN_DOCS,
    WARM_B_MAX,
    ParsedQuery,
    QueryEngine,
    _b_bucket,
    _MultiRankHandle,
    _RankHandle,
    parse_query,
)

#: sharded phrase-term buckets: P_BASE batched (common), one catch-all
_P_SHARD_MAX = P_LEVELS[-1]


class _ShardedRankHandle(_RankHandle):
    """A dispatched sharded batch rank: the single-device handle's pinned,
    non-blocking copy to the host and its un-permute and slice, then pad
    doc slots (ids >= n_docs, which only carry -inf scores) masked for
    hydration."""

    __slots__ = ("_n_docs",)

    def __init__(self, scores, ids, b_real: int, n_docs: int, inv) -> None:
        super().__init__(scores, ids, inv, b_real)
        self._n_docs = n_docs

    def finish(self) -> tuple[np.ndarray, np.ndarray]:
        scores, ids = super().finish()
        pad = ids >= self._n_docs
        return np.where(pad, -np.inf, scores), np.where(pad, 0, ids)


class _ShardedLive:
    """Everything a request resolves through, swapped atomically as one
    object: snapshot-level facts for generic engine/server code plus the
    sharded index and its scorers."""

    def __init__(self, snap, sidx: ShardedIndex, scorers: dict) -> None:
        self.n_docs = snap.n_docs
        self.n_words = snap.n_words
        self.n_categories = max(
            snap.pagerank.shape[1] if snap.pagerank is not None else 1, 1
        )
        self.sidx = sidx
        self.scorers = scorers  # topk (or ("mixed", topk)) -> run(sidx, ...)


def _index_sig(sidx: ShardedIndex) -> tuple:
    """scorer_meta plus every index array's (shape, dtype): what tells two
    geometries apart in prepare_refresh."""
    arrs = index_args(
        sidx,
        mixed=bool(sidx.pos_dense),
        hot=sidx.hot_body_w is not None,
        doc_sorted=sidx.doc_perm is not None,
    )
    return (scorer_meta(sidx),) + tuple(
        (tuple(a.shape), str(a.dtype)) for shard in arrs for a in shard
    )


@dataclass
class ShardedQueryEngine(QueryEngine):
    n_shards: int = 1
    n_query_rows: int = 1  # >1: 2-D mesh, query batch data-parallel
    devices: list | None = None  # the mesh's devices (see the module docstring)

    def __post_init__(self) -> None:
        # no single-device DeviceIndex: the postings live once, in the
        # ShardedIndex
        from ..index.snapshot import build_snapshot
        from ..models.bm25 import BM25Ranker
        from ..ops.scoring import set_exact_matmul

        if self.devices is None and self.device is None:
            raise ValueError(
                "ShardedQueryEngine needs an explicit device ('cuda', 'cuda:N' or 'cpu') "
                "or devices"
            )
        set_exact_matmul()
        if self.snapshot is None:
            self.snapshot = build_snapshot(self.db)
        devices = self.devices
        if devices is None:
            device = torch.device(self.device)
            if device.type == "cpu" or device.index is not None:
                devices = [device] * (self.n_shards * self.n_query_rows)
        if self.n_query_rows > 1:
            self._mesh = make_mesh2d(self.n_query_rows, self.n_shards, devices=devices)
        else:
            self._mesh = make_mesh(self.n_shards, devices=devices)
        self.device = self._mesh.devices.flat[0]
        self._bm25 = isinstance(self.model, BM25Ranker)
        # scorers survive refresh while the padded geometry is unchanged:
        # keyed by (meta, topk), the index passed per call
        self._scorer_cache: dict[tuple, object] = {}
        self._live = (self.snapshot, self._build_sharded(self.snapshot))
        self.snapshot, self.index = self._live

    def _build_sharded(self, snapshot) -> _ShardedLive:
        sidx = ShardedIndex.from_snapshot(
            snapshot, self._mesh, weights="bm25" if self._bm25 else "tfidf",
            doc_sort=self.doc_sort,
        )
        return _ShardedLive(snapshot, sidx, {})

    def prepare_refresh(self, warm: bool = True):
        """Off-lock rebuild: fresh store view + snapshot + sharded index
        (scorers reused from the geometry-keyed cache). With warm=True and
        a changed geometry, the new shapes run once here, off-lock; the
        hydration records and the wordlist are prewarmed."""
        import copy

        from ..index.snapshot import build_snapshot
        from ..store.tables import Database

        new_db = None
        db = self.db
        if self.db.root is not None:
            for t in self.db.tables.values():
                t.flush_bulk()
                if hasattr(t._kv, "flush"):
                    t._kv.flush()
            new_db = Database(self.db.root, backend=self.db.backend_kind)
            db = new_db
        snapshot = build_snapshot(db)
        facts = self._build_sharded(snapshot)
        if warm:
            ghost = copy.copy(self)
            ghost.db = db
            ghost._live = (snapshot, facts)
            ghost.snapshot, ghost.index = snapshot, facts
            if _index_sig(facts.sidx) != _index_sig(self._live[1].sidx):
                ghost.warmup()
            ghost.prewarm_hydration()
            ghost.prewarm_wordlist()
        return (new_db, snapshot, facts)

    def commit_refresh(self, state):
        """O(pointer) swap; returns the superseded Database for the caller
        to close OFF the serving lock (see QueryEngine.commit_refresh)."""
        new_db, snapshot, facts = state
        old_db = self.db if new_db is not None else None
        if new_db is not None:
            self.db = new_db
        self._live = (snapshot, facts)
        self.snapshot, self.index = snapshot, facts
        return old_db

    def refresh(self) -> None:
        old_db = self.commit_refresh(self.prepare_refresh(warm=False))
        if old_db is not None:
            old_db.close()

    def _scorer(self, facts: _ShardedLive, topk: int):
        s = facts.scorers.get(topk)
        if s is None:
            key = (scorer_meta(facts.sidx), topk)
            s = self._scorer_cache.get(key)
            if s is None:
                kwargs = {}
                if self._bm25:
                    kwargs = dict(
                        scoring="bm25",
                        title_boost=self.model.title_boost,
                        body_boost=self.model.body_boost,
                    )
                s = make_sharded_scorer(key[0], topk=topk, **kwargs)
                self._scorer_cache[key] = s
            facts.scorers[topk] = s
        return s

    def _mixed_scorer(self, facts: _ShardedLive, topk: int):
        key_local = ("mixed", topk)
        s = facts.scorers.get(key_local)
        if s is None:
            key = ("mixed", scorer_meta(facts.sidx), topk)
            s = self._scorer_cache.get(key)
            if s is None:
                s = make_sharded_mixed_scorer(key[1], topk=topk)
                self._scorer_cache[key] = s
            facts.scorers[key_local] = s
        return s

    def _use_mixed(self, sidx, parsed: list[ParsedQuery]) -> bool:
        """The single-device fused-lane routing (BlendedRanker.supports_mixed):
        reference blend + position planes; BM25 and truncated dense rows
        keep the sparse lane."""
        return (
            any(p.phrase_hashes for p in parsed)
            and not self._bm25
            and sidx.pos_dense
            and not sidx.dense_truncated
        )

    def class_batching_pays(self, live=None) -> bool:
        """QueryEngine.class_batching_pays for the mesh (the inherited one
        reads DeviceIndex attributes this engine never builds): the same
        keyword/mixed split, so the same conditions."""
        if live is None:
            live = self._live
        snap, facts = live
        sidx = facts.sidx
        return (
            not self._bm25
            and sidx.pos_dense
            and not sidx.dense_truncated
            and snap.n_docs >= SEGREGATE_MIN_DOCS
        )

    def rank(
        self, parsed: list[ParsedQuery], topk: int = MAX_RESULTS, live=None
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.rank_async(parsed, topk, live).finish()

    def rank_async(
        self, parsed: list[ParsedQuery], topk: int = MAX_RESULTS, live=None
    ):
        """Dispatch a batch rank on the mesh and return at once; finish()
        on the returned handle waits for the copy of the results."""
        if live is None:
            live = self._live
        snap, facts = live
        sidx = facts.sidx
        b_real = len(parsed)
        if b_real > WARM_B_MAX:
            return _MultiRankHandle([
                self.rank_async(parsed[i : i + WARM_B_MAX], topk, live)
                for i in range(0, b_real, WARM_B_MAX)
            ])
        # batch bucket {B_SMALL, WARM_B_MAX}, rounded up to the query rows
        b = max(_b_bucket(b_real), self.n_query_rows, 1)
        if self._use_mixed(sidx, parsed):
            return self._rank_fused(parsed, topk, live, b)
        q_real = max((len(p.keyword_hashes) for p in parsed), default=1)
        p_real = max((len(p.phrase_hashes) for p in parsed), default=0)
        n_ph = sum(1 for p in parsed if p.phrase_hashes)
        # any rare axis collapses onto the single catch-all shape
        rare = q_real > Q_BASE or p_real > Q_BASE
        if rare:
            q = Q_CATCHALL
            p_max = _P_SHARD_MAX
            b = max(b, WARM_B_MAX)
        else:
            q = Q_BASE
            p_max = Q_BASE
        # phrase sets ride a COMPRESSED axis (bp rows) + a batch-row map, so
        # the matcher's temporaries scale with the phrase queries, not the
        # batch; bp is 1 or b
        bp = 1 if n_ph <= 1 and not rare else b
        if q_real > Q_CATCHALL:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "query has %d keyword terms; scoring the first %d",
                q_real, Q_CATCHALL,
            )
        if p_real > p_max:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "phrase has %d terms; matching the first %d", p_real, p_max
            )

        hot_map = self._hot_map(self.model, sidx)
        term_ids, qlen, qn, qnb, hot_sids = self._fill_keyword_rows(
            parsed, b, q, snap, hot_map
        )
        ph_ids = np.full((bp, p_max), snap.n_words, dtype=np.int32)
        ph_valid = np.zeros((bp, p_max), dtype=bool)
        gens = np.zeros(bp, dtype=np.int32)
        ph_rows = np.full(bp, b, dtype=np.int32)  # pad rows drop in the fold
        ph_i = 0
        for i, p in enumerate(parsed):
            if p.phrase_hashes:
                row = snap.term_ids(p.phrase_hashes)[:p_max]
                ph_ids[ph_i, : len(row)] = row
                ph_valid[ph_i, : len(row)] = True
                t_df = snap.title.df(row)
                b_df = snap.body.df(row)
                gens[ph_i] = int(np.argmin(t_df + b_df))
                ph_rows[ph_i] = i
                ph_i += 1
        topic_probs = self._topic_probs(parsed, b, snap, facts)

        # sort by descending (cold-bounded) term count, as the single-device
        # engine does; the phrase-row map follows the sort
        perm = np.lexsort((-qn, -qnb))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(b)
        term_ids, qlen, qn, qnb = term_ids[perm], qlen[perm], qn[perm], qnb[perm]
        hot_sids = hot_sids[perm]
        topic_probs = topic_probs[perm]
        ph_rows = np.where(ph_rows < b, inv[np.minimum(ph_rows, b - 1)], b)

        with TRACER.span("rank.sharded"):
            scores, ids = self._scorer(facts, topk)(
                sidx, term_ids, qlen, topic_probs, ph_ids, ph_valid, gens,
                ph_rows, qn, qnb, hot_sids,
            )
            return _ShardedRankHandle(scores, ids, b_real, snap.n_docs, inv)

    def _rank_fused(
        self, parsed: list[ParsedQuery], topk: int, live, b: int
    ) -> _ShardedRankHandle:
        """The fused mixed lane on the mesh (cf. QueryEngine._pack_fused):
        per shard one K2 pass scores keywords and matches phrases per batch
        ROW; one phrase width, P_LEVELS[-1]."""
        snap, facts = live
        sidx = facts.sidx
        q_real = max((len(p.keyword_hashes) for p in parsed), default=1)
        if q_real <= Q_BASE:
            q = Q_BASE
        else:
            q = Q_CATCHALL
            b = max(b, WARM_B_MAX)
            if q_real > Q_CATCHALL:
                import logging

                logging.getLogger("spaghettisearch.engine").warning(
                    "query has %d keyword terms; scoring the first %d",
                    q_real, Q_CATCHALL,
                )
        p_lvl = _P_SHARD_MAX
        p_real = max((len(p.phrase_hashes) for p in parsed), default=0)
        if p_real > p_lvl:
            import logging

            logging.getLogger("spaghettisearch.engine").warning(
                "phrase has %d terms; matching the first %d", p_real, p_lvl
            )

        hot_map = self._hot_map(self.model, sidx)
        term_ids, qlen, qn, qnb, hot_sids = self._fill_keyword_rows(
            parsed, b, q, snap, hot_map
        )
        ph_ids = np.full((b, p_lvl), snap.n_words, dtype=np.int32)
        ph_valid = np.zeros((b, p_lvl), dtype=np.float32)
        pn = np.zeros(b, dtype=np.int32)
        for i, pq in enumerate(parsed):
            pids = snap.term_ids(pq.phrase_hashes)[:p_lvl]
            ph_ids[i, : len(pids)] = pids
            ph_valid[i, : len(pids)] = 1.0
            pn[i] = len(pids)
        topic_probs = self._topic_probs(parsed, b, snap, facts)

        # phrase rows first (descending pn), then cold-term count, then
        # total keywords, as the single-device engine sorts
        perm = np.lexsort((-qn, -qnb, -pn))
        inv = np.empty_like(perm)
        inv[perm] = np.arange(b)
        term_ids, qlen, qn, pn = term_ids[perm], qlen[perm], qn[perm], pn[perm]
        qnb, hot_sids = qnb[perm], hot_sids[perm]
        ph_ids, ph_valid = ph_ids[perm], ph_valid[perm]
        topic_probs = topic_probs[perm]

        with TRACER.span("rank.sharded"):
            scores, ids = self._mixed_scorer(facts, topk)(
                sidx, term_ids, qlen, topic_probs, ph_ids, ph_valid, qn, pn,
                qnb, hot_sids,
            )
            return _ShardedRankHandle(scores, ids, len(parsed), snap.n_docs, inv)

    def warmup(self, max_batch: int = WARM_B_MAX) -> None:
        """Run every shape family a live batch can reach once (cf.
        QueryEngine.warmup), so the first request pays no kernel build or
        load: per batch bucket the keyword step and, with the fused mixed
        lane, one mixed batch, else the single-phrase (bp=1) and
        all-phrase (bp=b) matcher batches; plus the keyword and phrase
        catch-alls (q=Q_CATCHALL)."""
        if self.index.n_docs == 0:
            return
        kw = parse_query("warmup")
        ph = parse_query('"warm up"')
        mixed = self._use_mixed(self.index.sidx, [ph])
        rare_kw = ParsedQuery(
            raw="", stripped="", phrases=[],
            keyword_hashes=["0" * 32] * (Q_BASE + 1),
            phrase_hashes=[],
        )
        rare = ParsedQuery(
            raw="", stripped="", phrases=["w"],
            keyword_hashes=["0" * 32] * (Q_BASE + 1),
            phrase_hashes=["0" * 32] * (Q_BASE + 1),
        )
        for b in sorted({max(B_SMALL, self.n_query_rows, 1),
                         max(max_batch, self.n_query_rows, 1)}):
            self.rank([kw] * b, topk=MAX_RESULTS)
            self.rank([ph] + [kw] * (b - 1), topk=MAX_RESULTS)
            if b > 1 and not mixed:
                self.rank([ph] * b, topk=MAX_RESULTS)
        self.rank([rare], topk=MAX_RESULTS)
        self.rank([rare_kw], topk=MAX_RESULTS)
