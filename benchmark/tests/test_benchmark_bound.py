"""The kernels' least-time count (roofline.py) against a count by hand,
and its hot split against the port's."""

from __future__ import annotations

import numpy as np

from bench_util import tiny_cell
from benchmark import collection, roofline, traffic


def test_bound_against_a_count_by_hand():
    cell = tiny_cell("lucene-mixed")
    coll = collection.generate(cell["config_data"], 12, "cpu", snapshot=False)
    s = traffic.make_stream(cell["traffic_data"], coll, 128, 12)
    hot = roofline.hot_ranks(coll)
    title, body = roofline.batch_rows(s.kw, s.ph, hot)
    got, by = roofline.membership_bound_s(coll, title, body, 128)

    slots = sum(len(set(r[r >= 0].tolist())) for sec in (coll.title, coll.body) for r in sec.tok)
    docs_with = {}
    for name, sec in (("title", coll.title), ("body", coll.body)):
        for d, r in enumerate(sec.tok):
            for w in set(r[r >= 0].tolist()):
                docs_with.setdefault((name, w), set()).add(d)
    occ = lambda name, w: len(docs_with.get((name, w), ()))
    hits = pairs = 0
    for name, rows in (("title", title), ("body", body)):
        hits += sum(occ(name, w) for w in set().union(*rows))
        pairs += sum(occ(name, w) for r in rows for w in r)
    nbytes = 4 * slots + 4 * hits + 2 * 128 * coll.n_docs * 4
    want = max(nbytes / 3.35e12, (slots + 2 * pairs) / 67e12)
    assert by in ("bytes", "operations")
    assert abs(got - want) <= 1e-12 * want
    # the body rows leave out the hot keywords, the title rows keep them
    for k, p, t, b in zip(s.kw, s.ph, title, body):
        assert t == set(k.tolist()) | set(p.tolist())
        assert b == {x for x in k.tolist() if x not in hot} | set(p.tolist())


def test_hot_split_is_the_ports():
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    cell = tiny_cell("nq-questions")
    coll = collection.generate(cell["config_data"], 13, "cpu")
    idx = DeviceIndex.from_snapshot(coll.snapshot, "cpu")
    hot = roofline.hot_ranks(coll)
    assert len(hot) == len(idx.hot_body_map) > 0
    assert {int(coll.word_id[r]) for r in hot} == set(idx.hot_body_map)


def test_plane_bytes_against_a_count_by_hand():
    """K2's position planes: C x 2 B for each (doc, phrase term) where the
    doc holds all of some phrase's terms in the section, once a batch."""
    cell = tiny_cell("lucene-mixed")
    coll = collection.generate(cell["config_data"], 15, "cpu", snapshot=False)
    s = traffic.make_stream(cell["traffic_data"], coll, 128, 15)
    rows = [p for p in s.ph if len(p)]
    assert rows
    want = 0
    for sec in (coll.title, coll.body):
        held = [set(r[r >= 0].tolist()) for r in sec.tok]
        c = max(int(np.bincount(r[r >= 0]).max()) for r in sec.tok if (r >= 0).any())
        assert c == sec.max_tf
        need = set()
        for p in rows:
            terms = set(p.tolist())
            need |= {(d, t) for d, h in enumerate(held) if terms <= h for t in terms}
        want += 2 * c * len(need)
    planes = roofline.PhrasePlanes(coll, "cpu")
    assert planes.batch_bytes(s.ph) == want > 0
    hot = roofline.hot_ranks(coll)
    title, body = roofline.batch_rows(s.kw, s.ph, hot)
    base = roofline.membership_bound_s(coll, title, body, 128)[0]
    more = roofline.membership_bound_s(coll, title, body, 128, plane_bytes=want)[0]
    assert more >= base + want / roofline.PEAKS["hbm_bytes_per_s"] - 1e-15
