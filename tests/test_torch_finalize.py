"""The rank's finalize (ops/kernels/finalize.py) on the CPU: its plain
route, which CPU tensors take, against the PyTorch passes the lanes ran
before the kernel, bit for bit; exact_top_k started from the chunk maxima
against exact_top_k alone; the route counters; and every lane of the
engine through it once a batch. The kernel itself is held to the plain
route on the card (tests/test_torch_gpu.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spaghettisearch_tpu_torch.corpus import bench_queries, write_corpus
from spaghettisearch_tpu_torch.models.blended import BlendedRanker
from spaghettisearch_tpu_torch.ops import scoring
from spaghettisearch_tpu_torch.ops.kernels import check
from spaghettisearch_tpu_torch.ops.kernels import finalize as fin
from spaghettisearch_tpu_torch.retrieval import device_index as tdi
from spaghettisearch_tpu_torch.retrieval.engine import QueryEngine
from spaghettisearch_tpu_torch.utils.timing import TRACER

torch.set_num_threads(1)

#: the chunk route's threshold (exact_top_k's chunk_min_docs)
THRESHOLD = 1 << 18
CUSTOM = (0.0, 1.0, 0.0, 1.0)  # title only: w_body * +inf -> NaN where mag_body is 0


def _composition(ts, tc, bs, bc, mag_t, mag_b, pr, qlen, tp, weights=scoring.REFERENCE_BLEND,
                 hot=None, phrase=None, chunk=128):
    """The lanes' passes before the kernel: the hot fold's add (_fold_hot),
    the candidacy (_candidates / derive_mixed_counts, or the phrase flag's
    count), the phrase fold's add, finalize_scores, exact_top_k's chunk max."""
    b, d = ts.shape
    if hot is not None:
        hot = hot[:, :d]
        bs = bs + hot
        if bc is not None:
            bc = bc + (hot > 0).to(bs.dtype)
    if tc is None:
        cand = ts + bs > 0
        if phrase is not None:
            cand = cand | (phrase[:, :, 2] > 0)
        tc = cand.to(ts.dtype)
        bc = torch.zeros_like(tc)
    elif phrase is not None:
        tc = tc + phrase[:, :, 2]
    if phrase is not None:
        ts, bs = ts + phrase[:, :, 0], bs + phrase[:, :, 1]
    final = scoring.finalize_scores(ts, tc, bs, bc, mag_t, mag_b, pr, qlen, tp, weights)
    pad = (-d) % chunk
    xp = torch.nn.functional.pad(final, (0, pad), value=-float("inf")) if pad else final
    return final, xp.view(b, -1, chunk).amax(dim=2)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("weights", [None, CUSTOM], ids=["reference", "custom"])
@pytest.mark.parametrize("phrase", [False, True])
@pytest.mark.parametrize("counts", [False, True])
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("b,d", [(5, 1000), (4, 1027), (3, 4096)])
def test_plain_route_is_the_composition_bit_for_bit(b, d, hot, counts, phrase, weights, c):
    case = check.finalize_case(b, d, seed=d + 7 * c, hot=hot, counts=counts, phrase=phrase,
                               c=c, weights=weights)
    final, cmax = check.run_finalize(case)
    a = dict(case)
    pos = [a.pop(k) for k in ("ts", "tc", "bs", "bc", "mag_title", "mag_body", "pagerank",
                              "query_len", "topic_probs")]
    want = _composition(*pos, **a)
    assert final.shape == (b, d) and cmax.shape == (b, -(-d // 128))
    assert torch.equal(_bits(final), _bits(want[0])) and torch.equal(_bits(cmax), _bits(want[1]))
    if final.stride(0) != d:  # D not a multiple of 128: the pad holds -inf
        pad = final.as_strided((b, final.stride(0) - d), (final.stride(0), 1), d)
        assert bool((pad == -float("inf")).all())


def test_plain_route_special_values():
    """0/0 -> 0, a positive score over a zero magnitude -> +inf, zero
    counts -> -inf, and a title-only blend's 0 * inf -> NaN, all kept."""
    z = torch.zeros((1, 4))
    ts = torch.tensor([[0.0, 2.0, 1.0, 0.0]])
    tc = torch.tensor([[1.0, 1.0, 1.0, 0.0]])
    bs = torch.tensor([[0.0, 0.0, 3.0, 1.0]])
    mag = torch.tensor([0.0, 0.0, 2.0, 1.0])
    args = (ts, tc, bs, z, mag, torch.tensor([1.0, 1.0, 0.0, 1.0]), torch.zeros((4, 1)),
            torch.tensor([4.0]), torch.zeros((1, 1)))
    final, cmax = fin.finalize_chunked(*args)
    assert final[0, 0] == 0.0 and final[0, 1] == float("inf") and final[0, 3] == -float("inf")
    assert final[0, 2] == float("inf") and cmax[0, 0] == float("inf")
    final, cmax = fin.finalize_chunked(*args, CUSTOM)
    assert torch.isnan(final[0, 2]) and torch.isnan(cmax[0, 0])


@pytest.mark.parametrize("doc_map", [False, True])
@pytest.mark.parametrize("d", [THRESHOLD - 3, THRESHOLD + 77], ids=["small", "chunk"])
def test_exact_top_k_from_cmax_equals_without(d, doc_map):
    """Both routes, values on a coarse grid (ties across chunks and rows
    with fewer than k candidates), with and without the doc-sorted map."""
    b, k = 3, 50
    rng = np.random.default_rng(d)
    case = check.finalize_case(b, d, seed=d, hot=True)
    case["ts"] = torch.from_numpy(np.round(rng.random((b, d)) * 4).astype(np.float32)
                                  * (rng.random((b, d)) < 0.3))
    case["ts"][1, 40:] = 0.0  # row 1: few candidates
    case["bs"].zero_()
    case["hot"].zero_()
    case["mag_title"].fill_(1.0)
    final, cmax = check.run_finalize(case)
    dm = torch.from_numpy(rng.permutation(d).astype(np.int32)) if doc_map else None
    got = scoring.exact_top_k(final, k, doc_map=dm, cmax=cmax)
    want = scoring.exact_top_k(final.contiguous(), k, doc_map=dm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(torch.isneginf(got[0][1, -1]))  # the -inf tail keeps the lowest ids


def test_exact_top_k_refuses_cmax_that_does_not_fit():
    x = torch.zeros((2, THRESHOLD))
    with pytest.raises(ValueError):
        scoring.exact_top_k(x, 10, cmax=torch.zeros((2, 7)))


def _counts():
    rep = TRACER.report()
    return tuple(rep.get(f"scoring.finalize.{r}", {}).get("count", 0) for r in ("plain", "kernel"))


def test_each_call_counts_once_on_its_route():
    case = check.finalize_case(2, 300, seed=1)
    n0 = _counts()
    check.run_finalize(case)
    check.run_finalize(case)
    assert _counts() == (n0[0] + 2, n0[1])
    assert "scoring.finalize.kernel" in TRACER.report()  # /stats lists both routes


@pytest.fixture(scope="module")
def lane_db():
    return write_corpus(None, n_pages=160, n_vocab=500, seed=9, device="cpu")


@pytest.mark.parametrize("lane", ["fused", "keyword", "sparse_phrase", "csr"])
def test_every_lane_takes_the_finalize_once_a_batch(lane_db, lane, monkeypatch):
    """The engine's lanes each finalize through the wrapper, once a
    dispatched batch: the fused mixed lane and the keyword lane (reference
    blend), the sparse phrase lane (a custom blend's phrases), the CSR
    route (an index truncated by DOC_TERM_CAP)."""
    model = BlendedRanker(*CUSTOM) if lane == "sparse_phrase" else BlendedRanker()
    snap = None
    if lane == "csr":
        snap = QueryEngine(lane_db, device="cpu").snapshot
        nt = np.bincount(snap.body.doc_ids[: snap.body.n_postings], minlength=snap.n_docs)
        monkeypatch.setattr(tdi, "DOC_TERM_CAP", int(np.sort(nt)[-3]))  # two docs past it
    eng = QueryEngine(lane_db, snapshot=snap, device="cpu", model=model)
    queries = bench_queries(eng.snapshot, 24, seed=4, phrase_every=0 if lane == "keyword" else 2,
                            db=lane_db)
    rep0, n0 = TRACER.report(), _counts()
    eng.query_batch(queries)
    rep = TRACER.report()

    def grew(name):
        return rep.get(name, {}).get("count", 0) - rep0.get(name, {}).get("count", 0)

    assert grew(f"engine.lane.{lane}") >= 1
    assert _counts() == (n0[0] + grew("engine.launch"), n0[1])
