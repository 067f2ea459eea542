"""The tbound and membership_tune probes on the PyTorch port, on the CPU.

experiments/torch_tbound_probe.py runs K1 with the doc-sorted body bound
(body_tmax) on the original tbound_probe.py's synthetic layouts. The
original's own variant kernel, forward_scores_2sec_tb, has no interpret
switch, so the port's path is held against the JAX package's K1 with the
same bound, pallas_forward_scores_2sec(body_tmax=..., interpret=True)
(membership.py:142-160, 222-252: the function the prototype became), on
both of the probe's sorted layouts (balanced and sorted-only): scores
within rtol 1e-6, counts equal. experiments/torch_membership_tune.py runs
K3 at the original's body shapes; K3's plain version is held against the
JAX package's pallas_forward_scores in interpret mode on the tune's
draws. Each probe script also runs at a tiny size with --device cpu and
passes its own exactness check.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spaghettisearch_tpu.ops.kernels.membership import (
    pallas_forward_scores,
    pallas_forward_scores_2sec,
)
from spaghettisearch_tpu_torch.ops.kernels import membership as k1

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "experiments"))

import torch_membership_tune  # noqa: E402
import torch_tbound_probe  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-6


@pytest.mark.parametrize("layout", ["balanced", "sorted-only"])
def test_tbound_layouts_match_pallas_with_body_tmax(layout):
    data = torch_tbound_probe.make_data(1000)
    (perm, tmax), = [(p, t) for lab, p, t in torch_tbound_probe.sorted_layouts(data["nt"])
                     if lab == layout]
    assert tmax.shape == (2,)
    tft, tfw, bft, bfw = (np.ascontiguousarray(data[k][:, perm])
                          for k in ("tft", "tfw", "bft", "bfw"))
    tq, qn = data["term_ids"], data["qn"]
    # the JAX kernel's bounded body loop runs in 32-row chunks: pad T to 128
    pad = 128 - bft.shape[0]
    bft_j = np.concatenate([bft, np.full((pad, bft.shape[1]), -1, np.int32)])
    bfw_j = np.concatenate([bfw, np.zeros((pad, bfw.shape[1]), np.float32)])
    want = pallas_forward_scores_2sec(
        jnp.asarray(tft), jnp.asarray(tfw), jnp.asarray(bft_j), jnp.asarray(bfw_j),
        jnp.asarray(tq), jnp.asarray(qn), doc_block=512, emit_counts=True,
        body_tmax=jnp.asarray(tmax), interpret=True,
    )
    got = k1.forward_scores_2sec(
        *(torch.from_numpy(x) for x in (tft, tfw, bft, bfw, tq, qn)), emit_counts=True,
        body_tmax=torch.from_numpy(tmax),
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=0.0)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    assert (got[2] > 0).sum() > 0


def test_tbound_balance_blocks_is_a_snake_over_two_halves():
    tmax = np.array([5, 9, 7, 1, 3, 8, 2, 6], np.int32)
    order = torch_tbound_probe.balance_blocks(tmax)
    assert sorted(order.tolist()) == list(range(8))
    half = len(order) // 2
    assert abs(int(tmax[order[:half]].sum()) - int(tmax[order[half:]].sum())) <= 2


def test_torch_tbound_probe_runs_on_cpu():
    res = torch_tbound_probe.main(["1000", "--device", "cpu", "--reps", "1"])
    assert res["ok"], res
    assert set(res["layouts"]) == {"balanced", "sorted-only"}
    assert all(0.0 < r["swept_share"] < 1.0 for r in res["layouts"].values())


def test_membership_tune_plain_matches_pallas():
    """K3's plain version on the tune's draws (seed 0, every slot real,
    Q=4) against the JAX package's pallas_forward_scores in interpret
    mode, at 1,024 docs and B=16."""
    rng = np.random.default_rng(0)
    ft = rng.integers(0, 50_000, (64, 1024)).astype(np.int32)
    fw = rng.random((64, 1024)).astype(np.float32)
    tq = rng.integers(0, 50_000, (16, 4)).astype(np.int32)
    tq[3, 1] = tq[3, 0]  # a duplicated term counts twice
    tq[5, :2] = ft[:2, 7]  # and rows that hit
    want = pallas_forward_scores(jnp.asarray(ft), jnp.asarray(fw), jnp.asarray(tq),
                                 doc_block=512, b_block=8, interpret=True)
    got = k1.forward_scores(torch.from_numpy(ft), torch.from_numpy(fw), torch.from_numpy(tq))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=0.0)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() > 0


def test_torch_membership_tune_runs_on_cpu():
    res = torch_membership_tune.main(["--device", "cpu", "--docs", "1024", "--batch", "16",
                                      "--reps", "1"])
    assert res["ok"], res
    assert res["checks"]["K3"]["ok"] and res["checks"]["torch.sparse.mm"]["ok"]
