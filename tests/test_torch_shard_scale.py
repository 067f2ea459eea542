"""The shard-scale probe of experiments/ on the PyTorch port, on the CPU.

slice_snapshot (the doc range shard 0 of a contiguous doc-sharded mesh
serves) against the JAX package's on the same benchmark corpus, every
field; the probe's run() at --device cpu on that corpus (each slice
engine's kw-128 top-50 equal to its plain path, every output key); and
the projection's arithmetic against the original's formula
(experiments/shard_scale_probe.py:90-95), written out here.
"""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

import torch_shard_scale_probe as probe  # noqa: E402
from test_torch_bucket_snapshot import assert_same_snapshot  # noqa: E402

torch.set_num_threads(1)

#: 3,000 pages: 8 shards slice 512 docs, 4 shards 1,024
PAGES = 3000
KEYS = ("local_docs", "kw128_ms", "merged128_ms", "mixed16_ms", "device_cycle_ms",
        "device_ceiling_qps", "pipeline_projected_qps")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's benchmark corpus of PAGES pages, built on the CPU under a
    temporary BENCH_DIR that the probe's main() reuses. -> its root."""
    from spaghettisearch_tpu_torch import bench

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_DIR", str(tmp_path_factory.mktemp("bench")))
        yield bench.ensure_bench_corpus(PAGES, device="cpu")


@pytest.mark.parametrize("n_keep", [512, 1024, 700])
def test_slice_snapshot_matches_jax(corpus, n_keep):
    from spaghettisearch_tpu.index.persist import load_snapshot as jax_load_snapshot
    from spaghettisearch_tpu.index.snapshot import slice_snapshot as jax_slice_snapshot
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.index.snapshot import slice_snapshot

    path = os.path.join(corpus, "snapshot")
    got = slice_snapshot(load_snapshot(path), n_keep)
    want = jax_slice_snapshot(jax_load_snapshot(path), n_keep)
    assert got.n_docs == n_keep
    assert_same_snapshot(got, want)


def test_probe_runs_on_cpu(corpus, tmp_path):
    serve1m = {"metric": "serve_http_qps_1000k_docs_full_contract", "mean_batch": 122.13,
               "spans_ms": {"dispatch": 70.356, "assemble": 22.357, "fetch": 30.003},
               "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
    path = tmp_path / "serve1m.json"
    path.write_text(json.dumps(serve1m))
    res = probe.main([str(PAGES), "--device", "cpu", "--reps", "1", "--serve1m", str(path)])
    assert res["ok"], res
    assert res["host_stages"]["dispatch_ms"] == 70.356 and res["cross_card_ms"] == "not measured"
    for n_shards, local in ((8, 512), (4, 1024)):
        r = res[f"shards{n_shards}"]
        assert set(KEYS) <= set(r) and r["local_docs"] == local
        assert r["kw128_vs_plain"]["ok"] and r["kw128_vs_plain"]["ranked"] > 0
        assert r["pipeline_projected_qps"] is not None and r["merge_ms"] > 0
        assert r["cross_card_bytes_per_batch"]["pieces_to_first_card"] == \
            (n_shards - 1) * 128 * 50 * 8
        assert r["launches"] == {"K1": 0, "K2": 0, "K2_tmax": 0}


def test_projection_is_the_original_formula():
    """shard_scale_probe.py:90-95 with the constants replaced by inputs."""
    kw, merged, merge = 9.75, 14.5, 0.031
    serve1m = {"spans_ms": {"dispatch": 70.356, "assemble": 22.357}, "mean_batch": 122.13}
    got = probe.projection(kw, merged, merge, serve1m)
    device_ms = (7 * kw + merged) / 8 + merge
    ceiling = 128e3 / device_ms
    cycle = max(device_ms, 22.357, 70.356)
    projected = 122.13 * 1e3 / cycle
    assert got == pytest.approx({"device_cycle_ms": device_ms, "device_ceiling_qps": ceiling,
                                 "pipeline_projected_qps": projected}, rel=1e-12)
    # the device is the slowest stage once it outlasts both host spans
    slow = probe.projection(90.0, 120.0, 1.0, serve1m)
    assert slow["pipeline_projected_qps"] == pytest.approx(
        122.13 * 1e3 / ((7 * 90.0 + 120.0) / 8 + 1.0), rel=1e-12)
    assert probe.projection(kw, merged, merge, None)["pipeline_projected_qps"] is None


def test_shard_rows_are_the_mesh_layout():
    assert probe.shard_rows(1_000_000, 8) == 125_440
    assert probe.shard_rows(1_000_000, 4) == 250_368
    assert probe.shard_rows(3000, 8) == 512
