"""The roofline probe of experiments/ on the PyTorch port, on the CPU.

The bytes it counts per program, read from the port's DeviceIndex
(section_bytes, the ftT + fwT stream of a section, and dyn_t_factor, the
swept share of body T under the doc-sorted bound), against the JAX
original's functions (experiments/roofline.py) on the JAX package's
DeviceIndex of the same snapshot, for both layouts; and the probe's main()
at --device cpu on a small corpus (its keys, each program's top-k equal
to the plain path).
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")
sys.path.insert(0, EXPERIMENTS)

import roofline as jax_roofline  # noqa: E402
import torch_roofline  # noqa: E402

torch.set_num_threads(1)

PAGES = 2000


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The port's benchmark corpus of PAGES pages under a temporary
    BENCH_DIR that the probe's main() reuses. -> its root."""
    from spaghettisearch_tpu_torch import bench

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_DIR", str(tmp_path_factory.mktemp("bench")))
        yield bench.ensure_bench_corpus(PAGES, device="cpu")


@pytest.mark.parametrize("doc_sort", [True, False])
def test_bytes_match_jax(corpus, doc_sort):
    from spaghettisearch_tpu.index.persist import load_snapshot as jax_load_snapshot
    from spaghettisearch_tpu.retrieval.device_index import DeviceIndex as JaxDeviceIndex
    from spaghettisearch_tpu_torch.index.persist import load_snapshot
    from spaghettisearch_tpu_torch.retrieval.device_index import DeviceIndex

    path = os.path.join(corpus, "snapshot")
    got = DeviceIndex.from_snapshot(load_snapshot(path), "cpu", doc_sort=doc_sort)
    want = JaxDeviceIndex.from_snapshot(jax_load_snapshot(path), doc_sort=doc_sort)
    f = torch_roofline.dyn_t_factor(got)
    assert f == jax_roofline.dyn_t_factor(want)
    assert (f < 1.0) == doc_sort
    for sec in ("title", "body"):
        for dyn in (1.0, f):
            assert torch_roofline.section_bytes(getattr(got, sec), dyn) == \
                jax_roofline.section_bytes(getattr(want, sec), dyn), (sec, dyn)
    for name in ("pagerankT", "mag_title", "mag_body", "hot_body_w"):
        assert torch_roofline.nbytes(getattr(got, name)) == getattr(want, name).nbytes, name
    for sec in ("title", "body"):
        assert torch_roofline.nbytes(getattr(got, sec).posT) == getattr(want, sec).posT.nbytes


def test_roofline_runs_on_cpu(corpus):
    res = torch_roofline.main(["--device", "cpu", "--pages", str(PAGES), "--pages1m", str(PAGES),
                               "--peak-mib", "8", "--reps", "1"])
    assert res["ok"], res
    assert res["stream_peak_GBps"] > 0 and res["peak_mib"] == 8
    for key, kernel, b in (("headline_kw", "K1", 256), ("mixed_1m", "K2", 128)):
        r = res[key]
        assert r["batch"] == b and r["vs_plain"]["ok"] and r["vs_plain"]["ranked"] > 0
        assert r["kernel_bound"]["kernel"] == kernel and r["kernel_bound"]["bound_ms"] > 0
        assert r["bytes_per_batch_GB"] * 1e9 == pytest.approx(sum(r["bytes_split"].values()),
                                                              rel=1e-6)
        assert set(r) >= {"ms_per_batch", "achieved_GBps", "pct_of_stream_peak",
                          "pct_of_published"}
    assert {"posT_body", "posT_title"} <= set(res["mixed_1m"]["bytes_split"])


def test_roofline_skips(corpus):
    res = torch_roofline.main(["--device", "cpu", "--pages", str(PAGES), "--skip-1m",
                               "--peak-mib", "8", "--reps", "1"])
    assert res["ok"] and "headline_kw" in res and "mixed_1m" not in res
