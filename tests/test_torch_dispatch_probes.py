"""The host/device dispatch probes of experiments/ on the PyTorch port, and
the results ladder's serve1m_projected stage, on the CPU.

Each probe runs its main() with --device cpu at a tiny size (the
benchmark corpus of PAGES pages, built once for the file under a
temporary build directory) and must give its keys and pass its own
equality check: torch_bw_probe.py (the matmul exact, a B=1024 batch's
first rows equal the B=256 batch), torch_h2d_probe.py (the four ways of
getting a batch's arrays to the device give the same sums; the engine's
uploads per batch), torch_fetch_async_probe.py (the fetched arrays equal
across the four fetch patterns), torch_scorer_split_probe.py and
torch_headline_chain_probe.py (each timing's top-k equal to the queued
one's) and torch_kw_gap_probe.py (the hand-composed keyword program
against the engine's: ids equal, scores within rtol 1e-6). Then
bench.emit_results with a built 1M corpus (every stage stubbed): the
serve1m_projected stage runs after serve1m_routes and is handed the
serve1m stage's result.
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

import torch_bw_probe  # noqa: E402
import torch_fetch_async_probe  # noqa: E402
import torch_h2d_probe  # noqa: E402
import torch_headline_chain_probe  # noqa: E402
import torch_kw_gap_probe  # noqa: E402
import torch_scorer_split_probe  # noqa: E402

torch.set_num_threads(1)

PAGES = 1000


@pytest.fixture(scope="module")
def corpus_args(tmp_path_factory):
    """The port's benchmark corpus of PAGES pages under a temporary
    BENCH_DIR that the probes' main() then reuse."""
    from spaghettisearch_tpu_torch import bench

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench, "BENCH_DIR", str(tmp_path_factory.mktemp("bench")))
        bench.ensure_bench_corpus(PAGES, device="cpu")
        yield ["--device", "cpu", "--reps", "1"]


def test_bw_probe_runs_on_cpu():
    res = torch_bw_probe.main(["--device", "cpu", "--docs", "2000", "--words", "1000",
                               "--mib", "1", "--mm", "64", "--reps", "1"])
    assert res["ok"] and res["matmul_exact"] and res["rows_equal"], res
    assert {"matmul TFLOP/s", "score_fwd B=256 qps", "score_fwd B=1024 qps"} <= set(res["rates"])
    assert len(res["ms"]) == 5 and res["launches"]["K1"] == 0


def test_h2d_probe_runs_on_cpu(corpus_args):
    res = torch_h2d_probe.main([str(PAGES), *corpus_args, "--calls", "4", "--heavy", "32"])
    assert res["ok"], res
    assert all(len(ways) == 4 for ways in res["ms"].values()) and len(res["ms"]) == 2
    up = res["engine_uploads"]
    assert up["keyword B=128"]["uploads"] in (4, 6) and up["mixed B=128"]["uploads"] in (7, 9)
    assert up["mixed B=128"]["bytes"] > up["keyword B=128"]["bytes"] > 0


def test_fetch_async_probe_runs_on_cpu():
    res = torch_fetch_async_probe.main(["--device", "cpu", "--reps", "2", "--n", "32",
                                        "--iters", "2", "--batches", "3"])
    assert res["ok"], res
    assert {"A fetch", "A whole", "B fetch", "B whole", "C per batch", "D per batch"} == \
        set(res["ms"])
    assert len(res["ms"]["A fetch"]) == 2 and len(res["ms"]["D per batch"]) == 3


def test_scorer_split_probe_runs_on_cpu(corpus_args):
    res = torch_scorer_split_probe.main(["--pages", str(PAGES), *corpus_args, "--batches", "2"])
    assert res["ok"], res
    assert set(res["ms"]) == {"mixed full (K2+finalize+topk)", "keyword full"}
    for name, ms in res["ms"].items():
        assert set(ms) == {"queued", "serial", "dispatch_only", "device_only", "graph"}
        assert ms["device_only"] is None and ms["graph"] is None  # a card's timings
        assert res["equal"][name] == {"serial": True}


def test_headline_chain_probe_runs_on_cpu(corpus_args):
    res = torch_headline_chain_probe.main(["--pages", str(PAGES), *corpus_args,
                                           "--batches", "2"])
    assert res["ok"], res
    assert res["batch"] == 256 and res["topk"] == 10 and res["equal"] == {"serial": True}
    assert res["qps"]["queued"] > 0 and res["graph_error"] is None


def test_kw_gap_probe_runs_on_cpu(corpus_args):
    res = torch_kw_gap_probe.main([str(PAGES), *corpus_args])
    assert res["ok"] and res["ids_equal"] and res["scores_close"], res
    assert set(res["ms"]) == {"engine", "hand_composed"} and res["hot_split"]


def test_kw_gap_check_catches_a_different_program(corpus_args, monkeypatch):
    """The check compares: a hand-composed program without the hot fold
    (hot_w None) no longer agrees with the engine."""
    composed = torch_kw_gap_probe.hand_composed
    monkeypatch.setattr(torch_kw_gap_probe, "hand_composed",
                        lambda *a, **k: composed(*a[:5], None, *a[6:], **k))
    res = torch_kw_gap_probe.main([str(PAGES), *corpus_args])
    assert not res["ok"] and not res["scores_close"]


def test_results_ladder_projects_serve1m(tmp_path, monkeypatch):
    from spaghettisearch_tpu_torch import bench

    (tmp_path / "corpus1000k").mkdir()
    (tmp_path / "corpus1000k" / "BUILT.json").write_text("{}")
    monkeypatch.setattr(bench, "corpus_root", lambda n: str(tmp_path / f"corpus{n // 1000}k"))
    monkeypatch.setattr(bench, "BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.setattr(bench, "host_calibration", lambda: {"metric": "host_single_core_score"})
    serve1m = {"metric": "serve_http_qps_1000k_docs_full_contract", "value": 1919.3,
               "mean_batch": 122.13, "spans_ms": {"dispatch": 70.356, "assemble": 22.357}}

    def stub(mode):
        def fn(args, device):
            if mode == "serve1m" and not args.routeMix:
                return dict(serve1m)
            return {"metric": mode, "routeMix": args.routeMix}
        return fn

    monkeypatch.setattr(bench, "MODES", {m: (stub(m), inp) for m, (_, inp) in bench.MODES.items()})
    monkeypatch.setattr(bench, "_fresh", lambda mode, device: lambda: {"metric": mode})
    seen = {}

    def probe(cmd, timeout_s):
        seen["cmd"] = cmd
        with open(cmd[cmd.index("--serve1m") + 1], encoding="utf-8") as f:
            seen["serve1m"] = json.load(f)
        return {"shards8": {"pipeline_projected_qps": 1500.0}, "shards4": {}, "ok": True}

    monkeypatch.setattr(bench, "_run_script", probe)
    out = tmp_path / "results.json"
    bench.emit_results(str(out), "cpu")
    res = json.loads(out.read_text())
    stages = [k for k, v in res.items() if isinstance(v, dict) and "seconds" in v]
    assert stages.index("serve1m_projected") == stages.index("serve1m_routes") + 1
    assert stages.index("serve1m") < stages.index("serve1m_routes")
    assert os.path.basename(seen["cmd"][1]) == "torch_shard_scale_probe.py"
    assert seen["cmd"][2] == "1000000"
    assert seen["serve1m"]["spans_ms"] == serve1m["spans_ms"]
    assert seen["serve1m"]["mean_batch"] == serve1m["mean_batch"]
    r = res["serve1m_projected"]
    assert r["metric"] == "serve1m_projected_1card_slices_qps" and r["unit"] == "qps"
    assert r["value"] == 1500.0 and r["vs_baseline"] == 0.75 and "error" not in r
    assert "not measured" in r["method"]


def test_serve1m_projected_needs_a_serve1m_result():
    from spaghettisearch_tpu_torch import bench

    with pytest.raises(RuntimeError, match="no serve1m result"):
        bench.serve1m_projected({"error": "RuntimeError: the server did not come up"}, "cpu")
